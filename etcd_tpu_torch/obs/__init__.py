"""Observability for the port: roofline accounting (``roofline.py``:
FLOPs per WAL entry, the card's published ceilings, a measured matmul
ceiling and the MFU fields derived from one rate), a small metrics
registry (``metrics.py``) and the device/host transfer ledger
(``devledger.py``)."""
