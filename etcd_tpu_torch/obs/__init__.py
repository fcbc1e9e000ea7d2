"""Observability for the port: roofline accounting (``roofline.py``:
FLOPs per WAL entry, the card's published ceilings, a measured matmul
ceiling and the MFU fields derived from one rate), the metrics
registry with the whole catalog (``metrics.py``), its Prometheus text
exposition for ``GET /metrics`` (``exporter.py``), the flight recorder
(``flight.py``) and the device/host transfer ledger
(``devledger.py``)."""
