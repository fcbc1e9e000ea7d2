"""Observability for the port: roofline accounting (``roofline.py``:
FLOPs per WAL entry, the card's published ceilings, a measured matmul
ceiling and the MFU fields derived from one rate), the metrics
registry with the whole catalog (``metrics.py``), its Prometheus text
exposition for ``GET /metrics`` (``exporter.py``), the flight recorder
(``flight.py``), the device/host transfer ledger (``devledger.py``),
and the cluster plane: the windowed-delta ring (``timeseries.py``), the
SLO burn rates over it (``slo.py``), the cross-role merge of the role
supervisor (``aggregate.py``) and the always-on sampling profiler
(``profiler.py``, whose ownership domains are ``owners.py``)."""
