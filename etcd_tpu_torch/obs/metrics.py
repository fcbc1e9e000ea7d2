"""A small typed metrics registry: the port's copy of the part of
``etcd_tpu/obs/metrics.py`` that its WAL, replay lanes, router, device
ledger and failpoints record into, under the same metric names.

Three instrument kinds, every family declared in :data:`CATALOG` with
its labels: a typo'd name or label set raises at first record, never
makes a silent new family.

- **Counter**: monotone float add (``inc``).
- **Gauge**: last-write-wins level (``set``/``inc``).
- **Histogram**: count, sum and max of the observed values.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass


@dataclass(frozen=True)
class MetricDef:
    """One registered metric family."""

    name: str
    kind: str                    # "counter" | "gauge" | "histogram"
    help: str
    labels: tuple[str, ...] = ()


_DEFS = (
    MetricDef("etcd_wal_fsync_seconds", "histogram",
              "WAL flush+fsync latency per sync()."),
    MetricDef("etcd_wal_append_entries_total", "counter",
              "WAL entry records appended via save()."),
    MetricDef("etcd_wal_cuts_total", "counter", "WAL segment cuts."),
    MetricDef("etcd_wal_segments_gc_total", "counter",
              "WAL segment files deleted behind the durable snapshot "
              "index."),
    MetricDef("etcd_devledger_dispatches_total", "counter",
              "Device dispatches crossing a seam, per stage.",
              labels=("stage",)),
    MetricDef("etcd_devledger_dispatch_seconds_total", "counter",
              "Wall seconds inside dispatch seams, per stage.",
              labels=("stage",)),
    MetricDef("etcd_devledger_block_seconds_total", "counter",
              "Wall seconds blocked on device results, per stage.",
              labels=("stage",)),
    MetricDef("etcd_devledger_h2d_bytes_total", "counter",
              "Host->device bytes shipped per stage.", labels=("stage",)),
    MetricDef("etcd_devledger_d2h_bytes_total", "counter",
              "Device->host bytes fetched per stage.", labels=("stage",)),
    MetricDef("etcd_replay_backend_route", "gauge",
              "Replay backend chosen per decision stage: 1 for the "
              "selected route (host | device | stream), 0 for the others.",
              labels=("stage", "route")),
    MetricDef("etcd_replay_probe_bytes_per_sec", "gauge",
              "Backend-policy probe throughput per pipeline leg; 0 = leg "
              "unavailable or probe failed.", labels=("leg",)),
    MetricDef("etcd_replay_stream_chunk_bytes", "gauge",
              "Chunk size the streaming replay pipeline is configured "
              "with."),
    MetricDef("etcd_replay_stream_chunk_seconds", "histogram",
              "Per-chunk wall time of each streaming-replay stage "
              "(scan | h2d | verify).", labels=("stage",)),
    MetricDef("etcd_fault_injected_total", "counter",
              "Fault-injection activations by failpoint and action.",
              labels=("point", "action")),
)

#: name -> MetricDef: the metric vocabulary
CATALOG: dict[str, MetricDef] = {d.name: d for d in _DEFS}


class Counter:
    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n

    def get(self) -> float:
        with self._lock:
            return self.value


class Gauge(Counter):
    __slots__ = ()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)


class Histogram:
    __slots__ = ("_lock", "count", "sum", "max")

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self.sum = 0.0
        self.max = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.max = max(self.max, v)


class Registry:
    """Catalog-checked accessors."""

    def __init__(self):
        self._catalog = CATALOG
        self._lock = threading.Lock()
        self._children: dict[tuple[str, tuple[str, ...]], object] = {}

    def _child(self, name: str, kind: str, labels: dict):
        d = self._catalog.get(name)
        if d is None:
            raise KeyError(f"metric {name!r} is not in the catalog")
        if d.kind != kind:
            raise TypeError(f"metric {name!r} is a {d.kind}, not a {kind}")
        if tuple(sorted(labels)) != tuple(sorted(d.labels)):
            raise TypeError(f"metric {name!r} takes labels {d.labels}, "
                            f"got {tuple(sorted(labels))}")
        key = (name, tuple(str(labels[k]) for k in d.labels))
        with self._lock:
            c = self._children.get(key)
            if c is None:
                c = {"counter": Counter, "gauge": Gauge,
                     "histogram": Histogram}[kind]()
                self._children[key] = c
            return c

    def counter(self, name: str, **labels) -> Counter:
        return self._child(name, "counter", labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._child(name, "gauge", labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._child(name, "histogram", labels)


#: the process-wide default registry
registry = Registry()

__all__ = ["CATALOG", "Counter", "Gauge", "Histogram", "MetricDef",
           "Registry", "registry"]
