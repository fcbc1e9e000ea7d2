"""A small typed metrics registry: the port's copy of the part of
``etcd_tpu/obs/metrics.py`` that its WAL, replay lanes, router, device
ledger, failpoints, store, tracer and co-hosted server record into,
under the same metric names.

Three instrument kinds, every family declared in :data:`CATALOG` with
its labels: a typo'd name or label set raises at first record, never
makes a silent new family.

- **Counter**: monotone float add (``inc``).
- **Gauge**: last-write-wins level (``set``/``inc``).
- **Histogram**: count, sum and max of the observed values, plus a
  bounded ring of the last ``window`` samples, over which the tracer
  computes its exact percentiles (``ring_stats``).
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass


@dataclass(frozen=True)
class MetricDef:
    """One registered metric family."""

    name: str
    kind: str                    # "counter" | "gauge" | "histogram"
    help: str
    labels: tuple[str, ...] = ()
    window: int = 1024           # histogram ring size (exact pctls)


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
    MetricDef("etcd_devledger_fetches_total", "counter",
              "Device->host reads (host syncs) per stage.",
              labels=("stage",)),
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
    MetricDef("etcd_span_seconds", "histogram",
              "Host span latency by span name (the /v2/stats/spans "
              "source).", labels=("span",), window=256),
    MetricDef("etcd_stage_seconds", "histogram",
              "Per-stage attribution of the serving loop: one sample "
              "per pass, by kind (wall | cpu | device).",
              labels=("stage", "kind"), window=512),
    MetricDef("etcd_trace_spans_total", "counter",
              "Stage passes recorded by the stage() facade, per stage.",
              labels=("stage",)),
    MetricDef("etcd_apply_seconds", "histogram",
              "Apply-loop latency per absorbed commit batch."),
    MetricDef("etcd_apply_batch_entries", "histogram",
              "Entries applied per apply-loop batch."),
    MetricDef("etcd_election_campaigns_total", "counter",
              "Per-group election campaign lanes fired."),
    MetricDef("etcd_election_wins_total", "counter",
              "Per-group election lanes won."),
    MetricDef("etcd_read_serve_total", "counter",
              "Read serves by path (cohosted | serializable | quorum) "
              "and outcome.", labels=("path", "outcome")),
    MetricDef("etcd_nospace_active", "gauge",
              "1 while this server is in read-only NOSPACE mode, else "
              "0."),
    MetricDef("etcd_backoff_retries_total", "counter",
              "Jittered-exponential backoff waits taken, by site.",
              labels=("site",)),
    MetricDef("etcd_ttl_expire_batch_size", "histogram",
              "Keys expired per bulk TTL sweep.", window=2048),
    MetricDef("etcd_watchers_active", "gauge",
              "Live registered watchers across this process's stores."),
    MetricDef("etcd_watch_delivered_total", "counter",
              "Watch events delivered to watcher queues / mux sinks by "
              "the fanout engine."),
    MetricDef("etcd_watch_evictions_total", "counter",
              "Slow watchers evicted, by reason (overflow | stall).",
              labels=("reason",)),
    MetricDef("etcd_watch_dispatch_seconds", "histogram",
              "Fanout engine wall time per dispatch round, by stage "
              "(match | deliver).", labels=("stage",), window=2048),
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
    __slots__ = ("_lock", "count", "sum", "max", "_ring")

    def __init__(self, window: int = 1024):
        self._lock = threading.Lock()
        self.count = 0
        self.sum = 0.0
        self.max = 0.0
        self._ring: deque[float] = deque(maxlen=window)

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.max = max(self.max, v)
            self._ring.append(v)

    def ring_stats(self) -> tuple[int, float, float, list[float]]:
        """(count, sum, max, sorted ring) in one consistent read."""
        with self._lock:
            return self.count, self.sum, self.max, sorted(self._ring)


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
                c = Histogram(d.window) if kind == "histogram" else \
                    {"counter": Counter, "gauge": Gauge}[kind]()
                self._children[key] = c
            return c

    def children(self, name: str) -> list[tuple[tuple[str, ...], object]]:
        """``(label values, instrument)`` of every child of family
        ``name``, sorted by label values."""
        with self._lock:
            return sorted((k[1], c) for k, c in self._children.items()
                          if k[0] == name)

    def clear(self, name: str) -> None:
        """Drop every child of family ``name``."""
        with self._lock:
            for k in [k for k in self._children if k[0] == name]:
                del self._children[k]

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
