"""A small typed metrics registry: the port's copy of the part of
``etcd_tpu/obs/metrics.py`` that its WAL, replay lanes, router, device
ledger, failpoints, store, tracer, co-hosted server and distributed
tier record into, under the same metric names.

Three instrument kinds, every family declared in :data:`CATALOG` with
its labels: a typo'd name or label set raises at first record, never
makes a silent new family.

- **Counter**: monotone float add (``inc``).
- **Gauge**: last-write-wins level (``set``/``inc``).
- **Histogram**: count, sum and max of the observed values, plus a
  bounded ring of the last ``window`` samples, over which the tracer
  computes its exact percentiles (``ring_stats``).

:meth:`Registry.snapshot` is the JSON view ``/mraft/obs`` serves: the
reference's shape, with exact ring percentiles and no bucket counts
(this registry keeps none).
"""

from __future__ import annotations

import json
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
    # the distributed tier: peer frames, the append pipeline, reads,
    # streamed snapshots, the flight recorder
    MetricDef("etcd_ack_rtt_seconds", "histogram",
              "Dist-tier consensus RTT per proposal: leader append/send "
              "-> quorum ack -> local apply.  Stamped at SEND, so client "
              "queueing cannot pollute it (the majority-RTT model of "
              "optimal-cluster-size.md).", window=4096),
    MetricDef("etcd_dist_coalesce_entries", "histogram",
              "Client proposals coalesced per drain flush (adaptive "
              "cadence: max-entries/max-bytes threshold or the "
              "--dist-coalesce-us timer, whichever first)."),
    MetricDef("etcd_dist_frame_resend_total", "counter",
              "Pipeline frames re-sent or acks dropped, by reason: "
              "reconnect (transport died with frames in flight), reject "
              "(follower gap -> probe catch-up), stale_seq (duplicate or "
              "already-failed ack), stale_epoch (ack from a previous "
              "leadership reign), closed (channel shutdown), expired "
              "(in-flight past the ack deadline — backstop sweep).",
              labels=("reason",)),
    MetricDef("etcd_dist_pipeline_inflight", "gauge",
              "Append frames currently in flight to each peer (windowed "
              "pipeline, bounded by --dist-pipeline-depth).",
              labels=("peer",)),
    MetricDef('etcd_dist_pipeline_inflight_entries', 'gauge',
              "Entries (across all group lanes) in each peer's in-flight "
              'append window — the multi-group frame-fusion evidence: '
              'entries-per-frame is this over '
              'etcd_dist_pipeline_inflight.',
              labels=('peer',)),
    MetricDef("etcd_flight_events_total", "counter",
              "Flight-recorder events recorded, by event class: span "
              "(per-proposal trace span), frame (peerlink "
              "send/recv/resp/ack edge of a traced frame), election, "
              "pipe_mode (REPLICATE/PROBE/SNAPSHOT transition), "
              "lease_loss, read_fail (fail-closed read), snap_install, "
              "tail (slow/failed proposal or read captured past head "
              "sampling).",
              labels=("class",)),
    MetricDef("etcd_peer_send_failures_total", "counter",
              "Peer frames dropped after retries.",
              labels=("path",)),
    MetricDef("etcd_peer_send_frames_total", "counter",
              "Peer frames POSTed (path: classic one-group sender | dist "
              "batched [G] frames).",
              labels=("path",)),
    MetricDef("etcd_peer_send_seconds", "histogram",
              "Peer POST round-trip latency.",
              labels=("path",)),
    MetricDef("etcd_pending_proposals", "gauge",
              "Requeued proposals awaiting a leader or window space."),
    MetricDef("etcd_read_index_batch_size", "histogram",
              "Pending linearizable reads released per confirmation "
              "sweep.", window=2048),
    MetricDef("etcd_read_rtt_seconds", "histogram",
              "Linearizable read round trip, stamped register -> serve "
              "(lease serves land in the first buckets; ReadIndex serves "
              "pay the piggybacked confirmation round).", window=4096),
    MetricDef("etcd_snap_install_total", "counter",
              "Snapshot install/pull attempts by outcome: ok (installed) "
              "| no_donor (no reachable donor host) | meta_failed (meta "
              "fetch/parse error) | not_dominating (donor frontier behind "
              "ours) | stream_failed (chunk stream aborted) | "
              "chunk_reject (one per corrupt chunk rejected and "
              "refetched) | stale (dominance lost between stream and "
              "install).",
              labels=("outcome",)),
    MetricDef("etcd_snap_stream_chunk_seconds", "histogram",
              "Streamed snapshot install: receiver-side wall time per "
              "chunk from request to verified.", window=512),
    MetricDef("etcd_trace_drop_total", "counter",
              "Trace/flight events dropped, by reason: ring_overflow (the "
              "bounded ring overwrote its oldest event — size it with "
              "ETCD_FLIGHT_RING), unsampled is NOT counted (head sampling "
              "is a rate, not a loss).",
              labels=("reason",)),
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

    def snapshot(self, light: bool = False) -> dict:
        """count/sum/max, plus the exact ring percentiles unless
        ``light`` (which skips the ring sort)."""
        with self._lock:
            out = {"count": self.count, "sum": self.sum, "max": self.max}
            ring = None if light else sorted(self._ring)
        if ring is not None:
            for key, q in (("p50", 0.5), ("p90", 0.9),
                           ("p99", 0.99), ("p999", 0.999)):
                out[key] = (ring[min(len(ring) - 1, int(len(ring) * q))]
                            if ring else 0.0)
        return out


class _Family:
    """One family's view: its definition and its children."""

    def __init__(self, reg: "Registry", d: MetricDef):
        self.d = d
        self._reg = reg

    def children(self) -> list[tuple[tuple[str, ...], object]]:
        return self._reg.children(self.d.name)


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

    def family(self, name: str) -> _Family:
        """Family ``name`` (``KeyError`` when it is not in the
        catalog)."""
        return _Family(self, self._catalog[name])

    def snapshot(self, light: bool = False) -> dict:
        """JSON-ready view of every recorded family: kind, help and one
        entry per labeled child."""
        with self._lock:
            names = sorted({k[0] for k in self._children})
        out = {}
        for name in names:
            d = self._catalog[name]
            samples = []
            for labelvalues, child in self.children(name):
                entry = {"labels": dict(zip(d.labels, labelvalues))}
                if d.kind == "histogram":
                    entry.update(child.snapshot(light=light))
                else:
                    entry["value"] = child.get()
                samples.append(entry)
            out[name] = {"kind": d.kind, "help": d.help,
                         "samples": samples}
        return out

    def snapshot_json(self, light: bool = False) -> bytes:
        return (json.dumps(self.snapshot(light=light), sort_keys=True)
                + "\n").encode()

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
