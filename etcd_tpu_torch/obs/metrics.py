"""Typed process-wide metrics registry (the port's copy of
``etcd_tpu/obs/metrics.py``, the whole catalog).

Three instrument kinds behind one catalog:

- **Counter**: monotone float, ``inc(n)``.
- **Gauge**: settable float, ``set(v)`` / ``inc(n)``.
- **Histogram**: fixed log-spaced bucket boundaries (Prometheus
  ``le`` semantics) + a bounded ring of raw samples, so ``/metrics``
  gets bucket counts while snapshot-time percentiles (p50/p90/p99/
  p999) are EXACT over the ring window — percentile math never runs
  on the record path, which is one short lock + an append.

Every metric family must be declared in :data:`CATALOG` with its
labels: a typo'd name or label set raises at first record, never makes
a silent new family.  Names, kinds, labels, buckets and windows equal
the reference's, so ``obs/exporter.py`` renders the same exposition
for the same registry operations; the help texts are the port's, and
one family is the port's own (``etcd_devledger_fetches_total``).

This module is stdlib-only: the WAL and server tiers import it on their
hot paths.
"""

from __future__ import annotations

import json
import threading
from bisect import bisect_left
from collections import deque
from dataclasses import dataclass

#: default latency boundaries (seconds), log-spaced 100 µs → 10 s
LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

#: size/count boundaries, powers of two 1 → 8192
SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048,
                4096, 8192)

#: chaos-drill recovery boundaries — the series tops out well above
#: the latency default's 10 s when a window never recovers
RECOVERY_BUCKETS = (0.25, 0.5, 1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0,
                    4.5, 5.0, 5.5, 6.0, 8.0, 10.0, 15.0, 30.0)


@dataclass(frozen=True)
class MetricDef:
    """One registered metric family."""

    name: str
    kind: str                    # "counter" | "gauge" | "histogram"
    help: str
    labels: tuple[str, ...] = ()
    buckets: tuple[float, ...] = LATENCY_BUCKETS
    window: int = 1024           # histogram ring size (exact pctls)


# The metric inventory.  Names follow Prometheus conventions
# (unit-suffixed, ``_total`` for counters); the README "Observability"
# section mirrors this table.
_DEFS = (
    MetricDef(
        "etcd_span_seconds", "histogram",
        "Host span latency by span name (Tracer facade; the "
        "/v2/stats/spans source).", labels=("span",), window=256),
    MetricDef(
        "etcd_wal_fsync_seconds", "histogram",
        "WAL flush+fsync latency per sync() (the Ready-contract "
        "durability step)."),
    MetricDef(
        "etcd_wal_append_entries_total", "counter",
        "WAL entry records appended via save()."),
    MetricDef(
        "etcd_wal_cuts_total", "counter",
        "WAL segment cuts."),
    MetricDef(
        "etcd_apply_seconds", "histogram",
        "Apply-loop latency per absorbed commit batch."),
    MetricDef(
        "etcd_apply_batch_entries", "histogram",
        "Entries applied per apply-loop batch.",
        buckets=SIZE_BUCKETS),
    MetricDef(
        "etcd_election_campaigns_total", "counter",
        "Per-group election campaign lanes fired."),
    MetricDef(
        "etcd_election_wins_total", "counter",
        "Per-group election lanes won."),
    MetricDef(
        "etcd_peer_send_frames_total", "counter",
        "Peer frames POSTed (path: classic one-group sender | dist "
        "batched [G] frames).", labels=("path",)),
    MetricDef(
        "etcd_peer_send_seconds", "histogram",
        "Peer POST round-trip latency.", labels=("path",)),
    MetricDef(
        "etcd_peer_send_failures_total", "counter",
        "Peer frames dropped after retries.", labels=("path",)),
    MetricDef(
        "etcd_ack_rtt_seconds", "histogram",
        "Dist-tier consensus RTT per proposal: leader append/send "
        "-> quorum ack -> local apply.  Stamped at SEND, so client "
        "queueing cannot pollute it (the majority-RTT model of "
        "optimal-cluster-size.md).", window=4096),
    MetricDef(
        "etcd_pending_proposals", "gauge",
        "Requeued proposals awaiting a leader or window space."),
    MetricDef(
        "etcd_dist_pipeline_inflight", "gauge",
        "Append frames currently in flight to each peer (windowed "
        "pipeline; bounded by --dist-pipeline-depth).",
        labels=("peer",)),
    MetricDef(
        "etcd_dist_pipeline_inflight_entries", "gauge",
        "Entries (across all group lanes) in each peer's in-flight "
        "append window — the multi-group frame-fusion evidence: "
        "entries-per-frame is this over "
        "etcd_dist_pipeline_inflight.", labels=("peer",)),
    MetricDef(
        "etcd_client_wire_requests_total", "counter",
        "Batch client requests by negotiated wire format ("
        "binary client protocol; json is the compatibility "
        "default).", labels=("wire",)),
    MetricDef(
        "etcd_client_wire_fallback_total", "counter",
        "Binary-capable client fell back to HTTP+JSON, by reason: "
        "not_negotiated (server answered JSON — older peer or "
        "ETCD_WIRE_BINARY=0) | decode_error (binary reply failed to "
        "parse; sticky downgrade).  A mixed-version pair degrades "
        "HERE, never into failed ops.", labels=("reason",)),
    MetricDef(
        "etcd_dist_coalesce_entries", "histogram",
        "Client proposals coalesced per drain flush (adaptive "
        "cadence: max-entries/max-bytes threshold or the "
        "--dist-coalesce-us timer, whichever first).",
        buckets=SIZE_BUCKETS),
    MetricDef(
        "etcd_dist_frame_resend_total", "counter",
        "Pipeline frames re-sent or acks dropped, by reason: "
        "reconnect (transport died with frames in flight), reject "
        "(follower gap -> probe catch-up), stale_seq (duplicate or "
        "already-failed ack), stale_epoch (ack from a previous "
        "leadership reign), closed (channel shutdown), expired "
        "(in-flight past the ack deadline — backstop sweep).",
        labels=("reason",)),
    MetricDef(
        "etcd_devledger_dispatches_total", "counter",
        "Device dispatches crossing a jitted seam, per stage.",
        labels=("stage",)),
    MetricDef(
        "etcd_devledger_dispatch_seconds_total", "counter",
        "Wall seconds inside dispatch seams, per stage.",
        labels=("stage",)),
    MetricDef(
        "etcd_devledger_block_seconds_total", "counter",
        "Wall seconds blocked on device results "
        "(block_until_ready / host materialization), per stage.",
        labels=("stage",)),
    MetricDef(
        "etcd_devledger_h2d_bytes_total", "counter",
        "Host->device bytes shipped per stage.", labels=("stage",)),
    MetricDef(
        "etcd_devledger_d2h_bytes_total", "counter",
        "Device->host bytes fetched per stage.", labels=("stage",)),
    MetricDef(
        "etcd_devledger_fetches_total", "counter",
        "Device->host reads (host syncs) per stage (the port's own "
        "family: a read of device state is a sync on the card).",
        labels=("stage",)),
    MetricDef(
        "etcd_chaos_cycle_recovery_seconds", "histogram",
        "Chaos-drill kill -> all-groups-writable recovery per "
        "cycle.", buckets=RECOVERY_BUCKETS),
    MetricDef(
        "etcd_replay_backend_route", "gauge",
        "Replay backend chosen by wal/backend_policy per decision "
        "stage (replay | restart | e2e): 1 for the selected route "
        "(host | device | stream), 0 for the others.",
        labels=("stage", "route")),
    MetricDef(
        "etcd_replay_probe_bytes_per_sec", "gauge",
        "Backend-policy startup probe throughput per pipeline leg "
        "(host_scan | h2d | device_verify); 0 = leg unavailable or "
        "probe failed.", labels=("leg",)),
    MetricDef(
        "etcd_replay_stream_chunk_bytes", "gauge",
        "Chunk size the streaming replay pipeline is configured "
        "with."),
    MetricDef(
        "etcd_replay_stream_chunk_seconds", "histogram",
        "Per-chunk wall time of each streaming-replay stage "
        "(scan | h2d | verify) — overlap shows as stage sums "
        "exceeding the pipeline's wall clock.", labels=("stage",),
        window=512),
    MetricDef(
        "etcd_snap_stream_chunk_seconds", "histogram",
        "Streamed snapshot install: receiver-side wall time per "
        "chunk from request to verified (fetch + rolling-CRC "
        "verify over the peerlink channel).", window=512),
    MetricDef(
        "etcd_snap_install_total", "counter",
        "Snapshot install/pull attempts by outcome: ok (installed) | "
        "no_donor (no reachable donor host) | meta_failed (meta "
        "fetch/parse error) | not_dominating (donor frontier behind "
        "ours) | stream_failed (chunk stream aborted) | chunk_reject "
        "(one per corrupt chunk rejected and refetched) | stale "
        "(dominance lost between stream and install).",
        labels=("outcome",)),
    MetricDef(
        "etcd_wal_segments_gc_total", "counter",
        "WAL segment files deleted behind the durable snapshot "
        "index (delete-after-fsync GC; the bounded-disk invariant)."),
    MetricDef(
        "etcd_read_index_batch_size", "histogram",
        "Pending linearizable reads released per confirmation sweep "
        "(batched ReadIndex: one [G] quorum-basis compare "
        "amortizes the quorum check over every read it releases; "
        "p50 > 1 under load is the not-per-read-rounds evidence).",
        buckets=SIZE_BUCKETS, window=2048),
    MetricDef(
        "etcd_read_serve_total", "counter",
        "Linearizable/serializable read serves by path and outcome. "
        "path: lease (quorum-free clock-bound serve) | read_index "
        "(batched quorum-confirmed) | follower_wait (leader read "
        "index + local commit-index wait-point) | serializable "
        "(explicit opt-out, possibly stale) | quorum (QGET through "
        "the log, counted at apply) | cohosted (fused single-copy "
        "tier).  outcome: ok | timeout | not_leader | no_leader | "
        "stopped | expired (dropped by the server-side expiry "
        "sweep).", labels=("path", "outcome")),
    MetricDef(
        "etcd_read_rtt_seconds", "histogram",
        "Linearizable read round trip, stamped register -> serve "
        "(lease serves land in the first buckets; ReadIndex serves "
        "pay the piggybacked confirmation round).", window=4096),
    MetricDef(
        "etcd_stage_seconds", "histogram",
        "Per-stage attribution of the serving loops (stage() "
        "facade): one sample per pass through a labeled stage, "
        "split by kind — wall (perf_counter span), cpu "
        "(time.thread_time delta: CPU this thread actually burned "
        "inside the stage) and device (devledger-attributed "
        "dispatch/block seconds inside the stage, charged here "
        "ONCE so wall/cpu/device columns sum honestly instead of "
        "the ledger and the span double-counting the window).",
        labels=("stage", "kind"), window=512),
    MetricDef(
        "etcd_trace_spans_total", "counter",
        "Stage passes recorded by the stage() facade, per stage "
        "(the denominator for the etcd_stage_seconds sums).",
        labels=("stage",)),
    MetricDef(
        "etcd_flight_events_total", "counter",
        "Flight-recorder events recorded, by event class: span "
        "(per-proposal trace span), frame (peerlink send/recv/"
        "resp/ack edge of a traced frame), election, pipe_mode "
        "(REPLICATE/PROBE/SNAPSHOT transition), lease_loss, "
        "read_fail (fail-closed read), snap_install, tail "
        "(slow/failed proposal or read captured past head "
        "sampling).", labels=("class",)),
    MetricDef(
        "etcd_trace_drop_total", "counter",
        "Trace/flight events dropped, by reason: ring_overflow "
        "(the bounded ring overwrote its oldest event — size it "
        "with ETCD_FLIGHT_RING), unsampled is NOT counted (head "
        "sampling is a rate, not a loss).", labels=("reason",)),
    MetricDef(
        "etcd_watchers_active", "gauge",
        "Live registered watchers across this process's stores "
        "(incremented at registration, decremented at removal or "
        "eviction — co-hosted servers aggregate)."),
    MetricDef(
        "etcd_watch_delivered_total", "counter",
        "Watch events delivered to watcher queues / mux sinks by "
        "the fanout engine."),
    MetricDef(
        "etcd_watch_evictions_total", "counter",
        "Slow watchers evicted, by reason: overflow (bounded queue "
        "full under the default non-blocking policy) | stall "
        "(backpressure mode: the ETCD_WATCH_BLOCK_S deadline "
        "expired with the queue still full).", labels=("reason",)),
    MetricDef(
        "etcd_watch_dispatch_seconds", "histogram",
        "Fanout engine wall time per dispatch round, split by "
        "stage: match (hashed exact/recursive-prefix table "
        "resolution + history insertion, under the hub mutex only) "
        "| deliver (watcher-queue puts, outside every lock — the "
        "stage split proving no watcher work rides the store's "
        "world lock).", labels=("stage",), window=2048),
    MetricDef(
        "etcd_ttl_expire_batch_size", "histogram",
        "Keys expired per bulk TTL sweep (one SYNC apply drains "
        "the whole heap prefix in one pass and emits one EXPIRE "
        "batch through the fanout engine; empty sweeps are not "
        "observed).", buckets=SIZE_BUCKETS, window=2048),
    MetricDef(
        "etcd_fault_injected_total", "counter",
        "Fault-injection activations by failpoint and action "
        "(utils/faults.py FAULT_CATALOG; actions err | enospc | "
        "delay | drop | corrupt).  The nemesis drill's replay gate "
        "compares these across seeded re-runs.",
        labels=("point", "action")),
    MetricDef(
        "etcd_backoff_retries_total", "counter",
        "Jittered-exponential backoff waits taken (utils/backoff), "
        "by site: peerlink (pipe-channel reconnect pacing) | "
        "snap_pull (streamed snapshot pull re-arm) | client (API "
        "client endpoint-sweep failover) | nospace_probe (NOSPACE "
        "recovery probe) | admission (API client honoring a 429/503 "
        "Retry-After shed answer on the same endpoint).",
        labels=("site",)),
    MetricDef(
        "etcd_admission_total", "counter",
        "Front-door admission decisions (server/frontdoor.py), by "
        "outcome (admit | shed_write | shed_all | close) and reason "
        "(ok | tenant_rate | tenant_inflight | tenant_watches | "
        "global_inflight | queue_depth | conn_ceiling).  Every "
        "client request and accepted connection crosses exactly one "
        "decision.",
        labels=("outcome", "reason")),
    MetricDef(
        "etcd_tenant_inflight", "gauge",
        "Requests currently admitted and executing per tenant "
        "(frontdoor inflight accounting).  Label cardinality is "
        "bounded: past TENANT_LABEL_MAX distinct tenants, further "
        "tenants aggregate under the reserved '_other' label.",
        labels=("tenant",)),
    MetricDef(
        "etcd_conns_open", "gauge",
        "Client connections currently owned by the event-driven "
        "front door (accept increments, close/eviction decrements; "
        "the conn-ceiling close decision caps it)."),
    MetricDef(
        "etcd_nospace_active", "gauge",
        "1 while this server is in read-only NOSPACE mode (ENOSPC "
        "degradation: writes rejected with errorCode 405, reads "
        "serve, recovery probes the disk with backoff), else 0."),
    MetricDef(
        "etcd_profile_samples_total", "counter",
        "Sampling-profiler stack samples (always-on "
        "profiler), attributed to the innermost active "
        "tracer.stage() on the sampled thread (stage; '-' when "
        "outside every stage) and the thread-ownership domain from "
        "analysis/ownership.py whose root the sampled stack runs "
        "under (domain; '-' when unclassified).",
        labels=("stage", "domain")),
    MetricDef(
        "etcd_profile_overhead_ratio", "gauge",
        "Measured profiler self-cost: sampler-thread CPU seconds "
        "over wall seconds since start (the dist_bench "
        "--profile-overhead gate bounds the end-to-end acked/s "
        "cost at 2%; this gauge is the in-process floor)."),
    MetricDef(
        "etcd_slo_burn_rate", "gauge",
        "Error-budget burn rate per declared objective "
        "(obs/slo.py): observed bad fraction over the objective's "
        "window divided by the allowed bad fraction — 1.0 burns "
        "the budget exactly at the sustainable rate, >1 is "
        "burning, 0 with no samples.", labels=("objective",)),
    MetricDef(
        "etcd_slo_ok", "gauge",
        "1 while the objective meets its target over its window "
        "(vacuously 1 with no samples), else 0.",
        labels=("objective",)),
    MetricDef(
        "etcd_role_up", "gauge",
        "Supervisor-merged liveness per child role: 1 "
        "while the last /mraft/obs scrape is fresh, 0 while the "
        "role is down or mid-respawn (its last-known samples stay "
        "in the merged view, stale-marked — never a scrape "
        "error).", labels=("role",)),
    MetricDef(
        "etcd_obs_scrape_total", "counter",
        "Supervisor scrape attempts per child role by outcome: "
        "ok | error (child unreachable or bad snapshot — the "
        "merged view serves stale instead of failing).",
        labels=("role", "outcome")),
    MetricDef(
        "etcd_lint_findings", "gauge",
        "Findings per checker in the last static-analysis run "
        "(baselined findings included; suppressed ones not).",
        labels=("checker",)),
    MetricDef(
        "etcd_lint_run_seconds", "gauge",
        "Wall seconds of the last static-analysis run, per checker "
        "(checkers fan out over a thread pool, so children overlap; "
        "checker=\"_total\" is the run's elapsed time).",
        labels=("checker",)),
)

#: name -> MetricDef; THE metric vocabulary
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


class Gauge:
    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n

    def get(self) -> float:
        with self._lock:
            return self.value


class Histogram:
    """Log-bucketed histogram + bounded raw-sample ring.

    ``observe`` is one lock, one bisect, one append.  Percentiles are
    computed at snapshot time over the ring with the index rule
    ``sorted[min(n-1, int(n*q))]`` — the exact rule utils/trace.py
    has always used, so the Tracer facade's output stays byte-stable.
    """

    __slots__ = ("_lock", "bounds", "buckets", "count", "sum",
                 "max", "_ring")

    def __init__(self, bounds: tuple[float, ...],
                 window: int = 1024):
        self._lock = threading.Lock()
        self.bounds = tuple(float(b) for b in bounds)
        self.buckets = [0] * (len(self.bounds) + 1)  # +1: +Inf
        self.count = 0
        self.sum = 0.0
        self.max = 0.0
        self._ring: deque[float] = deque(maxlen=window)

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            if v > self.max:
                self.max = v
            self.buckets[bisect_left(self.bounds, v)] += 1
            self._ring.append(v)

    def ring_stats(self) -> tuple[int, float, float, list[float]]:
        """(count, sum, max, sorted ring) — one consistent read."""
        with self._lock:
            return self.count, self.sum, self.max, sorted(self._ring)

    def percentile(self, q: float) -> float:
        _, _, _, ring = self.ring_stats()
        if not ring:
            return 0.0
        return ring[min(len(ring) - 1, int(len(ring) * q))]

    def snapshot(self, light: bool = False) -> dict:
        # ONE critical section: buckets copied with count/sum/ring so
        # the +Inf cumulative always equals _count (the Prometheus
        # invariant a concurrent observe() between two lock takes
        # would break).  ``light`` skips the exact-percentile ring
        # sort — the dominant snapshot cost — for per-second callers
        # (the time-series ring, the supervisor scrape) that only
        # consume count/sum/buckets.
        with self._lock:
            count, total, mx = self.count, self.sum, self.max
            ring = None if light else sorted(self._ring)
            buckets = list(self.buckets)
        out = {"count": count, "sum": total, "max": mx,
               "bounds": list(self.bounds), "buckets": buckets}
        if ring is not None:
            for key, q in (("p50", 0.5), ("p90", 0.9),
                           ("p99", 0.99), ("p999", 0.999)):
                out[key] = (ring[min(len(ring) - 1,
                                     int(len(ring) * q))]
                            if ring else 0.0)
        return out


_KIND_CLASS = {"counter": Counter, "gauge": Gauge}


class _Family:
    """One metric family: the def plus its labeled children."""

    def __init__(self, d: MetricDef):
        self.d = d
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], object] = {}

    def child(self, labelvalues: tuple[str, ...]):
        with self._lock:
            c = self._children.get(labelvalues)
            if c is None:
                if self.d.kind == "histogram":
                    c = Histogram(self.d.buckets, self.d.window)
                else:
                    c = _KIND_CLASS[self.d.kind]()
                self._children[labelvalues] = c
            return c

    def children(self) -> list[tuple[tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())

    def clear(self) -> None:
        with self._lock:
            self._children.clear()


class Registry:
    """Catalog-checked accessors + whole-registry snapshots.

    Accessors raise ``KeyError`` for names missing from the catalog
    and ``TypeError`` for kind or label-key mismatches — a typo'd
    metric fails loudly at first record, never as a silent new
    family.
    """

    def __init__(self, catalog: dict[str, MetricDef] | None = None):
        self._catalog = dict(catalog if catalog is not None
                             else CATALOG)
        self._fams = {name: _Family(d)
                      for name, d in self._catalog.items()}

    def _child(self, name: str, kind: str, labels: dict):
        fam = self._fams.get(name)
        if fam is None:
            raise KeyError(
                f"metric {name!r} is not in the catalog "
                f"(register it in obs/metrics.py CATALOG)")
        if fam.d.kind != kind:
            raise TypeError(
                f"metric {name!r} is a {fam.d.kind}, not a {kind}")
        if tuple(sorted(labels)) != tuple(sorted(fam.d.labels)):
            raise TypeError(
                f"metric {name!r} takes labels {fam.d.labels}, "
                f"got {tuple(sorted(labels))}")
        return fam.child(tuple(str(labels[k])
                               for k in fam.d.labels))

    def counter(self, name: str, **labels) -> Counter:
        return self._child(name, "counter", labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._child(name, "gauge", labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._child(name, "histogram", labels)

    def family(self, name: str) -> _Family:
        return self._fams[name]

    def families(self) -> list[_Family]:
        return [self._fams[n] for n in sorted(self._fams)]

    def snapshot(self, light: bool = False) -> dict:
        """JSON-ready view: every family, its kind/help, and one
        entry per labeled child (histograms carry bucket counts AND
        exact ring percentiles — the /mraft/obs and soak-artifact
        form).  ``light`` skips the ring-sorted exact percentiles
        (the ``/mraft/obs/light`` scrape form: cheap enough for a
        per-second cadence)."""
        out = {}
        for fam in self.families():
            samples = []
            for labelvalues, child in fam.children():
                entry = {"labels": dict(zip(fam.d.labels,
                                            labelvalues))}
                if fam.d.kind == "histogram":
                    entry.update(child.snapshot(light=light))
                else:
                    entry["value"] = child.get()
                samples.append(entry)
            out[fam.d.name] = {"kind": fam.d.kind,
                               "help": fam.d.help,
                               "samples": samples}
        return out

    def snapshot_json(self, light: bool = False) -> bytes:
        return (json.dumps(self.snapshot(light=light),
                           sort_keys=True) + "\n").encode()

    def reset(self) -> None:
        """Drop every recorded sample (tests / process reuse)."""
        for fam in self._fams.values():
            fam.clear()


#: the process-wide default registry — servers, WAL, benches and the
#: /metrics exporter all record here
registry = Registry()


def percentile_from_buckets(bounds: list[float], buckets: list[int],
                            q: float) -> float:
    """Upper-bound percentile estimate from (possibly merged) bucket
    counts — the cross-process form (scripts/dist_bench.py merges the
    three hosts' ack-RTT buckets through this).  Returns the ``le``
    boundary of the bucket holding quantile ``q``; the overflow
    bucket reports the last finite boundary (a floor, flagged by the
    caller if it matters)."""
    total = sum(buckets)
    if total == 0:
        return 0.0
    target = q * total
    cum = 0
    for i, c in enumerate(buckets):
        cum += c
        if cum >= target:
            return bounds[i] if i < len(bounds) else bounds[-1]
    return bounds[-1]


def merge_histograms(samples: list[dict]) -> dict | None:
    """Merge JSON-snapshot histogram entries (same bounds) into one
    {bounds, buckets, count, sum} dict; None when empty/mismatched."""
    samples = [s for s in samples if s and s.get("count")]
    if not samples:
        return None
    bounds = samples[0]["bounds"]
    if any(s["bounds"] != bounds for s in samples):
        return None
    buckets = [0] * (len(bounds) + 1)
    count = 0
    total = 0.0
    for s in samples:
        for i, c in enumerate(s["buckets"]):
            buckets[i] += c
        count += s["count"]
        total += s["sum"]
    return {"bounds": bounds, "buckets": buckets, "count": count,
            "sum": total}


__all__ = [
    "CATALOG", "LATENCY_BUCKETS", "RECOVERY_BUCKETS", "SIZE_BUCKETS",
    "Counter", "Gauge", "Histogram", "MetricDef", "Registry",
    "merge_histograms", "percentile_from_buckets", "registry",
]
