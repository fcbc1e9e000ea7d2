"""Distributed multi-group server: G co-hosted raft groups replicated
across M HOSTS (one member slot per host) — SURVEY §5.8's two tiers
composed.

`MultiGroupServer` (multigroup.py) batches all M members in one
process and therefore shares process fate; THIS server is the
cross-host form the reference actually provides (a machine can die
and the cluster keeps serving, etcdserver/cluster_store.go:106-156):

- Each host runs ONE member slot of every group
  (raft/distmember.py — the same batched device ops as the fused
  runtime, applied to a single slot's [G] state).
- A replication round ships ONE binary frame per peer host
  (wire/distmsg.py: [G] prev_idx/prev_term/n_ents arrays + payload
  blobs) over HTTP POST — the reference's fire-and-forget peer
  transport (server.go:202-206) with the group axis batched.  A
  failed POST is a dropped message; progress resumes next round.
- Each host has its OWN WAL and snapshot dir: entries, ballots
  (term/vote — double-vote safety across restarts) and commit
  frontiers are fsynced before any response or ack leaves the host
  (the Ready contract, node.go:41-60).
- Slow or restarted followers catch up by normal append repair
  (reject → next_ = commit hint + 1) or, past the leader's
  compaction point, by pulling a full snapshot
  (GET /mraft/snapshot — the msgSnap analog as a pull).

Client writes go to the group's leader host (followers forward via
POST /mraft/propose); reads serve from any host's store replica.

This is the port of ``etcd_tpu/server/distserver.py``: host code
copied line for line, the engine state in tensors on
``default_device(device)`` (CUDA unless the caller passes
``device="cpu"``; without CUDA construction raises).  It differs from
the reference in these points only:

- the restart seeds the engine with tensors on the server's device;
- ``mesh=`` takes the port's ``parallel.GroupMesh`` (which may be
  virtual shards of one card);
- snapshots hash through ``ops.crc_kernel.auto_crc32c`` on the
  server's device (no silent host fallback), and streamed snapshot
  chunks verify through ``ChunkVerifier`` on that device;
- host reads of engine state go through ``obs.devledger.fetch``
  (stage ``dist.server``), so the reads a round costs are counted;
- two durability repairs: a snapshot is saved at the WAL seq of the
  oldest entry record its frontier does not cover (``_replay_floor``),
  not at its own seq, so a restart replays entries appended before it
  and applied after it; and a streamed snapshot install is saved as
  this host's own snapshot before a frontier record claims it.  The
  reference loses those keys on a restart.
"""

from __future__ import annotations

import functools
import hashlib
import json
import logging
import os
import queue
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlparse

import numpy as np

import torch

from .. import default_device
from ..obs import metrics as _obs
from ..obs.devledger import ledger as _ledger
from ..obs.flight import FlightRecorder
from ..ops.crc_kernel import auto_crc32c
from ..raft.distmember import DistMember
from ..snap import NoSnapshotError, Snapshotter
from ..snap.stream import (
    CHUNK_PATH as SNAP_CHUNK_PATH,
    FRONTIER_PATH as SNAP_FRONTIER_PATH,
    META_PATH as SNAP_META_PATH,
    ChunkPuller,
    ChunkVerifier,
    SnapshotSource,
    SnapStreamError,
    SourceCache,
    StaleSourceError,
)
from ..store import Store
from ..utils import faults as _faults
from ..utils.backoff import Backoff
from ..utils.errors import EtcdError, EtcdNoSpace
from ..utils.trace import tracer
from ..utils.wait import Chan, Wait
from ..wal import WAL, exist as wal_exist
from ..wire import Entry, GroupEntry, HardState, Snapshot
from ..wire.proto import marshal_group_entries
from ..wire import clientmsg
from ..wire import rolemsg
from ..wire.distmsg import (
    AppendBatch,
    AppendResp,
    FrameError,
    PackedPayloads,
    VoteReq,
    VoteResp,
    unmarshal_any,
)
from ..wire.requests import Info, Request
from .distpipe import AppendPipeline
from .frontdoor import LISTEN_BACKLOG
from .multigroup import TICK_INTERVAL, group_of
from .peerlink import KeepAlivePool, PipeChannel
from .readindex import (
    PATH_SERIALIZABLE,
    LeaseClock,
    ReadQueue,
    WaitPoints,
    lease_drift_ticks,
    serve_counter,
)
from .server import (
    DEFAULT_SNAP_COUNT,
    Response,
    ServerStoppedError,
    UnknownMethodError,
    apply_request_to_store,
    gen_id,
)

log = logging.getLogger(__name__)

# Peer-tier read endpoints (linearizable read path)
READ_INDEX_PATH = "/mraft/readindex"
GET_MANY_PATH = "/mraft/get_many"
ROLE_FWD_PATH = "/mraft/role_fwd"

# read_many result-slot sentinels: identity-compared module objects,
# never strings — a STORED VALUE equal to any string sentinel would
# collide with it (the compact fast path writes raw leaf values into
# the same result list)
_SERZ = object()     # serializable entry, serve after the linz pass
_EXPIRED = object()  # pending read dropped by the expiry sweep

# WAL record kinds (GroupEntry.kind)
K_ENTRY = 0      # a group's log entry
K_FRONTIER = 1   # commit-frontier marker: [G] commit + [G] terms
K_BALLOT = 2     # durable term/vote: [G] terms + [G] votes


class FrameDropped(Exception):
    """A peerlink.recv failpoint swallowed an inbound frame: the
    handler closes the connection without a response — to the sender
    this is a lost message (teardown + probe), to this host the
    frame never arrived."""


class _Pending:
    __slots__ = ("req", "data", "id", "retries", "group", "trace")

    def __init__(self, req, data, id, group=None, trace=None):
        self.req, self.data, self.id = req, data, id
        self.retries = 0
        # explicit group routing (ConfChange entries target a group
        # directly instead of hashing a client path)
        self.group = group
        # head-sampled distributed-trace id (None = untraced)
        self.trace = trace


class DistServer:
    """Member ``slot`` of an M-host distributed multi-group cluster.

    ``peer_urls``: slot-indexed peer base URLs (this host's own slot
    entry is ignored); e.g. ``["http://127.0.0.1:7700", ...]``.
    """

    def __init__(self, data_dir: str, *, slot: int,
                 peer_urls: list[str], g: int = 64,
                 cap: int = 1024, name: str | None = None,
                 snap_count: int = DEFAULT_SNAP_COUNT,
                 max_batch_ents: int = 32,
                 tick_interval: float = TICK_INTERVAL,
                 sync_interval: float = 0.5,
                 post_timeout: float = 1.0,
                 election: int = 10,
                 storage_backend: str = "auto",
                 live: int | None = None,
                 client_urls: list[str] | None = None,
                 mesh=None, peer_tls=None,
                 pipeline_depth: int = 8,
                 coalesce_us: int = 2000,
                 coalesce_ents: int = 512,
                 coalesce_bytes: int = 1 << 20,
                 snap_keep: int | None = None,
                 lease_ticks: int | None = None,
                 device=None):
        self.slot = slot
        # resolved before any disk mutation: without CUDA (and no
        # device="cpu") construction raises here
        self.device = default_device(device)
        self.g, self.m = g, len(peer_urls)
        # live member slots (< m leaves spare slots for runtime
        # AddMember; the extra peer URLs name the joinable hosts)
        self.live = self.m if live is None else live
        if not (0 < self.live <= self.m):
            # an out-of-range live count would silently make quorum
            # unattainable (nmembers is taken verbatim by the engine)
            raise ValueError(
                f"live={self.live} must be in 1..{self.m} "
                f"(len(peer_urls))")
        self.peer_urls = list(peer_urls)
        # Peer-tier TLS, same contexts as the classic sender/listener
        # (utils/transport.py; client-cert auth required when the
        # server context carries a CA)
        self._peer_ssl_srv = None
        self._peer_ssl_cli = None
        tls_on = peer_tls is not None and not peer_tls.empty()
        # scheme/TLS agreement up front: a mismatch would fail every
        # handshake SILENTLY (_post_peer treats errors as dropped
        # frames) — a dead cluster with nothing in the logs
        https = {u.startswith("https://") for u in self.peer_urls}
        if tls_on and https != {True}:
            raise ValueError(
                "peer TLS configured but --dist-peers has non-https "
                "URLs")
        if not tls_on and True in https:
            raise ValueError(
                "https --dist-peers requires peer TLS "
                "(--peer-cert-file/--peer-key-file)")
        if tls_on:
            self._peer_ssl_srv = peer_tls.server_context()
            self._peer_ssl_cli = peer_tls.client_context()
        if mesh is not None:
            # validate BEFORE any disk mutation: failing after the
            # fresh WAL is created would make the corrected retry
            # look like a restart (fresh=False) and skip bootstrap
            from ..parallel.mesh import check_group_divisible

            check_group_divisible(mesh, g)
        self.name = name or f"dist{slot}"
        self.snap_count = snap_count or DEFAULT_SNAP_COUNT
        self.tick_interval = tick_interval
        self.sync_interval = sync_interval
        self.post_timeout = post_timeout
        self.backend = storage_backend
        self.id = int.from_bytes(
            hashlib.sha1(self.name.encode()).digest()[:8],
            "big") & (2**63 - 1)

        self.store = Store()
        # watch fanout on its own delivery stage:
        # _apply_committed runs under self.lock, so watcher-queue
        # work there would stall every handler and the round loop —
        # the engine thread takes it instead
        self.store.fanout.start()
        self.w = Wait()
        self.done = threading.Event()
        self.lock = threading.RLock()
        # serving seams the v2 HTTP layer mounts against (api/http.py
        # reads do/index/term/store/stats/cluster_store — the same
        # surface EtcdServer and MultiGroupServer expose)
        from .cluster import ClusterStore
        from .stats import LeaderStats, ServerStats

        self.server_stats = ServerStats(self.name, self.id)
        self.leader_stats = LeaderStats(self.id)
        self.cluster_store = ClusterStore(self.store)
        self._client_urls = client_urls or []
        self._queue: queue.Queue[_Pending | None] = queue.Queue()
        self._slot_ids: dict[int, int] = {}  # slot -> member id cache
        self._requeue: list[deque] = [deque() for _ in range(g)]
        self._need_pull = False      # snapshot catch-up requested
        # Streamed-install retry state: a failed pull re-arms
        # _need_pull and backs off with jittered exponential delay
        # across attempts (capped) instead of silently dropping the
        # request — the wedge the monolithic pull had.  Guarded by
        # self.lock.  The shape lives in the shared
        # utils/backoff.Backoff (site="snap_pull").
        self._pull_backoff = Backoff(base=max(0.25, post_timeout),
                                     cap=30.0, site="snap_pull")
        self._pull_not_before = 0.0  # monotonic gate for next attempt
        # per-donor store-size hints from the frontier probe: scales
        # the meta-fetch timeout with the blob the donor must
        # serialize before replying (round-loop/pull-thread only)
        self._donor_size_hint: dict[int, int] = {}
        # donor-side pinned snapshot serializations (chunk streams
        # must serve one immutable byte stream per pull).  keep
        # scales with the peer count: every OTHER member may lag
        # concurrently (partition heal), and each pull pins its own
        # stream — a fixed small keep would let them evict each
        # other's pins mid-stream into stale/backoff churn
        self._snap_sources = SourceCache(keep=max(2, self.m - 1))
        # corruption-injection test hook (chaos drill): flip one byte
        # of this chunk index the FIRST time it is served, proving
        # the receiver rejects + refetches rather than installs
        self._corrupt_chunk = int(os.environ.get(
            "ETCD_SNAP_STREAM_CORRUPT_CHUNK", -1))
        self._corrupted_once = False
        # snapshot-at-threshold runs on the ROUND LOOP, outside
        # self.lock (apply paths only raise this flag); _snap_mutex
        # serializes direct snapshot() callers against it
        self._want_snap = False
        self._snap_mutex = threading.Lock()
        # the deferred snapshot runs on its own thread (spawned and
        # tracked by the round loop only): save_snap's write+fsync of
        # a big store must not stall election ticks or leader pumps —
        # the round loop IS the heartbeat source
        self._snap_thread: threading.Thread | None = None
        # the streamed pull runs off the round loop too (spawned and
        # tracked by the round loop only): meta fetch + chunk stream
        # of a big store block for minutes, and the round loop is the
        # tick/heartbeat source for any lanes this host still leads
        self._pull_thread: threading.Thread | None = None
        # one source of truth for election forensics (liveness beat +
        # campaign-lost logging), read once at construction
        self._debug_elections = bool(
            os.environ.get("ETCD_DEBUG_ELECTIONS"))
        self._thread: threading.Thread | None = None
        self._httpd = None
        # Round-loop I/O plumbing that must NOT be rebuilt per round
        # (a fresh ThreadPoolExecutor + TCP connect per exchange cost
        # more than the frame transfer at localhost latencies): one
        # persistent worker pool for the vote round-trips and the
        # shared keep-alive connection cache (peerlink.KeepAlivePool,
        # also behind the classic sender) for every synchronous POST.
        from concurrent.futures import ThreadPoolExecutor

        self._xchg_pool = ThreadPoolExecutor(
            max_workers=max(1, self.m - 1),
            thread_name_prefix=f"dist{slot}-xchg")
        self._pool = KeepAlivePool(timeout=post_timeout,
                                   ssl_context=self._peer_ssl_cli)
        # read-index fetches ride their OWN keep-alive pool: the
        # leader's /mraft/readindex handler may lawfully hold the
        # request for up to 5s awaiting quorum confirmation
        # (fresh-leader window), while the shared pool's socket
        # timeout is post_timeout (1-2s) — over there a slow-but-
        # answering leader would read as unreachable, fail the read
        # no_leader, and tear down the pooled socket
        self._ri_pool = KeepAlivePool(
            timeout=max(6.0, 3.0 * post_timeout),
            ssl_context=self._peer_ssl_cli)

        # Windowed append pipeline: per-peer (epoch, seq)
        # tagged in-flight frames over striped pipelined connections;
        # acks absorbed as they arrive on the channel reader threads
        # (quorum recomputed per ack).  All pipeline state below is
        # guarded by self.lock.
        if pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth={pipeline_depth} must be >= 1 "
                f"(1 == lockstep-equivalent window)")
        self.pipe = AppendPipeline(self.m, slot, pipeline_depth)
        # the second striped connection parallelizes socket I/O and
        # follower-side processing ACROSS CORES; on a single-core
        # host it only fragments the [G]-wide frames (two half-frames
        # cost two full engine dispatches + two fsyncs at the
        # follower — measured 2526/s vs 3813/s on the loopback
        # bench), so striping gates on real parallelism being there
        self._n_stripes = (2 if pipeline_depth > 4
                           and (os.cpu_count() or 1) > 1 else 1)
        self._stripe_masks = [
            (np.arange(g) % self._n_stripes) == s
            for s in range(self._n_stripes)]
        self._channels: dict[int, PipeChannel] = {}
        # per-peer [G] commit vector last shipped (empty-frame dedup:
        # heartbeats go out on commit movement or cadence, not every
        # loop iteration)
        self._sent_commit = np.full((self.m, g), -1, np.int64)
        self._hb_interval = tick_interval
        # minimum entries for a SECOND (or later) in-flight frame
        # (see the anti-fragmentation comment in _pump_peer): two
        # full coalesce batches — an idle pipe sends immediately, an
        # already-busy pipe only adds frames that amortize their
        # fixed per-frame cost.  ETCD_DIST_MIN_FRAME overrides for
        # bench sweeps.
        self._min_frame_ents = max(1, int(os.environ.get(
            "ETCD_DIST_MIN_FRAME", 2 * coalesce_ents)))
        self.coalesce_us = coalesce_us
        self.coalesce_ents = coalesce_ents
        self.coalesce_bytes = coalesce_bytes
        # (group, gindex) -> _Pending for in-flight leader proposals;
        # acked at apply, failed on leadership loss (guarded by lock)
        self._assigned: dict[tuple[int, int], _Pending] = {}
        # frontier-record dedup: (commit, terms) last written
        self._fr_last: tuple[np.ndarray, np.ndarray] | None = None
        # (gindex, WAL seq) of the entry records persisted here and
        # not yet applied, per group in append order: a snapshot's
        # frontier does not cover them, so its WAL replay must start
        # at the oldest of them (see _replay_floor)
        self._tail_seqs: list[deque] = [deque() for _ in range(g)]

        os.makedirs(data_dir, mode=0o700, exist_ok=True)
        self._snapdir = os.path.join(data_dir, "snap")
        os.makedirs(self._snapdir, mode=0o700, exist_ok=True)
        self._waldir = os.path.join(data_dir, "wal")
        crc_fn = None
        if storage_backend != "host":
            # large snapshots hash on the card (the raw-CRC kernel)
            # when the one-time race says it wins; small ones on the
            # host
            crc_fn = functools.partial(auto_crc32c, device=self.device)
        from ..snap import DEFAULT_SNAP_KEEP

        self.ss = Snapshotter(
            self._snapdir, crc_fn=crc_fn,
            keep=snap_keep if snap_keep is not None
            else int(os.environ.get("ETCD_SNAP_KEEP",
                                    DEFAULT_SNAP_KEEP)))

        self.seq = 0
        self.applied = np.zeros(g, np.int64)
        self.raft_index = 0
        self.raft_term = 0
        self._snapi = 0
        self._ballot = (np.zeros(g, np.int32), np.full(g, -1, np.int32))

        # Leadership-transition trace (GET /mraft/leaders): per-group
        # wall time this host last WON a lane's election, the term it
        # won, the applied frontier at that moment, and the wall time
        # of the first apply that advanced past it (= the lane became
        # writable end-to-end on the server side).  Lets the chaos
        # drill decompose its client-observed kill->writable window
        # into election delay / commit-pipeline delay / client-probe
        # artifact.  Cost: one [G] bool compare per
        # round; term fetch only on the (rare) transition.
        self._elected_at = np.zeros(g, np.float64)
        self._elected_term = np.zeros(g, np.int64)
        self._applied_at_elect = np.zeros(g, np.int64)
        self._first_apply_at = np.zeros(g, np.float64)
        self._prev_lead = np.zeros(g, bool)

        # obs seams.  The ack-RTT clock stamps each proposal
        # at SEND (leader append + frame build, _leader_round) keyed
        # by (group, gindex); the apply loop pops it at quorum-ack →
        # apply, so the histogram measures consensus RTT — queue wait
        # before the round never enters it.  Mutated only under
        # self.lock.
        self._ack_clock: dict[tuple[int, int], float] = {}
        self._m_ack = _obs.registry.histogram("etcd_ack_rtt_seconds")
        self._m_frames = _obs.registry.counter(
            "etcd_peer_send_frames_total", path="dist")
        self._m_send_rtt = _obs.registry.histogram(
            "etcd_peer_send_seconds", path="dist")
        self._m_send_fail = _obs.registry.counter(
            "etcd_peer_send_failures_total", path="dist")
        self._m_campaigns = _obs.registry.counter(
            "etcd_election_campaigns_total")
        self._m_wins = _obs.registry.counter(
            "etcd_election_wins_total")
        self._m_apply_s = _obs.registry.histogram(
            "etcd_apply_seconds")
        self._m_apply_n = _obs.registry.histogram(
            "etcd_apply_batch_entries")
        self._m_pending = _obs.registry.gauge(
            "etcd_pending_proposals")
        self._m_coalesce = _obs.registry.histogram(
            "etcd_dist_coalesce_entries")
        # per-peer in-flight gauges, cached like every other hot-path
        # handle (the labeled registry lookup costs a lock + key
        # build per call, and _set_inflight runs per ack/pump)
        self._m_inflight = {
            p: _obs.registry.gauge("etcd_dist_pipeline_inflight",
                                   peer=str(p))
            for p in range(self.m) if p != slot}
        self._m_inflight_ents = {
            p: _obs.registry.gauge(
                "etcd_dist_pipeline_inflight_entries", peer=str(p))
            for p in range(self.m) if p != slot}
        # answer batch endpoints in the binary client framing
        # (wire/clientmsg.py) when the request advertises it via
        # Accept.  ETCD_WIRE_BINARY=0 simulates a JSON-only server —
        # the mixed-version arm of the negotiation compat tests.
        self.wire_binary = \
            os.environ.get("ETCD_WIRE_BINARY", "1") != "0"

        # -- linearizable read path ----------------------------
        # Lease band: the lease may only vouch for leadership while
        # NO follower the quorum heard from can have fired its
        # election timer — lease_ticks must sit strictly below the
        # election band minus a clock-drift margin (the same
        # invariant the static lease-band checker enforces at call
        # sites and flag tables; DistMember clamps election >= m, so
        # validate against the clamped value).  lease_ticks=0
        # disables the lease: every linearizable read then takes the
        # batched-ReadIndex confirmation.
        eff_election = max(election, self.m)
        drift = lease_drift_ticks(eff_election)
        if lease_ticks is None:
            lease_ticks = eff_election // 2
        if lease_ticks < 0:
            raise ValueError(f"lease_ticks={lease_ticks} < 0")
        if lease_ticks and lease_ticks >= eff_election - drift:
            raise ValueError(
                f"lease_ticks={lease_ticks} must be < election - "
                f"drift margin = {eff_election} - {drift}: a lease "
                f"that outlives the election band could serve reads "
                f"after a new leader commits")
        self._lease_s = lease_ticks * tick_interval
        self.lease = LeaseClock(g, self.m, slot)
        self._reads = ReadQueue(g)
        self._waits = WaitPoints(g)
        # current-term-commit gate (raft thesis §6.4): a fresh leader
        # must not serve reads at its (possibly stale) commit index
        # until an entry of ITS term commits — _read_ok[g] tracks
        # that off the frontier terms _persist already computes, and
        # _read_floor[g] is the commit index when it first held
        # (>= every index an older leader could have committed).
        self._read_ok = np.zeros(g, bool)
        self._read_floor = np.zeros(g, np.int64)
        # host caches the read hot path serves from (a device fetch
        # per GET would cost more than the read): leadership is
        # _prev_lead (refreshed each round), hint mirrors the round
        # loop's fetch, membership refreshes on conf change/install
        self._hint_np = np.full(g, -1, np.int64)
        self._read_nudge_t = 0.0
        self._wait_expire_at = 0.0  # wait-point sweep cadence gate
        # namespace -> group cache: group_of is a sha1 per call and
        # the read lane routes tens of thousands of keys/s over a
        # small working set of first path segments (bounded: cleared
        # wholesale if an adversarial key stream ever fills it)
        self._ns_groups: dict[str, int] = {}
        self._m_ri_batch = _obs.registry.histogram(
            "etcd_read_index_batch_size")
        self._m_read_rtt = _obs.registry.histogram(
            "etcd_read_rtt_seconds")
        self._read_ctrs: dict[tuple[str, str], object] = {}

        # -- gray-failure semantics ---------------------------
        # NOSPACE read-only mode: an EtcdNoSpace from any WAL/snap
        # writer flips _nospace; writes are rejected with errorCode
        # 405 while reads keep serving (leader lanes via the lease —
        # heartbeats need no WAL), and the round loop probes the
        # disk with backoff until space returns.  _held_recs carries
        # leader-side WAL records whose entries are already in the
        # engine log (frames may be in flight): they re-persist
        # FIRST on recovery so the leader's own durable ack is never
        # counted for an unpersisted entry.  Guarded by self.lock.
        self._nospace = False
        self._held_recs: list[Entry] | None = None
        # precomputed failpoint link labels: the recv seam runs per
        # pipelined ack and per inbound frame — two f-string
        # allocations per crossing would tax the no-faults common
        # case for nothing
        self._self_label = f"s{slot}"
        self._peer_labels = {p: f"s{p}" for p in range(self.m)}
        self._nospace_backoff = Backoff(base=0.25, cap=5.0,
                                        site="nospace_probe")
        self._nospace_probe_t = 0.0
        self._m_nospace = _obs.registry.gauge("etcd_nospace_active")
        # Check-quorum step-down: a leader whose inbound acks are
        # lost (one-way partition) must abdicate so its followers —
        # whose timers its still-delivered heartbeats keep resetting
        # — can elect a reachable leader.  A lane steps down when
        # its quorum ack basis (lease clock) is older than the FULL
        # worst-case election window, with a fresh-win grace
        # (_lead_since, monotonic).
        self._lead_since = np.zeros(g, np.float64)
        self._down_s = 2.0 * (2 * max(election, self.m)) \
            * tick_interval

        # -- tracing + flight recorder -------------------------
        # Per-server ring: in-process test clusters must not mix
        # three servers' events in one ring (the stitcher keys on the
        # node).  ETCD_TRACE_SAMPLE (head sampling 1-in-N; 0 = trace
        # off), ETCD_FLIGHT_RING (capacity) and ETCD_TRACE_SLOW_MS
        # (tail-capture threshold) are read by the recorder.
        self.flight = FlightRecorder(node=self.name, slot=slot)
        # fault activations land in this server's black box, and a
        # fail-stop dumps the ring before the process exits
        _faults.FAULTS.attach_sink(self.flight)
        # committed-stream tap for the role-split topology:
        # server/roles.py attaches a CommitSink AFTER start() so
        # WAL-replay applies never reach the apply worker twice.
        # Called under self.lock with (group, gindex, payload) rows;
        # payload is the already-marshaled Request — the handoff
        # never re-marshals what raft just committed.
        # typed (string: roles.py would be a circular import) so
        # the concurrency model can follow sink.push -> ring.push
        self.commit_sink: "CommitSink | None" = None
        # (group, gindex) -> trace_id for in-flight TRACED proposals
        # (sampled subset of _ack_clock's keys; guarded by self.lock)
        self._trace_live: dict[tuple[int, int], int] = {}
        # (peer, seq) -> [[trace, origin], ...] for frames whose
        # trace block is in the channel queue: the peerlink on_sent
        # callback pops this (GIL-atomic) and stamps the flight
        # frame event at the actual socket write
        self._traced_send: dict[tuple[int, int], list] = {}

        self.mr = DistMember(g, self.m, slot, cap,
                             election=election,
                             max_batch_ents=max_batch_ents, seed=slot,
                             live=self.live, device=self.device)
        # fresh = brand-new data dir (callers gate bootstrap-only
        # actions like the slot-0 mass campaign on this, NOT on
        # is_leader() — leadership is volatile and always empty
        # after a restart)
        self.fresh = not wal_exist(self._waldir)
        if not self.fresh:
            self._restart()
        else:
            self.wal = WAL.create(self._waldir,
                                  Info(id=self.id).marshal())
            zero = np.zeros(g, np.int32).tobytes()
            self.wal.save(HardState(), [Entry(
                index=0, term=0,
                data=GroupEntry(kind=K_FRONTIER,
                                payload=zero + zero).marshal())])
        # intra-host scale-out: this host's [G] batch split over a
        # local device mesh (after restart seeding so the replayed
        # state gets placed too)
        self.mesh = mesh
        if mesh is not None:
            self.mr.shard(mesh)
        self._refresh_member_cache()

    def _refresh_member_cache(self) -> None:
        """Host copy of the engine's [G, M] membership (call with
        self.lock held; init/restart call before the lock exists).
        The read path's quorum-basis math runs per GET — it must
        not pay a device fetch for arrays that change only on conf
        changes and snapshot installs."""
        st = self.mr.state
        self._members_np = _ledger.fetch(
            "dist.server", st.members).astype(bool)
        self._nmembers_np = _ledger.fetch(
            "dist.server", st.nmembers).astype(np.int64)

    # -- restart ----------------------------------------------------------

    def _restart(self) -> None:
        """Snapshot + WAL replay → store, frontier, AND the log tail.

        Unlike the fate-sharing co-hosted server (which may drop
        never-acked tails, multigroup.py:26-31), a distributed member
        MUST retain entries it acked to the leader even if they are
        not yet committed — the leader counts that ack toward quorum
        (Raft durability).  So the tail above the frontier is
        reconstructed into the engine log, and the persisted ballot
        (term/vote) is restored for double-vote safety.
        """
        g = self.g
        frontier = np.zeros(g, np.int64)
        fterms = np.zeros(g, np.int64)
        snap_index = 0
        applied_total = 0
        try:
            snap = self.ss.load()
        except NoSnapshotError:
            snap = None
        if snap is not None:
            blob = json.loads(snap.data.decode())
            if len(blob["frontier"]) != g:
                raise RuntimeError(
                    f"snapshot written with g={len(blob['frontier'])}"
                    f", not {g}")
            self.store.recovery(blob["store"].encode())
            frontier = np.asarray(blob["frontier"], np.int64)
            fterms = np.asarray(blob["terms"], np.int64)
            snap_index = blob["seq"]
            applied_total = blob.get("applied_total", 0)
        snap_frontier = frontier.copy()
        self.seq = snap_index

        from .gereplay import scan as ge_stream_scan, seed_log_arrays
        from .server import _replay_wal_raw

        self.wal, md, _hs, raw = _replay_wal_raw(
            self._waldir, snap_index, self.backend, stage="restart",
            device=self.device)
        info = Info.unmarshal(md or b"")
        if info.id != self.id:
            raise RuntimeError(
                f"unexpected server id {info.id:x}, want {self.id:x}")

        # array pass (gereplay): one native envelope sweep; frontier/
        # ballot = last record of their kind; winner dedup vectorized
        stream = ge_stream_scan(raw)
        if len(stream):
            self.seq = max(self.seq, int(stream.seq.max()))
        terms = np.zeros(g, np.int32)
        votes = np.full(g, -1, np.int32)
        fpos = stream.last_of_kind(K_FRONTIER)
        if fpos >= 0:
            v = np.frombuffer(stream.payload(fpos), np.int32)
            if v.size != 2 * g:
                raise RuntimeError(
                    f"data dir written with g={v.size // 2}, not {g}")
            # frontier records are monotonic in stream order: the
            # last one wins (newer than the snapshot too)
            frontier = v[:g].astype(np.int64)
            fterms = v[g:].astype(np.int64)
        bpos = stream.last_of_kind(K_BALLOT)
        if bpos >= 0:
            v = np.frombuffer(stream.payload(bpos), np.int32)
            terms = v[:g].copy()
            votes = v[g:2 * g].copy()

        # committed prefix → store, in (group, gindex) order
        winners = stream.winner_positions()
        committed = winners[
            (stream.gindex[winners] > snap_frontier[
                stream.group[winners]])
            & (stream.gindex[winners] <= frontier[
                stream.group[winners]])]
        committed = committed[np.lexsort(
            (stream.gindex[committed], stream.group[committed]))]
        applied_n = int(committed.size)
        conf_changes: list[tuple[int, Request]] = []
        for k in committed:
            payload = stream.payload(int(k))
            if not payload:
                continue
            r = Request.unmarshal(payload)
            if r.method == "CONFCHANGE":
                # engine-targeted: re-applies after seeding below
                conf_changes.append((int(stream.group[k]), r))
            else:
                apply_request_to_store(self.store, r)

        # engine seeding: compacted-at-frontier log + contiguous tail
        # (acked-but-uncommitted entries MUST survive — the leader
        # counted our ack toward quorum), rebuilt in arrays
        mr = self.mr
        cap = mr.cap
        log_term, last, tail_pos = seed_log_arrays(
            stream, winners, frontier, fterms, g, cap)
        for k in tail_pos:
            payload = stream.payload(int(k))
            if payload:
                mr.payloads[int(stream.group[k])][
                    int(stream.gindex[k])] = payload
            # the retained tail is still unapplied: a snapshot taken
            # before it applies must replay it (_replay_floor)
            self._tail_seqs[int(stream.group[k])].append(
                (int(stream.gindex[k]), int(stream.seq[k])))
        terms = np.maximum(terms, fterms.astype(np.int32))
        fr = mr._put(frontier, np.int32)
        st = mr.state._replace(
            term=mr._put(terms), vote=mr._put(votes),
            commit=fr, applied=fr, offset=fr,
            last=mr._put(last, np.int32),
            log_term=mr._put(log_term))
        if snap is not None and "members" in blob:
            msnap = np.asarray(blob["members"], bool)
            if msnap.shape[1] != self.m:
                raise RuntimeError(
                    f"snapshot has {msnap.shape[1]} member slots, "
                    f"this cluster has {self.m} (len(peer_urls))")
            mj = mr._put(msnap)
            st = st._replace(
                members=mj, nmembers=mj.sum(dim=1).to(torch.int32))
        mr.state = st
        # committed ConfChanges in the replayed window re-apply on
        # the fresh engine (the snapshot's mask covers everything
        # below it)
        for gi, r in conf_changes:
            self._apply_conf_change(gi, r)
        self._ballot = (terms.copy(), votes.copy())
        self.applied = frontier.copy()
        self.raft_index = applied_total + applied_n
        self.raft_term = int(terms.max()) if g else 0
        self._snapi = self.raft_index
        log.info("dist[%d]: restart — %d replayed, %d applied, "
                 "tail up to %s", self.slot, len(stream), applied_n,
                 int(last.max()) if g else 0)

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        """Bind the peer listener and start the round loop."""
        from ..obs import profiler as _profiler
        from ..obs import timeseries as _timeseries

        # always-on per-process observability: the sampling profiler
        # and the windowed-delta ring behind /mraft/obs/timeseries
        # (idempotent; ETCD_PROFILE_HZ=0 disables the sampler)
        _profiler.start_default()
        _timeseries.start_default()
        threading.Thread(target=self._publish, daemon=True).start()
        u = urlparse(self.peer_urls[self.slot])
        handler = _make_peer_handler(self)
        self._httpd = _PeerHTTPServer((u.hostname, u.port), handler)
        self._httpd.daemon_threads = True
        if self._peer_ssl_srv is not None:
            # handshake deferred to the per-connection worker thread
            # (first read triggers it): a stalled client must not
            # block accept() and with it ALL peer raft traffic; the
            # handler's socket timeout bounds the lazy handshake
            self._httpd.socket = self._peer_ssl_srv.wrap_socket(
                self._httpd.socket, server_side=True,
                do_handshake_on_connect=False)
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()

    def _publish(self) -> None:
        """Register this member under /_etcd/machines THROUGH
        consensus (server.go:463-491's publish retry loop): a
        local-replica write would diverge from the other replicas, so
        the registration is an ordinary replicated PUT, retried until
        a leader exists to commit it."""
        from .cluster import (
            ATTRIBUTES_SUFFIX,
            RAFT_ATTRIBUTES_SUFFIX,
            Member,
        )

        m = Member(id=self.id, name=self.name,
                   peer_urls=[self.peer_urls[self.slot]],
                   client_urls=self._client_urls)
        pairs = [
            (m.store_key() + RAFT_ATTRIBUTES_SUFFIX,
             json.dumps(m.raft_attributes.to_dict())),
            (m.store_key() + ATTRIBUTES_SUFFIX,
             json.dumps(m.attributes.to_dict())),
        ]
        while not self.done.is_set():
            try:
                for path, val in pairs:
                    self.do(Request(method="PUT", id=gen_id(),
                                    path=path, val=val), timeout=5.0)
                return
            except Exception:
                self.done.wait(1.0)  # no leader yet; retry

    def stop(self) -> bool:
        """Stop the server.  Returns True on a clean stop; False when
        the round loop failed to exit within the join timeout — the
        WAL is then left open (a closed WAL would raise mid-save when
        the loop unwedges) and the data dir MUST NOT be reused by a
        new server in this process until the loop actually exits."""
        self.done.set()
        self._queue.put(None)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()  # release the port for rebinds
        loop_exited = True
        if self._thread is not None \
                and self._thread is not threading.current_thread():
            self._thread.join(timeout=10)
            loop_exited = not self._thread.is_alive()
        if loop_exited:
            self._xchg_pool.shutdown(wait=False)
        # else: a wedged round loop still owns the pool — leave it up
        # so its next _exchange doesn't die on "cannot schedule new
        # futures after shutdown"; _exchange also guards on self.done.
        for chan in list(self._channels.values()):
            chan.close()  # fails in-flight frames; done-guard drops
        self._pool.close()
        self._ri_pool.close()
        self.store.fanout.close()
        _faults.FAULTS.detach_sink(self.flight)
        # a deferred snapshot may still hold _snap_mutex mid-save;
        # join it before closing the WAL (its cut/gc would raise on
        # a closed file).  Same wedge rule as the round loop: if it
        # won't exit, leave the WAL open.
        snap_t = self._snap_thread
        if snap_t is not None and snap_t.is_alive() \
                and snap_t is not threading.current_thread():
            snap_t.join(timeout=10)
            loop_exited = loop_exited and not snap_t.is_alive()
        # same rule for the deferred pull: its install does a WAL
        # save under self.lock (the puller aborts promptly once done
        # is set — the stream's abort hook polls it)
        pull_t = self._pull_thread
        if pull_t is not None and pull_t.is_alive() \
                and pull_t is not threading.current_thread():
            pull_t.join(timeout=10)
            loop_exited = loop_exited and not pull_t.is_alive()
        if loop_exited:
            with self.lock:
                self.wal.close()
        else:
            # the wedged loop may still _persist when it unwedges — a
            # closed WAL would raise mid-save.  Leaving it open is
            # safe for durability (every save() fsyncs, nothing is
            # buffered between saves) but the caller must not reuse
            # the data dir in-process: two appenders would interleave
            # one segment's CRC chain.
            log.warning("dist[%d]: stop(): round loop or deferred "
                        "snapshot still running after join timeout; "
                        "WAL left open — do not reuse this data dir "
                        "in-process", self.slot)
        return loop_exited

    # -- durability helpers (call with self.lock held) --------------------

    def _persist(self, ents: list[Entry],
                 frontier: bool = True) -> None:
        """WAL-append ``ents`` (+ a frontier marker) and fsync.

        An empty save whose frontier has not moved since the last
        recorded one is SKIPPED outright: at the pipeline's adaptive
        cadence the loop runs orders of magnitude more often than the
        lockstep round did, and an unconditional hardstate+frontier
        fsync per iteration would turn idle loops into fsync storms
        (nothing new is durable-worthy when neither entries nor the
        commit vector changed).

        NOSPACE: while the server is in read-only mode an
        empty (frontier-only) save is SKIPPED — the frontier record
        is an optimization (restart replays from an older frontier
        and catches up), never worth failing for on a full disk.  A
        save that DOES fail with ``EtcdNoSpace`` rolls this method's
        own frontier seq allocation back (the WAL already rolled the
        file back; caller-allocated record seqs are the caller's to
        hold or roll back) and re-raises."""
        if self._nospace and not ents:
            return
        seq0 = self.seq
        fr0 = self._fr_last
        if frontier:
            commit = self.mr.commit_index().astype(np.int32)
            unchanged = (self._fr_last is not None
                         and np.array_equal(commit, self._fr_last[0]))
            if unchanged:
                if not ents:
                    return
                # terms AT the commit frontier are immutable while
                # the frontier itself hasn't moved — reuse the cached
                # gather instead of re-dispatching term_at per flush
                terms = self._fr_last[1]
            else:
                terms = self.mr.commit_terms().astype(np.int32)
                # current-term-commit gate for the read path: the
                # lane may serve lease/ReadIndex reads only once its
                # commit frontier carries an entry of the CURRENT
                # term (self._ballot[0] is the durable host copy of
                # term — every term transition persists through
                # _ballot_record before acting).  The floor pins the
                # commit index at the moment the gate first opened:
                # >= anything an earlier leader could have committed.
                ok = terms >= self._ballot[0]
                self._read_floor = np.where(
                    ok & ~self._read_ok, commit.astype(np.int64),
                    self._read_floor)
                self._read_ok = ok
            self._fr_last = (commit, terms)
            self.seq += 1
            ents = ents + [Entry(
                index=self.seq, term=self.raft_term,
                data=GroupEntry(
                    kind=K_FRONTIER,
                    payload=commit.tobytes() + terms.tobytes())
                .marshal())]
        try:
            self.wal.save(HardState(term=self.raft_term, vote=0,
                                    commit=self.seq), ents)
        except EtcdNoSpace:
            self.seq = seq0
            self._fr_last = fr0
            raise

    def _ballot_record(self) -> list[Entry]:
        """Allocate (seq-ordered) the ballot record for a changed
        term/vote, or [] when unchanged.  Allocation happens HERE so
        a caller that prepends this to its entry batch gets one
        seq-contiguous WAL write — out-of-order seqs (a later seq on
        disk before earlier ones reads as an index gap on restart)
        are structurally unrepresentable."""
        st = self.mr.state
        terms = _ledger.fetch("dist.server", st.term).astype(np.int32)
        votes = _ledger.fetch("dist.server", st.vote).astype(np.int32)
        if (np.array_equal(terms, self._ballot[0])
                and np.array_equal(votes, self._ballot[1])):
            return []
        self._ballot = (terms.copy(), votes.copy())
        # a term bump re-closes the read gate until an entry of the
        # new term commits (the fresh-leader stale-commit window)
        self._read_ok = (self._fr_last[1] >= terms
                         if self._fr_last is not None
                         else np.zeros(self.g, bool))
        self.raft_term = max(self.raft_term, int(terms.max()))
        self.seq += 1
        return [Entry(index=self.seq, term=self.raft_term,
                      data=GroupEntry(
                          kind=K_BALLOT,
                          payload=terms.tobytes() + votes.tobytes())
                      .marshal())]

    def _persist_ballot(self) -> None:
        """Durable term/vote BEFORE any vote or campaign leaves this
        host (the HardState analog, wal.go:35-39) — only when it
        actually changed.  ENOSPC rolls the allocation back and
        re-raises: an unpersisted ballot must never back a vote."""
        seq0 = self.seq
        ballot0 = self._ballot
        rec = self._ballot_record()
        if rec:
            try:
                self.wal.save(
                    HardState(term=self.raft_term, vote=0,
                              commit=self.seq), rec)
            except EtcdNoSpace:
                self.seq = seq0
                self._ballot = ballot0
                raise

    def _entry_records(self, gis, base, items) -> list[Entry]:
        """WAL records for entries appended at this host: one flat
        (group, gindex, gterm, payload) table batch-marshaled via
        ``marshal_group_entries`` — no per-record GroupEntry object
        (the record assembly was the propose path's top
        allocation line after the engine fusion)."""
        terms = self.mr.terms()
        groups: list[int] = []
        gindex: list[int] = []
        gterms: list[int] = []
        blobs: list[bytes] = []
        for gi in np.asarray(gis).tolist():
            b0, t = int(base[gi]), int(terms[gi])
            for j, p in enumerate(items[gi]):
                groups.append(gi)
                gindex.append(b0 + 1 + j)
                gterms.append(t)
                blobs.append(p.data)
        return self._note_tail(groups, gindex, self._seal_records(
            marshal_group_entries(K_ENTRY, groups, gindex, gterms,
                                  blobs)))

    def _note_tail(self, groups, gindex, recs: list[Entry]
                   ) -> list[Entry]:
        """Record each entry record's WAL seq under its (group,
        gindex) until the entry is applied; returns ``recs``."""
        tails = self._tail_seqs
        for gi, ix, e in zip(groups, gindex, recs):
            tails[gi].append((ix, e.index))
        return recs

    def _replay_floor(self, snap_seq: int) -> int:
        """The WAL seq a snapshot taken now must replay after: its own
        seq, or one before the oldest entry record persisted here that
        the snapshot's frontier does not cover (an appended entry
        commits after the snapshot captured the frontier; replaying
        only after the snapshot's seq would skip it on restart while a
        later frontier record marks it applied).  Entries already
        applied, or past the log's last index (truncated), are
        dropped from the record (call with self.lock held)."""
        last = _ledger.fetch("dist.server", self.mr.state.last)
        floor = snap_seq
        for gi, dq in enumerate(self._tail_seqs):
            if not dq:
                continue
            lo, hi = self.applied[gi], last[gi]
            keep = [x for x in dq if lo < x[0] <= hi]
            if len(keep) != len(dq):
                self._tail_seqs[gi] = dq = deque(keep)
            if dq:
                floor = min(floor, min(s for _, s in dq) - 1)
        return floor

    def _seal_records(self, datas: list[bytes]) -> list[Entry]:
        """Wrap batch-marshaled GroupEntry blobs in WAL Entries with
        one vectorized seq allocation."""
        self.seq += len(datas)
        seq0 = self.seq - len(datas)
        rt = self.raft_term
        return [Entry(index=seq0 + 1 + i, term=rt, data=d)
                for i, d in enumerate(datas)]

    def _frame_entry_records(self, msg: AppendBatch,
                             appended) -> list[Entry]:
        """WAL records for the entries an inbound frame appended.
        A packed frame (FLAG_PACKED) drives ONE flat pass over the
        validated entry table — mask by the accepting lanes, batch-
        marshal, done; the unpacked fallback walks per group."""
        if (msg.ent_group is not None
                and isinstance(msg.payloads, PackedPayloads)):
            groups = np.asarray(msg.ent_group)
            keep = np.nonzero(np.asarray(appended)[groups])[0]
            if not keep.size:
                return []
            gl = groups[keep]
            il = np.asarray(msg.ent_gindex)[keep]
            # ent_terms[g, j] with j = gindex - prev_idx[g] - 1;
            # in-range by the unmarshal-time table validation
            j = il - np.asarray(msg.prev_idx)[gl] - 1
            gterms = np.asarray(msg.ent_terms)[gl, j]
            flat = msg.payloads.flat
            gl, il = gl.tolist(), il.tolist()
            return self._note_tail(gl, il, self._seal_records(
                marshal_group_entries(
                    K_ENTRY, gl, il, gterms.tolist(),
                    [flat[k] for k in keep.tolist()])))
        groups = []
        gindex = []
        gterms = []
        blobs = []
        for gi in np.nonzero(appended)[0].tolist():
            p0 = int(msg.prev_idx[gi])
            row = msg.payloads[gi]
            for j in range(int(msg.n_ents[gi])):
                groups.append(gi)
                gindex.append(p0 + 1 + j)
                gterms.append(int(msg.ent_terms[gi, j]))
                blobs.append(row[j])
        return self._note_tail(groups, gindex, self._seal_records(
            marshal_group_entries(K_ENTRY, groups, gindex, gterms,
                                  blobs)))

    # -- peer RPC (HTTP handler entry points) -----------------------------

    def handle_frame(self, data: bytes) -> bytes:
        """POST /mraft: one batched consensus frame in, the response
        frame out.  Everything this host learned is durable before
        the response bytes leave (Ready contract ordering)."""
        t_recv = time.monotonic()
        with tracer.stage("dist.frame_unmarshal"):
            msg = unmarshal_any(data)
        # inbound half of an asymmetric partition: the
        # [src->dst]-qualified peerlink.recv failpoint — a dropped
        # frame never touches engine state and gets NO response (the
        # handler closes the connection; to the sender it is a lost
        # message)
        sender = getattr(msg, "sender", None)
        try:
            act = _faults.hit(
                "peerlink.recv",
                src=self._peer_labels.get(sender),
                dst=self._self_label)
        except OSError as e:
            raise FrameDropped() from e
        if act == _faults.DROP:
            raise FrameDropped()
        traced = (isinstance(msg, AppendBatch) and msg.trace) or None
        if traced:
            # the receive edge of the stitcher's clock-alignment
            # pair, stamped BEFORE the lock (symmetric with the
            # leader's off-lock socket-write/ack stamps)
            self.flight.record(
                "frame", t=t_recv, dir="recv", src=msg.sender,
                seq=msg.seq, traces=[[t[2], t[3]] for t in traced])
        with self.lock, tracer.span("dist.handle_frame"):
            if self.done.is_set():
                # stop() closes the WAL under this lock with done
                # already set — refuse the frame BEFORE mutating
                # engine state (the handler turns this into a quiet
                # 503; the sender treats it as transport failure and
                # probes on reconnect)
                raise ServerStoppedError()
            if self._nospace:
                # read-only: appended entries could not be persisted
                # and votes could not record a durable ballot — both
                # are refused BEFORE any engine mutation (the
                # handler answers 507; the sender probes and the
                # at-least-once redelivery rebuilds everything once
                # space returns)
                raise EtcdNoSpace(
                    cause="member is read-only (NOSPACE)")
            if isinstance(msg, AppendBatch):
                self.server_stats.recv_append()
                with tracer.stage("dist.handle_append"), \
                        _ledger.dispatch("dist.handle_append"):
                    resp = self.mr.handle_append(msg)
                # the ballot record (if the term changed in this
                # frame) leads the batch: _ballot_record allocates
                # seqs in order, so one seq-contiguous WAL write
                # carries ballot + entries (a later seq on disk
                # before earlier ones reads as an index gap on the
                # next restart — found by the chaos drill)
                seq0 = self.seq
                ballot0 = self._ballot
                with tracer.stage("dist.frame_records"):
                    recs = self._ballot_record()
                    recs.extend(self._frame_entry_records(
                        msg, resp.appended))
                try:
                    with tracer.stage("dist.frame_persist"):
                        self._persist(recs)
                except EtcdNoSpace:
                    # full disk mid-frame: the engine appended but
                    # nothing hit the WAL (file rolled back).  Roll
                    # the seq/ballot allocations back, go read-only,
                    # and give the sender NO ack — its at-least-once
                    # redelivery re-persists these entries after
                    # recovery (duplicate engine appends are no-ops,
                    # duplicate WAL records dedup at replay).
                    self.seq = seq0
                    self._ballot = ballot0
                    self._enter_nospace("handle_frame persist")
                    raise
                if traced:
                    # one fsync covered the whole batch: every traced
                    # entry whose lane actually appended is durable
                    # on this follower as of NOW.  Lane index is
                    # bounds-checked — a malformed trace block must
                    # degrade to a missing span, never a handler 500.
                    t_sync = time.monotonic()
                    appended = resp.appended
                    for g_, gi_, tid, org in traced:
                        if appended is not None \
                                and 0 <= g_ < self.g \
                                and appended[g_]:
                            self.flight.span(tid, org,
                                             "follower_fsync",
                                             t=t_sync, host=self.slot)
                if bool(np.any(msg.need_snap & msg.active)):
                    if log.isEnabledFor(logging.DEBUG):
                        log.debug("dist[%d]: need_snap frame from %d "
                                  "lanes=%s", self.slot, msg.sender,
                                  np.nonzero(msg.need_snap
                                             & msg.active)[0].tolist())
                    self._need_pull = True
                with tracer.stage("dist.frame_apply"):
                    self._apply_committed()
                # echo the pipeline tags: the leader matches this ack
                # to its in-flight frame by (epoch, seq)
                resp.seq, resp.epoch = msg.seq, msg.epoch
                with tracer.stage("dist.frame_marshal_resp"):
                    out = resp.marshal()
                if traced:
                    self.flight.record("frame", dir="resp",
                                       src=msg.sender, seq=msg.seq)
                return out
            if isinstance(msg, VoteReq):
                resp = self.mr.handle_vote(msg)
                try:
                    self._persist_ballot()
                except EtcdNoSpace:
                    # the grant is NOT durable: never send it (a
                    # vote that could be forgotten across a restart
                    # is a double-vote waiting to happen) — go
                    # read-only and give the candidate nothing
                    self._enter_nospace("vote persist")
                    raise
                return resp.marshal()
        raise ValueError(f"unhandled frame {type(msg).__name__}")

    def handle_forward(self, data: bytes,
                       timeout: float) -> Response:
        """POST /mraft/propose: a follower-forwarded client write."""
        r = Request.unmarshal(data)
        return self.do(r, timeout=timeout, forward=False)

    def _snapshot_dict(self) -> dict:
        """The snapshot payload fields (call with self.lock held)."""
        return {
            "store": self.store.save().decode(),
            "frontier": [int(x) for x in self.applied],
            "terms": [int(x) for x in
                      self.mr.terms_at(self.applied).astype(int)],
            "seq": self.seq,
            "applied_total": self.raft_index,
            # per-group live-membership at the frontier:
            # conf changes below it need no entry replay
            "members": _ledger.fetch("dist.server", self.mr.state.members)
            .astype(int).tolist(),
        }

    def snapshot_blob(self) -> bytes:
        """GET /mraft/snapshot: the current store + frontier (what a
        lagging follower installs; kept as the legacy monolithic
        endpoint — diagnostics and the drill's frontier probe use
        it)."""
        with self.lock:
            d = self._snapshot_dict()
        return json.dumps(d).encode()

    def snapshot_frontier(self) -> bytes:
        """GET /mraft/snapshot/frontier: the applied vector alone —
        the receiver's cheap pre-pin dominance probe.  A meta pin
        serializes + CRC-chains the whole store under the lock and
        holds the blob pinned for the cache TTL; a donor that cannot
        dominate must never be made to pay that."""
        with self.lock:
            frontier = [int(x) for x in self.applied]
        # cheap size hint so the receiver can scale its meta-fetch
        # timeout with the donor's store size (the pin serializes a
        # blob of the same order as the newest durable snapshot; a
        # FIXED meta timeout wedges every pull of a store big enough
        # to out-serialize it — the chunk deadline is size-scaled
        # for the same reason)
        approx = 0
        try:
            newest = self.ss._snap_names()[0]
            approx = os.path.getsize(os.path.join(self.ss.dir, newest))
        except (NoSnapshotError, OSError):
            pass
        return json.dumps({"frontier": frontier,
                           "approx_bytes": approx}).encode()

    def snapshot_stream_meta(self) -> bytes:
        """POST /mraft/snapshot/meta: pin a fresh snapshot
        serialization and return its stream header (id, chunk CRC
        chain, frontier).  Each pull pins its own immutable byte
        stream — the live store mutates continuously, and chunk k
        and k+1 must come from ONE serialization."""
        with self.lock:
            d = self._snapshot_dict()
        payload = json.dumps(d).encode()
        extra = {k: d[k] for k in ("frontier", "terms", "seq",
                                   "applied_total", "members")}
        src = self._snap_sources.pin(
            SnapshotSource(payload, extra=extra))
        log.info("dist[%d]: pinned snapshot stream %s (%d bytes, "
                 "%d chunks)", self.slot, src.id, len(payload),
                 src.n_chunks)
        return json.dumps(src.meta()).encode()

    def snapshot_stream_chunk(self, body: bytes) -> tuple[int, bytes]:
        """POST /mraft/snapshot/chunk: serve one chunk of a pinned
        stream.  404 for an unknown/expired pin (the receiver
        refetches meta), 416 for an out-of-range index."""
        try:
            sid, k_s = body.decode().split()
            k = int(k_s)
        except ValueError:
            return 400, b""
        src = self._snap_sources.get(sid)
        if src is None:
            return 404, b""
        if not (0 <= k < src.n_chunks):
            return 416, b""
        data = src.chunk(k)
        # donor-side failpoint: the generalized form of the
        # one-shot env corruption hook below
        try:
            act = _faults.hit("snapstream.serve",
                              src=f"s{self.slot}")
        except OSError:
            return 500, b""
        if act == _faults.DROP:
            return 503, b""
        if act == _faults.CORRUPT:
            data = _faults.flip_byte(data)
        if k == self._corrupt_chunk and not self._corrupted_once:
            # test hook: one corrupted serve, then clean — the
            # receiver must reject on the rolling CRC and refetch
            self._corrupted_once = True
            data = bytes(data[:-1]) + bytes([data[-1] ^ 0xFF])
            log.warning("dist[%d]: TEST HOOK corrupted snapshot "
                        "chunk %d on first serve", self.slot, k)
        return 200, data

    # -- client path ------------------------------------------------------

    # -- the write path's three verbs, shared by do()/do_many() -----------

    _WRITE_METHODS = ("POST", "PUT", "DELETE", "QGET", "CONFCHANGE")

    def _enqueue_write(self, r: Request, lead: np.ndarray):
        """Validate + register + enqueue one consensus-bound request.

        Returns ``("ch", ch)`` with the registered waiter channel,
        ``("not_leader", gi)`` when another host leads the group, or
        ``("err", exc)`` for an invalid request — the single copy of
        the write-side validation both do() and do_many() decode."""
        if r.id == 0:
            return "err", ValueError("r.id cannot be 0")
        if self._nospace:
            # NOSPACE read-only mode: every write (including a
            # would-be forward — this member's replica cannot apply
            # while it refuses frames, so read-your-write through it
            # would dangle) is rejected with the distinct code
            return "err", EtcdNoSpace(
                cause="member is read-only (NOSPACE)")
        if r.method == "GET" and r.quorum:
            r.method = "QGET"
        if r.method not in self._WRITE_METHODS:
            return "err", UnknownMethodError(r.method)
        try:
            gi = self._group_of_request(r)
        except ValueError as e:
            return "err", e
        if not lead[gi]:
            return "not_leader", gi
        ch = self.w.register(r.id)
        # head sampling at client ingest: the trace context is born
        # HERE and rides the _Pending through the coalescer, the
        # engine append, the DGB2 frames and the apply/ack path
        tid = self.flight.sample_trace()
        if tid is not None:
            self.flight.span(tid, self.slot, "ingest", group=gi)
        self._queue.put(_Pending(req=r, data=r.marshal(), id=r.id,
                                 group=gi, trace=tid))
        return "ch", ch

    def _await_ack(self, rid: int, ch,
                   timeout: float | None) -> Response | Exception:
        """Decode one waiter channel into a Response or the failure
        Exception (never raises — do() re-raises, do_many collects)."""
        try:
            x = ch.get(timeout=timeout)
        except queue.Empty:
            self.w.trigger(rid, None)
            return TimeoutError("request timed out")
        if x is None:
            return (ServerStoppedError() if self.done.is_set()
                    else TimeoutError("request dropped (no leader)"))
        if x.err is not None:
            return x.err
        return x

    def do(self, r: Request, timeout: float | None = None,
           forward: bool = True) -> Response:
        """Reference Do() semantics (server.go:337-380): writes and
        quorum reads through the group's consensus (forwarded to the
        leader host when that is not us); plain reads and watches
        from the local replica."""
        if r.method in self._WRITE_METHODS or \
                (r.method == "GET" and r.quorum):
            kind, v = self._enqueue_write(r, self.mr.is_leader())
            if kind == "err":
                raise v
            if kind == "not_leader":
                if not forward:
                    raise TimeoutError("not leader (no re-forward)")
                return self._forward(v, r.marshal(), timeout)
            x = self._await_ack(r.id, v, timeout)
            if isinstance(x, Exception):
                raise x
            return x
        if r.id == 0:
            raise ValueError("r.id cannot be 0")
        if r.method == "GET":
            if r.wait:
                wc = self.store.watch(r.path, r.recursive, r.stream,
                                      r.since)
                return Response(watcher=wc)
            if r.serializable:
                # explicit opt-out: the pre-PR-7 local-replica read,
                # possibly stale under partition — counted so bench
                # forensics can attribute it
                self._count_read(PATH_SERIALIZABLE, "ok")
                ev = self.store.get(r.path, r.recursive, r.sorted)
                return Response(event=ev)
            return self._linz_read(r, timeout)
        raise UnknownMethodError(r.method)

    def do_many(self, reqs: list[Request],
                timeout: float | None = None) -> list:
        """Pipelined batch of write requests: register + enqueue ALL
        of them, then collect acks — the proposals ride whatever
        replication rounds commit them, so one caller keeps many
        writes in flight instead of one lock-step write per
        round-trip.  The reference gets the same effect from many
        concurrent HTTP clients (README.md:20 "benchmarked 1000s of
        writes/s"); here it is also a first-class batch API, the
        transport behind POST /mraft/propose_many.

        Returns a list aligned with ``reqs``: a Response where the
        write committed+applied, an Exception where it failed (the
        batch is NOT atomic — each entry commits independently)."""
        lead = self.mr.is_leader()
        chans: list[tuple[int, int, object]] = []
        out: list = [None] * len(reqs)
        seen: set[int] = set()
        for i, r in enumerate(reqs):
            if r.id in seen:
                # duplicate ids within one batch would share a waiter
                # channel and the second entry would read a false
                # failure — reject it up front
                out[i] = ValueError(f"duplicate id {r.id} in batch")
                continue
            seen.add(r.id)
            kind, v = self._enqueue_write(r, lead)
            if kind == "err":
                out[i] = v
            elif kind == "not_leader":
                out[i] = TimeoutError("not leader")
            else:
                chans.append((i, r.id, v))
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        for i, rid, ch in chans:
            left = (None if deadline is None
                    else max(0.0, deadline - time.monotonic()))
            out[i] = self._await_ack(rid, ch, left)
        return out

    # -- linearizable read path ------------------------------------

    def _count_read(self, path: str, outcome: str, n: int = 1,
                    t0: float | None = None) -> None:
        """Serve accounting: the labeled counter (handle cached — a
        registry lookup per GET would cost a lock + key build), the
        store-stats per-path split on successful serves, and the
        register->serve RTT histogram."""
        key = (path, outcome)
        c = self._read_ctrs.get(key)
        if c is None:
            c = self._read_ctrs[key] = serve_counter(path, outcome)
        c.inc(n)
        if outcome == "ok":
            self.store.stats.inc_read_path(path, n)
        else:
            # every fail-closed read's CAUSE lands in the flight ring
            # (the linz drill's "why did reads reject" forensics)
            self.flight.record("read_fail", path=path,
                               outcome=outcome, n=n)
        if t0 is not None:
            dt = time.monotonic() - t0
            self._m_read_rtt.observe(dt)
            if dt > self.flight.slow_s:
                self.flight.record("tail", kind="slow_read",
                                   path=path, n=n,
                                   rtt_ms=round(dt * 1e3, 2))

    def _group_cached(self, path: str) -> int:
        """group_of with the namespace cache (read hot path)."""
        ns = path.strip("/").split("/", 1)[0]
        gi = self._ns_groups.get(ns)
        if gi is None:
            if len(self._ns_groups) >= 65536:
                self._ns_groups.clear()
            gi = self._ns_groups[ns] = group_of(path, self.g)
        return gi

    def _lease_fast_ok(self, gi: int, now: float) -> bool:
        """One group's lease check (call with self.lock held): the
        lane is led with a current-term commit applied, and a quorum
        endorsed this leadership within the lease window — the read
        serves NOW, no quorum round, no WAL."""
        if self._lease_s <= 0:
            return False
        if not self._read_ok[gi] \
                or self.applied[gi] < self._read_floor[gi]:
            return False
        b = self.lease.basis_one(gi, self._members_np,
                                 self._nmembers_np, now)
        return b + self._lease_s > now

    def _read_release(self, now: float | None = None) -> None:
        """Batched ReadIndex release sweep (call with self.lock
        held): ONE [G] quorum-basis computation confirms every
        pending read whose registration a completed quorum round (or
        a valid lease) now covers.  Rides the ack-absorb and round
        paths, so confirmation piggybacks on frames that were going
        out anyway."""
        if not self._reads.pending:
            return
        if now is None:
            now = time.monotonic()
        basis = self.lease.basis(self._members_np,
                                 self._nmembers_np, now)
        released = self._reads.release(
            lead=self._prev_lead, read_ok=self._read_ok,
            applied=self.applied, floor=self._read_floor,
            basis=basis, lease_until=basis + self._lease_s, now=now)
        if released:
            # weight by the reads riding each registration: a
            # read_many batch shares one channel per group
            self._m_ri_batch.observe(
                sum(pr.n for pr, _path, _rd in released))
            for pr, path, rd in released:
                pr.ch.close((path, rd))

    def _nudge_reads(self, now: float) -> None:
        """A read registered without lease cover (call with
        self.lock held): arm one out-of-cadence heartbeat per
        stripe (see _pump_peer) and poke the round loop so the
        confirmation round leaves promptly instead of at the next
        tick boundary.  The poke dedups at 1 ms so a single-read
        burst during a leaderless window can't flood the queue with
        wakes (each registered read would otherwise add one)."""
        if now - self._read_nudge_t > 0.001:
            self._queue.put(None)  # drain treats None as a bare wake
        self._read_nudge_t = now

    def _await_read(self, ch: Chan, timeout: float | None,
                    path_hint: str, t0: float):
        """Block on a registered read's channel; returns the
        ``(path, rd)`` confirmation or raises the fail-closed
        error."""
        try:
            x = ch.get(timeout=timeout)
        except queue.Empty:
            self._count_read(path_hint, "timeout")
            raise TimeoutError(
                "linearizable read timed out (no quorum "
                "confirmation)") from None
        if x is _EXPIRED:
            # the server-side expiry sweep dropped us (pathological
            # confirmation stall) — its own outcome label, NOT
            # not_leader: leadership may be fine
            self._count_read(path_hint, "expired")
            raise TimeoutError(
                "linearizable read expired server-side awaiting "
                "confirmation")
        if x is None:
            if self.done.is_set():
                self._count_read(path_hint, "stopped")
                raise ServerStoppedError()
            self._count_read(path_hint, "not_leader")
            raise TimeoutError(
                "leadership lost before the read confirmed")
        return x

    def _linz_read(self, r: Request,
                   timeout: float | None) -> Response:
        """Default-consistency GET: linearizable without touching
        the WAL.  Leader lanes serve under the lease (zero extra
        messages) or via the batched ReadIndex queue; follower lanes
        fetch a confirmed index from the leader and park on a local
        commit-index wait-point.  Every failure path is CLOSED — a
        read is never served from state a quorum may have
        overwritten."""
        t0 = time.monotonic()
        gi = self._group_cached(r.path)
        ch = None
        path = "lease"
        with self.lock:
            if self.done.is_set():
                raise ServerStoppedError()
            led = bool(self._prev_lead[gi])
            if led:
                if not self._lease_fast_ok(gi, t0):
                    ch = Chan()
                    self._reads.register(gi, t0,
                                         int(self.applied[gi]), ch)
                    self._nudge_reads(t0)
            else:
                leader = int(self._hint_np[gi])
        if not led:
            return self._follower_read(r, gi, leader, t0, timeout)
        if ch is not None:
            path = self._await_read(ch, timeout, "read_index", t0)[0]
        self._count_read(path, "ok", t0=t0)
        ev = self.store.get(r.path, r.recursive, r.sorted)
        return Response(event=ev)

    def _follower_read(self, r: Request, gi: int, leader: int,
                       t0: float,
                       timeout: float | None) -> Response:
        """Follower half: leader-confirmed read index + local apply
        wait-point, then serve from THIS replica (read traffic never
        ships the value over the peer tier, only the index)."""
        if leader < 0 or leader == self.slot:
            self._count_read("follower_wait", "no_leader")
            raise TimeoutError(
                "no leader known for linearizable read")
        rd = self._fetch_read_index(leader, gi)
        ch = None
        with self.lock:
            if self.done.is_set():
                raise ServerStoppedError()
            if self.applied[gi] < rd:
                ch = Chan()
                self._waits.register(gi, rd, ch,
                                     t0=time.monotonic())
        if ch is not None:
            try:
                x = ch.get(timeout=timeout)
            except queue.Empty:
                self._count_read("follower_wait", "timeout")
                raise TimeoutError(
                    "linearizable read timed out awaiting "
                    "replication") from None
            if x is _EXPIRED:
                self._count_read("follower_wait", "expired")
                raise TimeoutError(
                    "linearizable read expired awaiting "
                    "replication")
            if x is None:
                self._count_read("follower_wait", "stopped")
                raise ServerStoppedError()
        self._count_read("follower_wait", "ok", t0=t0)
        ev = self.store.get(r.path, r.recursive, r.sorted)
        return Response(event=ev)

    def _fetch_read_index(self, leader: int, gi: int) -> int:
        """POST /mraft/readindex to the group's leader over the
        DEDICATED read-index keep-alive pool (``_ri_pool`` — its
        socket timeout clears the leader's lawful 5s confirmation
        hold, which the shared pool's 1-2s timeout would misread as
        an unreachable leader); returns the confirmed index or
        raises (fail closed)."""
        body = json.dumps({"group": int(gi)}).encode()
        out = self._ri_pool.post(leader, self.peer_urls[leader],
                                 READ_INDEX_PATH, body)
        if out is None or out[0] != 200:
            self._count_read("follower_wait", "no_leader")
            raise TimeoutError("read-index fetch failed "
                               "(leader unreachable)")
        try:
            d = json.loads(out[1].decode())
            if "rd" not in d:
                self._count_read("follower_wait", "not_leader")
                raise TimeoutError(
                    f"read-index refused: {d.get('err')}")
            return int(d["rd"])
        except (ValueError, TypeError):
            self._count_read("follower_wait", "no_leader")
            raise TimeoutError(
                "read-index reply unparseable") from None

    def read_index(self, gi: int,
                   timeout: float | None = None) -> int:
        """Leader service behind POST /mraft/readindex: an apply
        index ``rd`` such that any replica serving at local
        ``applied >= rd`` observes every write acked before this
        call — the lease answers instantly, otherwise the request
        joins the batched ReadIndex queue like any local read."""
        if not (0 <= gi < self.g):
            raise ValueError(f"group {gi} out of range 0..{self.g}")
        t0 = time.monotonic()
        with self.lock:
            if self.done.is_set():
                raise ServerStoppedError()
            if not self._prev_lead[gi]:
                raise TimeoutError("not leader")
            if self._lease_fast_ok(gi, t0):
                return max(int(self.applied[gi]),
                           int(self._read_floor[gi]))
            ch = Chan()
            self._reads.register(gi, t0, int(self.applied[gi]), ch,
                                 kind="rd")
            self._nudge_reads(t0)
        return int(self._await_read(ch, timeout, "read_index",
                                    t0)[1])

    def _serve_read(self, path: str, r: Request | None):
        """One local store serve; EtcdError (e.g. key-not-found) is
        a per-entry result, not a batch failure.  Path-string
        entries (the compact get_many form) come back as the raw
        leaf VALUE via the store's Event-free fast lane — at the
        batch lane's read rates the Event allocation is the
        dominant per-read cost."""
        try:
            if r is None:
                return self.store.get_value(path)
            return Response(event=self.store.get(
                path, r.recursive, r.sorted))
        except EtcdError as e:
            return e

    def read_many(self, reqs: list,
                  timeout: float | None = None) -> list:
        """Batched read path (the GET analog of do_many, behind
        POST /mraft/get_many).  Entries are plain path strings (the
        compact wire form — a linearizable read's cost should be
        its key, not a protobuf decode) or full GET Requests.

        The hot shape is one lock take for the whole batch: lanes
        whose lease vouches serve via a per-group cached lease
        check — no per-read channel, no queue — and the rest
        register and ride ONE release sweep, so a whole batch
        confirms against one [G] basis compare (the amortization
        etcd_read_index_batch_size records).  Follower lanes share
        one read-index fetch per group.  Returns a list aligned
        with ``reqs``: Response or Exception per entry."""
        out: list = [None] * len(reqs)
        t0 = time.monotonic()
        linz: list[tuple[int, str, Request | None]] = []
        for i, r in enumerate(reqs):
            if isinstance(r, str):
                linz.append((i, r, None))
            elif r.method != "GET" or r.wait or r.quorum:
                # quorum (through-the-log) reads and non-reads take
                # their own paths; the batch endpoint is the
                # zero-WAL lane
                out[i] = UnknownMethodError(
                    f"get_many accepts plain GETs, not "
                    f"{r.method}{'?quorum' if r.quorum else ''}")
            elif r.serializable:
                out[i] = _SERZ
            else:
                linz.append((i, r.path, r))
        fast: list[tuple[int, str, Request | None]] = []
        # ONE Chan + ONE queue registration per GROUP, not per read:
        # the group's confirmation covers every read that registered
        # under it, and the stage tables flagged the per-read Chan
        # as the register loop's top allocation
        group_chans: dict[int, tuple[Chan, object, list]] = {}
        followers: dict[int,
                        list[tuple[int, str, Request | None]]] = {}
        if linz:
            with self.lock:
                if self.done.is_set():
                    raise ServerStoppedError()
                now = time.monotonic()
                lease_cache: dict[int, bool] = {}
                for i, path, r in linz:
                    gi = self._group_cached(path)
                    ok = lease_cache.get(gi)
                    if ok is None:
                        ok = bool(self._prev_lead[gi]) \
                            and self._lease_fast_ok(gi, now)
                        lease_cache[gi] = ok
                    if ok:
                        fast.append((i, path, r))
                    elif self._prev_lead[gi]:
                        ent = group_chans.get(gi)
                        if ent is None:
                            ch = Chan()
                            pr = self._reads.register(
                                gi, t0, int(self.applied[gi]), ch)
                            ent = group_chans[gi] = (ch, pr, [])
                        else:
                            ent[1].n += 1
                        ent[2].append((i, path, r))
                    else:
                        followers.setdefault(gi, []).append(
                            (i, path, r))
                if fast:
                    # the batch IS a confirmation sweep: one lease
                    # check per group released this many reads
                    self._m_ri_batch.observe(len(fast))
                if group_chans:
                    self._read_release(now)
                    if self._reads.pending:
                        self._nudge_reads(now)
        if fast:
            self._count_read("lease", "ok", n=len(fast))
            # batch-granular RTT sample: every read in the batch
            # shared this register->serve window
            self._m_read_rtt.observe(time.monotonic() - t0)
            plain = [(i, path) for i, path, r in fast if r is None]
            if plain:
                # one world-lock take + one stats update for the
                # whole compact batch
                for (i, _p), v in zip(plain, self.store.get_values(
                        [p for _i, p in plain])):
                    out[i] = v
            for i, path, r in fast:
                if r is not None:
                    out[i] = self._serve_read(path, r)
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        served: dict[str, int] = {}
        for _gi, (ch, _pr, items) in group_chans.items():
            left = (None if deadline is None
                    else max(0.0, deadline - time.monotonic()))
            try:
                p = self._await_read(ch, left, "read_index", t0)[0]
            except (TimeoutError, ServerStoppedError) as e:
                for i, _path, _r in items:
                    out[i] = e
                continue
            # the group's one confirmation covers its whole batch
            served[p] = served.get(p, 0) + len(items)
            for i, path, r in items:
                out[i] = self._serve_read(path, r)
        for p, n in served.items():
            self._count_read(p, "ok", n=n)
        if served:
            self._m_read_rtt.observe(time.monotonic() - t0)
        for i, r in ((i, r) for i, r in enumerate(reqs)
                     if out[i] is _SERZ):
            self._count_read(PATH_SERIALIZABLE, "ok")
            out[i] = self._serve_read(r.path, r)
        def _one_follower_group(gi: int, items) -> None:
            left = (None if deadline is None
                    else max(0.0, deadline - time.monotonic()))
            i0, path0, r0 = items[0]
            try:
                out[i0] = self._follower_read(
                    r0 if r0 is not None
                    else Request(method="GET", id=1, path=path0),
                    gi, int(self._hint_np[gi]), t0, left)
                # the confirmed wait already covers the rest of the
                # group's batch: serve them straight off the replica
                if len(items) > 1:
                    self._count_read("follower_wait", "ok",
                                     n=len(items) - 1)
                    for i, path, r in items[1:]:
                        out[i] = self._serve_read(path, r)
            except (TimeoutError, ServerStoppedError) as e:
                for i, _path, _r in items:
                    out[i] = e

        if len(followers) == 1:
            gi, items = next(iter(followers.items()))
            _one_follower_group(gi, items)
        elif followers:
            # groups are independent (one index fetch + wait each):
            # run them concurrently so batch latency is the SLOWEST
            # group's confirmation, not the sum over groups — each
            # group writes disjoint out[] slots
            ths = [threading.Thread(target=_one_follower_group,
                                    args=(gi, items))
                   for gi, items in followers.items()]
            for th in ths:
                th.start()
            for th in ths:
                th.join()
        return out

    def _group_of_request(self, r: Request) -> int:
        """Explicit group for engine-targeted entries (a CONFCHANGE's
        path encodes its group — hashing it like a client path would
        route the change to the wrong group's log); namespace hash
        for everything else."""
        if r.method == "CONFCHANGE":
            try:
                gi = int(r.path.rsplit("/", 1)[-1])
            except ValueError:
                raise ValueError(
                    f"malformed CONFCHANGE path {r.path!r}") from None
            if not (0 <= gi < self.g):
                # negative values would silently wrap to another
                # group's log via sequence indexing
                raise ValueError(
                    f"CONFCHANGE group {gi} out of range 0..{self.g}")
            return gi
        return group_of(r.path, self.g)

    def _forward(self, gi: int, data: bytes,
                 timeout: float | None) -> Response:
        """Forward a write to the group's leader host and surface its
        result as a store re-read (the event applied there reaches
        our replica via replication; the authoritative response body
        is re-served locally once our replica catches up)."""
        lead = int(self.mr.leader_hint()[gi])
        if lead < 0 or lead == self.slot:
            raise TimeoutError("no leader for group")
        url = self.peer_urls[lead] + "/mraft/propose"
        req = urllib.request.Request(
            url, data=data, method="POST",
            headers={"Content-Type": "application/octet-stream"})
        try:
            with urllib.request.urlopen(
                    req, timeout=timeout or 5.0,
                    context=self._peer_ssl_cli) as resp:
                body = resp.read()
        except (urllib.error.URLError, OSError) as e:
            raise TimeoutError(f"forward failed: {e}") from None
        d = json.loads(body.decode())
        if not d.get("ok"):
            from ..utils.errors import EtcdError

            raise EtcdError(d.get("errorCode", 300),
                            d.get("message", "forwarded propose "
                                             "failed"), d.get("cause"))
        from ..store.event import Event

        return Response(event=Event.from_dict(d["event"])
                        if d.get("event") else None)

    # -- the round loop ---------------------------------------------------

    def run(self) -> None:
        next_tick = time.monotonic() + self.tick_interval
        next_sync = time.monotonic() + self.sync_interval
        batch: list[_Pending] = []
        next_beat = 0.0  # ETCD_DEBUG_ELECTIONS liveness heartbeat
        while not self.done.is_set():
            if self._debug_elections and \
                    time.monotonic() >= next_beat:
                next_beat = time.monotonic() + 2.0
                st = self.mr.state
                log.info(
                    "dist[%d]: beat roles=%s elapsed=%s timeout=%s "
                    "lead=%s term=%s commit=%s last=%s offset=%s "
                    "next=%s match=%s", self.slot,
                    _ledger.fetch("dist.server", st.role)[:8].tolist(),
                    _ledger.fetch("dist.server", st.elapsed)[:8].tolist(),
                    _ledger.fetch("dist.server", st.timeout)[:8].tolist(),
                    _ledger.fetch("dist.server", st.lead)[:8].tolist(),
                    _ledger.fetch("dist.server", st.term)[:8].tolist(),
                    _ledger.fetch("dist.server", st.commit)[:8].tolist(),
                    _ledger.fetch("dist.server", st.last)[:8].tolist(),
                    _ledger.fetch("dist.server", st.offset)[:8].tolist(),
                    _ledger.fetch("dist.server", st.next_)[:4].tolist(),
                    _ledger.fetch("dist.server", st.match)[:4].tolist())
            batch = self._drain(timeout=min(
                self.tick_interval,
                max(next_tick - time.monotonic(), 0.001)))
            if self.done.is_set():
                break
            now = time.monotonic()
            if now >= next_sync:
                # TTL expiry must be REPLICATED, not leader-local: a
                # follower's replica would otherwise keep expired
                # keys forever.  The reference's leader SYNC proposal
                # (server.go:438-456) rides group 0's log here; every
                # host expires at that entry's apply.  (Cross-group
                # apply order is not globally serialized, so expiry
                # interleaving vs OTHER groups' writes can differ per
                # host by up to one sync interval — the co-hosted
                # server documents the same class of divergence.)
                if self.mr.is_leader()[0] and not self._nospace:
                    r = Request(method="SYNC", id=gen_id(),
                                time=int(time.time() * 1e9))
                    self._queue.put(_Pending(req=r, data=r.marshal(),
                                             id=r.id, group=0))
                next_sync = now + self.sync_interval
            if now >= next_tick:
                # WALL-CLOCK ticking: when a loop iteration overran
                # (CPU contention, a slow exchange), credit every
                # missed tick instead of silently dropping it — a
                # counted-ticks timer stretches the 1-2s election
                # timeout to tens of seconds under load (observed as
                # 15s leaderless windows in the batch chaos drill).
                # The reference's timers are real-time (server.go:182
                # time.Ticker).  Burst bounded: past 4x the worst-case
                # timeout nothing new can fire.
                behind = min(int((now - next_tick)
                                 / self.tick_interval) + 1,
                             8 * self.mr.election)
                next_tick += behind * self.tick_interval
                if next_tick < now:  # deep pause: resync the phase
                    next_tick = now + self.tick_interval
                with self.lock:
                    fire = self.mr.tick()
                    for _ in range(behind - 1):
                        fire = fire | self.mr.tick()
                    # a follower hearing appends has elapsed reset;
                    # lanes that fire lost their leader
                if fire.any():
                    self._campaign(fire)
            if self._nospace \
                    and time.monotonic() >= self._nospace_probe_t:
                self._nospace_recover()
            with self.lock:
                # handle_frame sets the flag under the lock; an
                # unlocked test-and-clear here could lose a pull
                # request that lands between the read and the write.
                # The backoff gate (_arm_pull_retry) spaces attempts
                # after failures — the flag itself is NEVER dropped
                # on failure, only deferred.
                need_pull = (self._need_pull
                             and time.monotonic()
                             >= self._pull_not_before
                             and (self._pull_thread is None
                                  or not self._pull_thread.is_alive()))
                if need_pull:
                    self._need_pull = False
            if need_pull:
                # off the round loop (same rule as the deferred
                # snapshot below): the meta fetch + chunk stream of a
                # big store block for minutes, and this thread is the
                # tick/heartbeat source — an inline pull would cost
                # leadership of every lane this host still leads
                self._pull_thread = threading.Thread(
                    target=self._pull_snapshot_bg,
                    name=f"dist{self.slot}-pull", daemon=True)
                self._pull_thread.start()
            self._leader_round(batch)
            # follower wait-point expiry lives HERE, not in
            # _leader_round: a pure follower's round returns early
            # there, yet IT is the host that parks wait-points.
            # Coarse cadence — the sweep is an O(pending) scan.
            if self._waits.pending \
                    and time.monotonic() >= self._wait_expire_at:
                self._wait_expire_at = time.monotonic() + 10.0
                with self.lock:
                    expired_waits = self._waits.expire(
                        time.monotonic(),
                        max(35.0, 8.0 * self.post_timeout))
                for ch in expired_waits:
                    ch.close(_EXPIRED)
            with self.lock:
                # apply paths raise the flag under the lock; clear it
                # under the lock too so a set landing between the read
                # and the write can't be lost.  While a deferred
                # snapshot is still running the flag stays SET (the
                # in-flight save captured an older seq; the trigger
                # re-fires once it finishes).
                want_snap = (self._want_snap
                             and (self._snap_thread is None
                                  or not self._snap_thread.is_alive()))
                if want_snap:
                    self._want_snap = False
            if want_snap:
                # off the round loop: save_snap's write+fsync of a
                # big store would stall ticks/heartbeats here long
                # enough to lose leadership on every big snapshot
                self._snap_thread = threading.Thread(
                    target=self._snapshot_bg,
                    name=f"dist{self.slot}-snap", daemon=True)
                self._snap_thread.start()

        for p in batch:
            self.w.trigger(p.id, None)
        while True:
            try:
                p = self._queue.get_nowait()
            except queue.Empty:
                break
            if p is not None:
                self.w.trigger(p.id, None)
        for q in self._requeue:
            while q:
                self.w.trigger(q.popleft().id, None)
        with self.lock:
            assigned = list(self._assigned.values())
            self._assigned.clear()
            pending_reads = self._reads.fail_all()
            pending_waits = self._waits.fail_all()
        for p in assigned:
            self.w.trigger(p.id, None)
        for pr in pending_reads:
            pr.ch.close(None)
        for ch in pending_waits:
            ch.close(None)

    def _drain(self, timeout: float) -> list[_Pending]:
        """Adaptive-cadence coalescing drain: after the first
        proposal arrives, keep collecting until the coalesce-entry /
        coalesce-byte threshold is reached or the ``coalesce_us``
        timer fires — whichever first (the fixed-round-tick batch
        boundary is gone; a lone write flushes in ~coalesce_us, a
        burst flushes as soon as it fills a batch)."""
        out: list[_Pending] = []
        try:
            p = self._queue.get(timeout=timeout)
        except queue.Empty:
            return out
        if p is None:
            return out
        out.append(p)
        nbytes = len(p.data)
        deadline = time.monotonic() + self.coalesce_us * 1e-6
        while (len(out) < self.coalesce_ents
               and nbytes < self.coalesce_bytes):
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                p = self._queue.get(timeout=left)
            except queue.Empty:
                break
            if p is None:
                break
            out.append(p)
            nbytes += len(p.data)
        self._m_coalesce.observe(len(out))
        return out

    def _leader_round(self, batch: list[_Pending]) -> None:
        """One pipelined leader stage: drain → append → frames OUT →
        own fsync (overlapped with the in-flight sends) → self-ack →
        commit/apply.

        This is the lockstep round (drain → append → persist →
        exchange → absorb → commit, server.go:247-323) decomposed:
        the synchronous ``_exchange`` barrier is gone — append frames
        are enqueued on the per-peer pipelined channels and their
        acks absorb OUT of band (``_absorb_ack``, on the channel
        reader threads) as they arrive, recomputing quorum commit per
        ack, so a slow follower no longer gates the fast pair and
        this stage never blocks on the network.  Durability overlap:
        the frames leave BEFORE the local WAL fsync runs, and the
        leader's own ack joins the quorum only when that fsync lands
        (``mr.ack_self``) — commit still requires a quorum of DURABLE
        copies, they just become durable in parallel now."""
        mr = self.mr
        if self._nospace:
            # read-only: reject the drained batch AND anything
            # requeued with the typed code (waiters get a decodable
            # EtcdNoSpace, never a silent timeout; proposing would
            # only grow the engine log with entries the WAL cannot
            # take)
            err = EtcdNoSpace(cause="member is read-only (NOSPACE)")
            for p in batch:
                self.w.trigger(p.id, Response(err=err))
            batch = []
            for q in self._requeue:
                while q:
                    self.w.trigger(q.popleft().id,
                                   Response(err=err))
        with self.lock:
            now_m = time.monotonic()
            if self._prev_lead.any():
                # check-quorum step-down: a lane whose
                # quorum ack basis is older than the FULL worst-case
                # election window cannot be committing anything, yet
                # its outbound heartbeats may still be muzzling the
                # followers' timers (one-way partition).  Abdicate
                # so a reachable leader can be elected; the normal
                # lost_lead machinery below observes the transition.
                basis = self.lease.basis(self._members_np,
                                         self._nmembers_np, now_m)
                stale = self._prev_lead & (
                    np.maximum(basis, self._lead_since)
                    < now_m - self._down_s)
                if stale.any():
                    mr.step_down(stale)
                    self.flight.record(
                        "step_down", lanes=int(stale.sum()),
                        first=np.nonzero(stale)[0][:8].tolist(),
                        cause="check_quorum")
                    log.warning(
                        "dist[%d]: check-quorum step-down on %d "
                        "lane(s): no quorum ack for %.1fs",
                        self.slot, int(stale.sum()), self._down_s)
            # backstop: a frame whose ack AND failure were both lost
            # (transport edge cases) must not pin the window shut
            expired = self.pipe.expire(time.monotonic(),
                                       8.0 * self.post_timeout)
            for peer, metas in expired.items():
                _obs.registry.counter("etcd_dist_frame_resend_total",
                                      reason="expired").inc(len(metas))
                mr.probe_reset(peer)
                self._set_inflight(peer)
            lead = mr.is_leader()
            won = lead & ~self._prev_lead
            lost_lead = self._prev_lead & ~lead
            if won.any() or lost_lead.any():
                # leadership set changed: every in-flight frame
                # belongs to the old reign — drop them and let their
                # late acks read stale_epoch
                dropped = self.pipe.bump_epoch()
                self._traced_send.clear()  # old reign's send stamps
                if dropped:
                    _obs.registry.counter(
                        "etcd_dist_frame_resend_total",
                        reason="stale_epoch").inc(dropped)
            if lost_lead.any():
                # black-box forensics: a deposed lane also loses its
                # lease cover — this event is what lets the stitcher
                # and the drill see WHY reads started failing closed
                self.flight.record(
                    "lease_loss",
                    lanes=int(lost_lead.sum()),
                    first=np.nonzero(lost_lead)[0][:8].tolist())
            if lost_lead.any() and self._assigned:
                # waiters on lanes we no longer lead can never be
                # acked by us (the new leader may truncate them)
                for key in [k for k in self._assigned
                            if lost_lead[k[0]]]:
                    p = self._assigned.pop(key)
                    self.flight.record("tail", kind="failed_proposal",
                                       group=key[0], gindex=key[1],
                                       cause="leadership_lost",
                                       trace=p.trace)
                    self.w.trigger(p.id, None)
            if lost_lead.any() and self._ack_clock:
                # deposed lanes' in-flight stamps can never ack here
                self._ack_clock = {
                    k: v for k, v in self._ack_clock.items()
                    if not lost_lead[k[0]]}
            if lost_lead.any() and self._trace_live:
                self._trace_live = {
                    k: v for k, v in self._trace_live.items()
                    if not lost_lead[k[0]]}
            if lost_lead.any() and self._reads.pending:
                # reads pending on deposed lanes can never be
                # confirmed by us — fail them closed (the client
                # retries against the new leader; serving would be
                # the stale read this subsystem exists to prevent)
                for pr in self._reads.fail_lanes(lost_lead):
                    pr.ch.close(None)
            if won.any():
                # fresh-win grace for the check-quorum sweep: the
                # first acks take an RTT to arrive, and a basis of 0
                # must not read as "stale for ages"
                self._lead_since = np.where(won, now_m,
                                            self._lead_since)
                now_w = time.time()
                terms = mr.terms()
                for gi in np.nonzero(won)[0]:
                    self._elected_at[gi] = now_w
                    self._elected_term[gi] = terms[gi]
                    self._applied_at_elect[gi] = self.applied[gi]
                    self._first_apply_at[gi] = 0.0
            self._prev_lead = lead
            # /v2/stats/self role BEFORE any early return: followers
            # and freshly-deposed leaders must update too (the early
            # no-leader-lanes return below would otherwise freeze a
            # deposed host on StateLeader forever).  Leadership is
            # per-group; the scalar reference analog
            # (server.py soft_state) maps to leader-of-any.
            from .stats import STATE_FOLLOWER, STATE_LEADER

            lead_any = bool(lead.any())
            hint = mr.leader_hint()
            self._hint_np = hint  # host cache for the read path
            known = hint[hint >= 0]
            self.server_stats.set_state(
                STATE_LEADER if lead_any else STATE_FOLLOWER,
                self.id if lead_any
                else (int(np.bincount(known).argmax())
                      if known.size else 0))
            n_new = np.zeros(self.g, np.int32)
            items: list[list[_Pending]] = [[] for _ in range(self.g)]
            for gi in range(self.g):
                q = self._requeue[gi]
                while q and len(items[gi]) < mr.e:
                    items[gi].append(q.popleft())
            for p in batch:
                gi = p.group if p.group is not None \
                    else group_of(p.req.path, self.g)
                if not lead[gi] or len(items[gi]) >= mr.e:
                    self._requeue[gi].append(p)
                    continue
                items[gi].append(p)
            for gi in range(self.g):
                n_new[gi] = len(items[gi])

            self._m_pending.set(
                sum(len(q) for q in self._requeue))
            new_keys: list[tuple[int, int]] = []
            recs: list[Entry] = []
            if n_new.any():
                with tracer.stage("dist.propose"), \
                        _ledger.dispatch("dist.propose"):
                    valid, base = mr.propose(
                        n_new, data=[[p.data for p in items[gi]]
                                     for gi in range(self.g)],
                        self_ack=False)
                for gi in range(self.g):
                    if not items[gi]:
                        continue
                    if not valid[gi]:
                        for p in items[gi]:
                            p.retries += 1
                            if p.retries < 50:
                                self._requeue[gi].append(p)
                            else:
                                self.flight.record(
                                    "tail", kind="failed_proposal",
                                    group=gi, cause="retry_exhausted",
                                    trace=p.trace)
                                self.w.trigger(p.id, None)
                        continue
                    for j, p in enumerate(items[gi]):
                        key = (gi, int(base[gi]) + 1 + j)
                        self._assigned[key] = p
                        new_keys.append(key)
                        if p.trace is not None:
                            # the traced proposal now has a log slot:
                            # frames carrying (gi, gindex) will ship
                            # its trace context to the followers
                            self._trace_live[key] = p.trace
                            self.flight.span(
                                p.trace, self.slot, "append",
                                group=gi, gindex=key[1])
                recs = self._entry_records(
                    [gi for gi in range(self.g)
                     if items[gi] and valid[gi]], base, items)
            elif not lead.any():
                return

            if new_keys:
                # ack-RTT clock starts NOW: entries are appended and
                # the frames leave next — this is the send edge of
                # the consensus round trip
                now_s = time.perf_counter()
                for key in new_keys:
                    self._ack_clock[key] = now_s

            # frames FIRST (the fsync/network overlap): the channel
            # writer threads ship them — and the followers append +
            # fsync — while our own WAL fsync below is still running
            with tracer.stage("dist.build_append"), \
                    _ledger.dispatch("dist.build_append"):
                self._pump_all()

            if recs:
                # entries (+ frontier) must be durable before OUR ack
                # counts; the overlap ledger row makes the saved wall
                # time readable off /metrics (dispatch_seconds =
                # fsync seconds that ran with frames in flight)
                try:
                    if self.pipe.inflight_total():
                        with tracer.stage("dist.persist"), \
                                _ledger.dispatch("dist.fsync_overlap"):
                            self._persist(recs)
                    else:
                        with tracer.stage("dist.persist"):
                            self._persist(recs)
                except EtcdNoSpace:
                    # full disk under a leader: the entries are in
                    # the engine log and their frames may already be
                    # in flight (fsync/network overlap) — HOLD the
                    # records for re-persist at recovery and do NOT
                    # self-ack (commit may still form from a quorum
                    # of FOLLOWER acks, which is legal Raft: the
                    # entry is durable elsewhere).  New writes are
                    # refused from here on.
                    self._enter_nospace("leader persist", held=recs)
                    recs = []
                if recs:
                    # fsync landed: NOW this host's copy joins the
                    # quorum
                    mr.ack_self(_ledger.fetch("dist.server", mr.state.last))
                    if self._trace_live and new_keys:
                        now_f = time.monotonic()
                        for key in new_keys:
                            tid = self._trace_live.get(key)
                            if tid is not None:
                                self.flight.span(tid, self.slot,
                                                 "leader_fsync",
                                                 t=now_f)
            else:
                # nothing appended here, but acks may have moved the
                # commit frontier since the last flush
                try:
                    self._persist([])
                except EtcdNoSpace:
                    # the frontier record is an optimization —
                    # losing it costs replay time, never acked data
                    self._enter_nospace("frontier persist")
            with tracer.stage("dist.apply"):
                self._apply_committed(self._assigned)
            # read maintenance: drop waiters whose callers timed out
            # (the age bound sits ABOVE the 30s get_many handler
            # budget so an in-budget caller is never force-failed
            # early), then sweep (applied/floor moved this round)
            now_r = time.monotonic()
            for pr in self._reads.expire(
                    now_r, max(35.0, 8.0 * self.post_timeout)):
                pr.ch.close(_EXPIRED)
            self._read_release(now_r)

    # -- the append pipeline ---------------------------------------

    def _channel(self, peer: int) -> PipeChannel:
        """The peer's pipelined append channel (lazily built; rebuilt
        when the peer's URL changed — a cached channel to the old
        address must not short-circuit the new route)."""
        url = self.peer_urls[peer]
        chan = self._channels.get(peer)
        if chan is not None and chan.url != url:
            chan.close()  # fails its in-flight: probe + resend
            chan = None
        if chan is None:
            chan = PipeChannel(
                url, "/mraft", stripes=self._n_stripes,
                timeout=self.post_timeout,
                ssl_context=self._peer_ssl_cli,
                on_resp=lambda seq, status, body, _p=peer:
                    self._on_pipe_resp(_p, seq, status, body),
                on_fail=lambda seqs, reason, _p=peer:
                    self._on_pipe_fail(_p, seqs, reason),
                on_sent=lambda seq, _p=peer:
                    self._on_pipe_sent(_p, seq),
                name=f"{self.slot}to{peer}",
                fault_ctx=(f"s{self.slot}", f"s{peer}"))
            self._channels[peer] = chan
        return chan

    def _set_inflight(self, peer: int) -> None:
        self._m_inflight[peer].set(self.pipe.inflight(peer))
        self._m_inflight_ents[peer].set(
            self.pipe.inflight_entries(peer))

    def _pump_all(self) -> None:
        for peer in range(self.m):
            if peer != self.slot:
                self._pump_peer(peer)

    def _pump_peer(self, peer: int) -> None:
        """Fill the peer's send window (call with self.lock held):
        data frames while the window has room and entries remain,
        plus ONE empty frame per heartbeat interval / commit advance
        (followers reset election timers and learn the commit vector
        from these).  ``next_`` advances optimistically at send, so
        consecutive frames carry consecutive windows without waiting
        for acks (etcd raft StateReplicate)."""
        mr = self.mr
        now = time.monotonic()
        # channel built only once there is something to send: spare
        # member slots (live < m) must not get idle socket threads
        chan = None
        commit = None
        # SNAPSHOT-mode evidence: does ANY stripe's build see
        # a lane it could actually append to?  A peer whose every
        # active lane sits behind the compaction point gets the
        # window collapsed to one need-snap notification frame at
        # heartbeat cadence — a full window of append frames would
        # all be doomed while its streamed install runs.
        saw_active = saw_appendable = False
        for stripe in range(self._n_stripes):
            mask = self._stripe_masks[stripe]
            while self.pipe.can_send(peer):
                b = mr.build_append(peer, lane_mask=mask)
                if b is None:
                    # no led lanes in THIS stripe's mask — the other
                    # stripe may still lead lanes (e.g. leadership
                    # held on odd groups only), so fall through to
                    # it rather than returning
                    break
                n_ents = np.asarray(b.n_ents)
                has_ents = bool(n_ents.any())
                saw_active = True
                if bool((np.asarray(b.active)
                         & ~np.asarray(b.need_snap)).any()):
                    saw_appendable = True
                if (has_ents and self.pipe.inflight(peer)
                        and int(n_ents.sum()) < self._min_frame_ents):
                    # anti-fragmentation: a follower pays a full
                    # [G]-wide engine dispatch + fsync per FRAME
                    # regardless of entry count, so while the pipe is
                    # already busy, thin frames are pure overhead —
                    # hold the window until the frame is full enough
                    # (the in-flight ack re-pumps, so nothing
                    # starves; an idle pipe always sends immediately)
                    break
                if not has_ents:
                    # pure heartbeat / commit / need_snap frame:
                    # dedup on cadence and commit movement
                    if commit is None:
                        commit = np.asarray(b.commit)
                    adv = bool(((commit > self._sent_commit[peer])
                                & mask).any())
                    last = self.pipe.last_send(peer, stripe)
                    # a pending ReadIndex confirmation nudges ONE
                    # out-of-cadence heartbeat per stripe: its ack
                    # is the quorum round the queued reads piggyback
                    # on (last >= nudge time means this stripe
                    # already sent its post-registration frame)
                    due = (now - last >= self._hb_interval
                           or last < self._read_nudge_t)
                    if not (adv or due):
                        break
                meta = self.pipe.register(
                    peer, t0=now, nbytes=0, has_ents=has_ents,
                    stripe=stripe, n_ents=int(n_ents.sum()))
                b.seq, b.epoch = meta.seq, self.pipe.epoch
                mr.optimistic_advance(peer, b)
                if has_ents and self._trace_live:
                    # stamp the frame with every in-flight traced
                    # proposal it carries (the sampled subset only:
                    # _trace_live holds tens of keys, not the batch)
                    prev = np.asarray(b.prev_idx)
                    act = np.asarray(b.active) \
                        & ~np.asarray(b.need_snap)
                    tr = [(g_, gi_, tid, self.slot)
                          for (g_, gi_), tid
                          in self._trace_live.items()
                          if act[g_] and prev[g_] < gi_
                          <= prev[g_] + int(n_ents[g_])]
                    if tr:
                        b.trace = tr
                        meta.traced = True
                        self._traced_send[(peer, meta.seq)] = \
                            [[t[2], t[3]] for t in tr]
                with tracer.stage("dist.frame_marshal"):
                    payload = b.marshal()
                meta.nbytes = len(payload)
                self._m_frames.inc()
                self.server_stats.send_append()
                self._sent_commit[peer] = np.where(
                    mask, np.asarray(b.commit, np.int64),
                    self._sent_commit[peer])
                if chan is None:
                    chan = self._channel(peer)
                chan.send(meta.seq, payload, stripe)
                if not has_ents:
                    break
        if saw_active:
            if not saw_appendable:
                log.debug("dist[%d]: peer %d all lanes need-snap",
                          self.slot, peer)
                if self.pipe.note_snapshot(peer):
                    self.flight.record("pipe_mode", peer=peer,
                                       mode="snapshot")
            else:
                # the peer is past the compaction point on at least
                # one lane again (its install landed): leave
                # SNAPSHOT via one confirming probe frame
                if self.pipe.note_caught_up(peer):
                    self.flight.record("pipe_mode", peer=peer,
                                       mode="probe",
                                       cause="caught_up")
        self._set_inflight(peer)

    def _on_pipe_sent(self, peer: int, seq: int) -> None:
        """Channel writer callback: the frame's bytes just hit the
        socket.  Record the flight send event for traced frames —
        this is the accurate send edge of the stitcher's symmetric
        (send, recv, resp, ack) clock-alignment quads (stamping at
        register time would fold channel queue wait into the
        network hop).  dict.pop is GIL-atomic; no lock needed."""
        traces = self._traced_send.pop((peer, seq), None)
        if traces is not None:
            self.flight.record("frame", dir="send", peer=peer,
                               seq=seq, traces=traces)

    def _on_pipe_resp(self, peer: int, seq: int, status: int,
                      body: bytes) -> None:
        """Channel reader callback: one ack arrived."""
        if self.done.is_set():
            return
        # inbound half of the peerlink.recv failpoint: a dropped ack
        # simply evaporates — no progress, no failure signal — and
        # only the in-flight expire sweep recovers the window (the
        # asymmetric-partition case check-quorum step-down exists
        # for)
        try:
            act = _faults.hit("peerlink.recv",
                              src=self._peer_labels[peer],
                              dst=self._self_label)
        except OSError:
            act = _faults.DROP
        if act == _faults.DROP:
            return
        if status != 200:
            self._on_pipe_fail(peer, [seq], "reconnect")
            return
        try:
            resp = unmarshal_any(body)
        except Exception:
            self._on_pipe_fail(peer, [seq], "reconnect")
            return
        if not isinstance(resp, AppendResp):
            # a desynced/misbehaving peer answered with some other
            # frame kind: fail the seq like any bad response, or it
            # pins the window shut until the expire sweep
            self._on_pipe_fail(peer, [seq], "reconnect")
            return
        t1 = time.monotonic()
        with self.lock:
            if self.done.is_set():
                return
            self._absorb_ack(peer, resp, t1)

    def _on_pipe_fail(self, peer: int, seqs: list, reason: str) -> None:
        """Channel failure callback: these frames will never ack.
        Roll the peer back to probing from its confirmed match point
        — the optimistic next_ advances for the lost frames would
        otherwise leave a permanent hole until a reject round-trip
        repaired it."""
        if self.done.is_set():
            return
        for seq in seqs:
            # a never-sent (or never-acked) traced frame's send
            # registration must not leak in the stamp dict
            self._traced_send.pop((peer, seq), None)
        with self.lock:
            was = self.pipe.mode(peer)
            popped = self.pipe.fail(peer, seqs)
            if not popped:
                return
            mode = self.pipe.mode(peer)
            if mode != was:
                self.flight.record("pipe_mode", peer=peer, mode=mode,
                                   cause=reason)
            _obs.registry.counter("etcd_dist_frame_resend_total",
                                  reason=reason).inc(len(popped))
            self._m_send_fail.inc(len(popped))
            self.leader_stats.fail(self._member_id(peer))
            self.mr.probe_reset(peer)
            self._set_inflight(peer)

    def _absorb_ack(self, peer: int, resp: AppendResp,
                    t1: float) -> None:
        """Match + absorb one pipelined ack (call with lock held):
        monotone match/next update, quorum commit recomputed NOW (not
        at the next round), apply + client acks, then refill the
        peer's window."""
        mr = self.mr
        disp, meta = self.pipe.ack(peer, resp.seq, resp.epoch)
        if disp != "ok":
            _obs.registry.counter("etcd_dist_frame_resend_total",
                                  reason=disp).inc()
            higher = np.asarray(resp.term) > mr.terms()
            if higher.any():
                # an ack from a previous reign may still carry the
                # higher term that deposed us — the step-down must
                # not be lost, but its progress content (acked/ok/
                # hint) must not touch the OTHER lanes' state (those
                # indexes may have been truncated since; a full
                # active mask would reject-repair next_ on every
                # still-led lane).  Absorb a copy neutered to the
                # higher-term lanes only.
                mr.handle_append_resp(AppendResp(
                    sender=resp.sender, term=resp.term,
                    ok=np.zeros(self.g, bool), acked=resp.acked,
                    hint=resp.hint,
                    active=np.asarray(resp.active) & higher))
            return
        rtt = t1 - meta.t0
        self._m_send_rtt.observe(rtt)
        self.leader_stats.observe(self._member_id(peer), rtt)
        if meta.traced:
            # the ack edge of the clock-alignment quad (t1 was
            # stamped on the channel reader thread, pre-lock)
            self.flight.record("frame", t=t1, dir="ack", peer=peer,
                               seq=resp.seq)
            self._traced_send.pop((peer, resp.seq), None)
        with tracer.stage("dist.absorb"), \
                _ledger.dispatch("dist.absorb"):
            mr.handle_append_resp(resp)
        active = np.asarray(resp.active)
        ok = np.asarray(resp.ok)
        # lease / ReadIndex evidence: count only active & OK
        # lanes — both are subsets of the follower's ``cur`` (it
        # held OUR term and reset its election timer when this frame
        # arrived).  ``active`` alone is NOT cur-only: the follower
        # folds need_snap lanes into it even at a HIGHER term so the
        # step-down can propagate (distmember.handle_append), and a
        # deposing ack must never extend a lease.  The cost is that
        # cur-but-rejected lanes (probe catch-up) don't renew —
        # conservative: the quorum's healthy members carry the basis.
        self.lease.note_ack(peer, meta.t0, active & ok)
        if (active & ~ok).any():
            # follower found a gap (dropped or out-of-order frame):
            # next_ was repaired from its commit hint; collapse to
            # PROBE so exactly one catch-up frame goes out
            if self.pipe.note_reject(peer):
                self.flight.record("pipe_mode", peer=peer,
                                   mode="probe", cause="reject")
            _obs.registry.counter("etcd_dist_frame_resend_total",
                                  reason="reject").inc()
        elif (active & ok).any():
            if self.pipe.note_ok(peer):
                self.flight.record("pipe_mode", peer=peer,
                                   mode="replicate")
        self._set_inflight(peer)
        with tracer.stage("dist.apply"):
            self._apply_committed(self._assigned)
        self._pump_peer(peer)
        # the ack may have advanced the quorum basis past pending
        # reads' registration times — the batched release sweep
        # rides the ack path, not a timer
        self._read_release()

    def _campaign(self, mask: np.ndarray) -> None:
        """Batched election round-trip for the fired lanes."""
        if self._nospace:
            # cannot durably record term/vote: campaigning (or
            # tallying a win whose becoming-leader entry can't
            # persist) is off the table until space returns
            return
        with self.lock:
            req = self.mr.begin_campaign(mask)
            try:
                self._persist_ballot()
            except EtcdNoSpace:
                # an un-durable self-vote must not leave the host
                self._enter_nospace("campaign ballot")
                return
            payload = req.marshal()
            self._m_campaigns.inc(
                int(np.asarray(req.active).sum()))
        votes = [v for v in self._exchange(
            [(p, payload) for p in range(self.m) if p != self.slot])
            if isinstance(v, VoteResp)]
        if self.done.is_set():
            return  # stopping: don't tally/persist past stop()
        with self.lock:
            won = self.mr.tally(req.active, votes)
            self._m_wins.inc(int(won.sum()))
            # election forensics in the black box: which lanes
            # campaigned, how many answered, how many lanes won, at
            # what term — the always-on record the drill's post-
            # mortem used to grep stdout for
            fired = np.asarray(req.active)
            self.flight.record(
                "election", fired=int(fired.sum()),
                won=int(won.sum()), resps=len(votes),
                term=int(_ledger.fetch("dist.server", self.mr.state.term).max()),
                lanes=np.nonzero(fired)[0][:8].tolist())
            try:
                self._persist_ballot()
            except EtcdNoSpace:
                self._enter_nospace("tally ballot")
                return
            lost = int(np.asarray(req.active).sum()) \
                - int(won.sum())
            if lost and self._debug_elections:
                # liveness forensics (chaos drill): which lanes
                # campaigned, how many peers answered, what they said
                log.info(
                    "dist[%d]: campaign lost %d lanes (fired=%s, "
                    "resps=%d, grants=%s, terms=%s)", self.slot,
                    lost, np.nonzero(np.asarray(req.active))[0][:8],
                    len(votes),
                    [np.asarray(v.granted).astype(int)[:8].tolist()
                     for v in votes],
                    _ledger.fetch("dist.server", self.mr.state.term)[:8])
            if won.any():
                log.info("dist[%d]: won %d groups", self.slot,
                         int(won.sum()))
                # becoming-leader empty entry (raft.go:329-348) —
                # replicated and committed via the normal rounds
                valid, base = self.mr.propose(
                    won.astype(np.int32),
                    data=[[b""] if won[gi] else []
                          for gi in range(self.g)])
                recs = []
                terms = self.mr.terms()
                for gi in np.nonzero(valid)[0]:
                    self.seq += 1
                    recs.append(Entry(
                        index=self.seq, term=self.raft_term,
                        data=GroupEntry(
                            kind=K_ENTRY, group=int(gi),
                            gindex=int(base[gi]) + 1,
                            gterm=int(terms[gi])).marshal()))
                won_lanes = np.nonzero(valid)[0].tolist()
                self._note_tail(won_lanes,
                                [int(base[gi]) + 1 for gi in won_lanes],
                                recs)
                try:
                    self._persist(recs)
                except EtcdNoSpace:
                    # the becoming-leader entries live in the engine
                    # log with frames about to pump: hold their
                    # records for recovery, same as the leader-round
                    # persist
                    self._enter_nospace("campaign persist",
                                        held=recs)

    def _exchange(self, frames: list[tuple[int, bytes]],
                  track: bool = False) -> list:
        """POST one frame per peer concurrently; returns the parsed
        responses that arrived (drops parse failures and dead peers).
        With ``track`` (the APPEND round only — vote traffic must not
        skew follower stats, matching the reference's MSG_APP-only
        tracking, sender.py), per-peer round-trip latency feeds
        /v2/stats/leader keyed by member id."""
        if not frames:
            return []
        if self.done.is_set():
            return []  # stop() may have shut the pool down already

        def one(arg):
            peer, payload = arg
            self._m_frames.inc()
            t0 = time.perf_counter()
            out = self._post_peer(peer, "/mraft", payload)
            if out is None:
                self._m_send_fail.inc()
                if track:
                    self.leader_stats.fail(self._member_id(peer))
                return None
            rtt = time.perf_counter() - t0
            self._m_send_rtt.observe(rtt)
            try:
                parsed = unmarshal_any(out)
            except Exception:
                if track:
                    self.leader_stats.fail(self._member_id(peer))
                return None
            if track:
                self.leader_stats.observe(
                    self._member_id(peer), rtt)
            return parsed

        try:
            return [r for r in self._xchg_pool.map(one, frames)
                    if r is not None]
        except RuntimeError:
            # stop() shut the pool between the done-check and map()
            if self.done.is_set():
                return []
            raise

    def _member_id(self, slot: int) -> int:
        """Stats key for peer ``slot``: its registered member id when
        the replicated registry has it (peers publish name->id with
        their peer URL), else the slot index as a placeholder until
        the registration commits."""
        cached = self._slot_ids.get(slot)
        if cached is not None:
            return cached
        try:
            url = self.peer_urls[slot]
            for m in self.cluster_store.get().values():
                if url in m.peer_urls:
                    self._slot_ids[slot] = m.id
                    return m.id
        except Exception:
            pass
        return slot

    def _post_peer(self, peer: int, path: str,
                   payload) -> bytes | None:
        """Synchronous POST over the shared keep-alive cache
        (peerlink.KeepAlivePool — the same abstraction behind the
        classic sender; at-least-once delivery contract and the
        URL-change/stale-socket handling live there).  Used by the
        vote round-trips; append frames ride the pipelined channels
        instead.  Both directions cross the peerlink failpoints
       : a dropped send or a dropped response is a dropped
        message — by contract, recovered by retry."""
        try:
            if _faults.hit("peerlink.send", src=self._self_label,
                           dst=self._peer_labels[peer]) \
                    == _faults.DROP:
                return None
        except OSError:
            return None
        out = self._pool.post(peer, self.peer_urls[peer], path,
                              payload)
        if out is None or out[0] != 200:
            return None
        try:
            if _faults.hit("peerlink.recv",
                           src=self._peer_labels[peer],
                           dst=self._self_label) == _faults.DROP:
                return None
        except OSError:
            return None
        return out[1]

    # -- apply ------------------------------------------------------------

    def _apply_committed(self, assigned=None) -> None:
        """Apply newly committed entries to the local replica (call
        with lock held); leader lanes also ack their waiters."""
        mr = self.mr
        commit = mr.commit_index().astype(np.int64)
        newly = commit > self.applied
        if not newly.any():
            return
        t_apply = time.perf_counter()
        n_apply = int((commit - self.applied)[newly].sum())
        # batch the whole commit window into ONE fanout dispatch; the
        # round scope keeps watcher matching/delivery off this path
        # (we hold self.lock here — the engine thread picks it up)
        sink = self.commit_sink
        sink_rows: list | None = [] if sink is not None else None
        with self.store.fanout_round():
            self._apply_window(assigned, mr, commit, newly,
                               sink_rows)
        if sink_rows:
            # the ring write is a bounded memcpy that never blocks
            # (shmring drops + counts on overrun), so it can ride
            # the apply path without threatening raft liveness
            with tracer.stage("role.handoff_marshal"):
                sink.push(sink_rows)
        self._m_apply_n.observe(n_apply)
        self._m_apply_s.observe(time.perf_counter() - t_apply)
        mr.mark_applied(self.applied)
        # follower linearizable reads park on commit-index
        # wait-points; the advanced apply frontier releases them
        if self._waits.pending:
            for ch in self._waits.release(self.applied):
                ch.close(True)
        # lane-fill compaction, decoupled from the snap_count-gated
        # snapshot: periodic SYNC entries alone would fill a group's
        # fixed-cap log window on an idle cluster long before 10k
        # applies accumulate, wedging that lane permanently
        st = mr.state
        fill = _ledger.fetch("dist.server", st.last) - _ledger.fetch("dist.server", st.offset)
        if (fill > (mr.cap * 3) // 4).any():
            mr.compact()
        if self.raft_index - self._snapi > self.snap_count:
            # deferred to the round loop: _apply_committed runs
            # under self.lock (round loop AND ack/handler threads),
            # and snapshot()'s disk I/O must not run there
            self._want_snap = True

    def _apply_window(self, assigned, mr, commit, newly,
                      sink_rows: list | None = None) -> None:
        """Per-group apply loop (split from _apply_committed so the
        fanout round brackets exactly the store mutations)."""
        for gi in np.nonzero(newly)[0]:
            for idx in range(int(self.applied[gi]) + 1,
                             int(commit[gi]) + 1):
                # quorum-acked and applying: close the ack-RTT clock
                key = (int(gi), idx)
                ts = self._ack_clock.pop(key, None)
                rtt = None
                if ts is not None:
                    rtt = time.perf_counter() - ts
                    self._m_ack.observe(rtt)
                tid = self._trace_live.pop(key, None) \
                    if self._trace_live else None
                if tid is not None:
                    self.flight.span(tid, self.slot, "commit",
                                     group=key[0], gindex=key[1])
                if rtt is not None and rtt > self.flight.slow_s:
                    # TAIL capture: a slow proposal lands in the ring
                    # even when head sampling missed it — the ring
                    # always holds the outliers
                    self.flight.record("tail", kind="slow_proposal",
                                       group=key[0], gindex=key[1],
                                       rtt_ms=round(rtt * 1e3, 2),
                                       trace=tid)
                payload = mr.committed_payload(int(gi), idx)
                resp = None
                if payload:
                    # leader fast path: the waiter's _Pending still
                    # holds the parsed Request — skip re-unmarshaling
                    # the payload it was built from
                    pend = (assigned or {}).get((int(gi), idx))
                    r = (pend.req if pend is not None
                         else Request.unmarshal(payload))
                    if r.method == "CONFCHANGE":
                        # committed membership change for THIS group
                        # (server.go:542-559): every host applies it
                        # at its own apply frontier
                        self._apply_conf_change(int(gi), r)
                        resp = Response()
                    else:
                        resp = apply_request_to_store(self.store, r)
                        if sink_rows is not None:
                            sink_rows.append((int(gi), idx, payload))
                self.raft_index += 1
                if tid is not None:
                    self.flight.span(tid, self.slot, "apply")
                p = (assigned or {}).pop((int(gi), idx), None)
                if p is not None:
                    self.w.trigger(p.id, resp)
                elif payload:
                    self.w.trigger(r.id, resp)
                if tid is not None:
                    self.flight.span(tid, self.slot, "client_ack")
            self.applied[gi] = commit[gi]
            dq = self._tail_seqs[gi]
            while dq and dq[0][0] <= commit[gi]:
                dq.popleft()
            if (self._first_apply_at[gi] == 0.0
                    and self._elected_at[gi] > 0.0
                    and self.applied[gi] > self._applied_at_elect[gi]):
                self._first_apply_at[gi] = time.time()

    # -- NOSPACE read-only mode -----------------------------------

    def _enter_nospace(self, cause: str,
                       held: list[Entry] | None = None) -> None:
        """Flip into read-only mode (call with self.lock held).
        ``held`` carries leader-side WAL records whose entries are
        already in the engine log — they re-persist FIRST at
        recovery, before this host's durable self-ack counts."""
        if held:
            self._held_recs = (self._held_recs or []) + held
        if self._nospace:
            return
        self._nospace = True
        self._nospace_backoff.reset()
        self._nospace_probe_t = (time.monotonic()
                                 + self._nospace_backoff.next())
        self._m_nospace.set(1)
        self.flight.record("nospace", state="enter", cause=cause)
        log.error("dist[%d]: ENTERING NOSPACE read-only mode (%s): "
                  "writes rejected with errorCode 405, reads keep "
                  "serving, disk probed with backoff", self.slot,
                  cause)

    def _exit_nospace(self) -> None:
        """Leave read-only mode (call with self.lock held)."""
        if not self._nospace:
            return
        self._nospace = False
        self._nospace_backoff.reset()
        self._m_nospace.set(0)
        # force the next _persist to write a fresh frontier record
        # (frontier saves were skipped throughout the episode)
        self._fr_last = None
        self.flight.record("nospace", state="exit")
        log.warning("dist[%d]: NOSPACE recovered — accepting writes "
                    "again", self.slot)

    def _nospace_recover(self) -> None:
        """Round-loop recovery probe: exercise the WAL's append +
        fsync seams; on success re-persist any held leader records
        (their entries were never self-acked) and re-open for
        writes.  Failure re-arms the probe with the shared
        backoff — a full disk is polled, never crash-looped."""
        try:
            with self.lock:
                self.wal.probe_space()
                if self._held_recs:
                    self._persist(self._held_recs)
                    self._held_recs = None
                    self.mr.ack_self(_ledger.fetch("dist.server", self.mr.state.last))
                self._exit_nospace()
        except EtcdNoSpace:
            delay = self._nospace_backoff.next()
            with self.lock:
                self._nospace_probe_t = time.monotonic() + delay

    # -- snapshot / catch-up ----------------------------------------------

    def snapshot(self) -> None:
        """Durable snapshot → engine compaction → WAL cut → segment
        GC.  Crash-ordering: save_snap fsyncs the snapshot
        file AND its directory entry before returning (the
        durability invariant), so by the time gc() unlinks segments the
        superseding artifact is durable — a crash anywhere in this
        sequence restarts either from the old chain (snapshot saved,
        nothing deleted yet) or from a seq-contiguous suffix still
        covering the GC boundary (gc removes oldest-first with a
        dir fsync per unlink).  The boundary is the OLDEST retained
        snapshot's index, not the newest: load() must be able to
        fall back across the whole retention window and replay
        forward from whichever snapshot survives.

        Lock discipline: only the state capture and the WAL/engine
        mutations hold ``self.lock`` — the snapshot file's
        write+fsync+purge (the seconds-long part on a big store)
        runs OUTSIDE it, so peer frames and client ops don't stall
        behind snapshot disk I/O; ``_snap_mutex`` serializes
        concurrent snapshot() calls instead."""
        try:
            with self._snap_mutex:
                with self.lock:
                    # the replay floor, not self.seq: entries appended
                    # before now but applied after it must replay
                    snap_seq = self._replay_floor(self.seq)
                    # only the tree->dict capture (store.save) needs
                    # the lock; the outer dumps re-escapes the whole
                    # embedded store string — comparable cost again —
                    # and must not stall handlers/round loop for it
                    d = self._snapshot_dict()
                    d["seq"] = snap_seq
                    term = self.raft_term
                blob = json.dumps(d).encode()
                with tracer.stage("dist.snapshot"):
                    # only this process's snapshot() writes the snap
                    # dir, and _snap_mutex is held: safe outside
                    # self.lock
                    self.ss.save_snap(Snapshot(
                        data=blob, index=snap_seq, term=term))
                    with self.lock:
                        self.mr.compact()
                        if log.isEnabledFor(logging.DEBUG):
                            log.debug(
                                "dist[%d]: post-compact offset=%s "
                                "applied=%s lead=%s", self.slot,
                                _ledger.fetch(
                                    "dist.server",
                                    self.mr.state.offset).tolist(),
                                _ledger.fetch(
                                    "dist.server",
                                    self.mr.state.applied).tolist(),
                                np.asarray(self.mr.is_leader())
                                .astype(int).tolist())
                        self.wal.cut()
                        floor = self.ss.retained_floor()
                        self.wal.gc(snap_seq if floor is None
                                    else floor)
                self._snapi = self.raft_index
        except EtcdNoSpace as e:
            # snapshot save / WAL cut hit a full disk: the one state
            # GC could have shrunk keeps growing, so degrade to
            # read-only instead of crash-looping the snapshot thread
            with self.lock:
                self._enter_nospace(f"snapshot: {e.cause}")
            return
        log.info("dist[%d]: snapshot at seq=%d", self.slot, snap_seq)

    def _snapshot_bg(self) -> None:
        """Thread body for the round-loop-deferred snapshot: never
        let a snapshot failure kill the thread loudly mid-shutdown
        (stop() closes the WAL after joining us, but a crashed donor
        disk etc. must surface as a log line, not a lost thread)."""
        try:
            self.snapshot()
        except Exception:
            if not self.done.is_set():
                log.exception("dist[%d]: deferred snapshot failed",
                              self.slot)

    def _install_ctr(self, outcome: str):
        # the one copy of the outcome-counter lookup lives with the
        # stream module; every outcome fetched here is inc'd at the
        # call site, so recording the flight event at fetch keeps
        # install outcomes in the black box without touching each of
        # the eight call sites.  chunk_reject is billed INSIDE the
        # puller (snap/stream.py) and reaches the ring through the
        # on_reject hook _stream_snapshot wires up.
        from ..snap.stream import _install_ctr

        self.flight.record("snap_install", outcome=outcome)
        return _install_ctr(outcome)

    def _pull_snapshot_bg(self) -> None:
        """Thread body for the round-loop-deferred pull: any
        unexpected failure (a donor bug the typed guards missed)
        must re-arm with backoff and log — a raise here would kill
        the thread silently and drop the pull request."""
        try:
            self._pull_snapshot()
        except Exception:
            if not self.done.is_set():
                log.exception("dist[%d]: snapshot pull failed",
                              self.slot)
                self._arm_pull_retry()

    def _arm_pull_retry(self) -> None:
        """Re-arm the pull with jittered exponential backoff: the
        need is NOT dropped on an all-donors-failed attempt (the
        pre-PR-6 wedge — a lagging peer sat stuck until an
        unrelated need_snap frame happened to re-trigger it)."""
        with self.lock:
            self._need_pull = True
            delay = self._pull_backoff.next()
            self._pull_not_before = time.monotonic() + delay
        log.info("dist[%d]: snapshot pull failed on every donor; "
                 "retrying in %.2fs", self.slot, delay)

    def _fetch_snap_meta(self, h: int) -> dict | None:
        """Meta pin fetch.  NOT on the shared keep-alive pool: the
        donor serializes + CRC-chains its whole store before
        replying, which on a big snapshot takes far longer than the
        pool's post_timeout read deadline — a short meta timeout
        would make large-snapshot pulls (the very case the stream
        exists for) unable to get past step one."""
        req = urllib.request.Request(
            self.peer_urls[h] + SNAP_META_PATH, data=b"",
            method="POST",
            headers={"Content-Type": "application/octet-stream"})
        # scale the wait with the donor's probed store size (1 MiB/s
        # serialization floor on top of the fixed slack): a fixed
        # timeout turns every donor of a big-enough store into
        # "unreachable" at step one — all donors fail identically and
        # the peer can never catch up, the wedge class this path
        # exists to fix
        hint_s = self._donor_size_hint.get(h, 0) / (1 << 20)
        try:
            with urllib.request.urlopen(
                    req,
                    timeout=max(30.0, 10 * self.post_timeout) + hint_s,
                    context=self._peer_ssl_cli) as resp:
                body = resp.read()
        except (urllib.error.URLError, OSError):
            return None  # unreachable donor
        try:
            return json.loads(body.decode())
        except ValueError:
            # the donor ANSWERED but with unparseable meta: a real
            # failed attempt (donor-side bug), distinct from an
            # unreachable donor — the documented meta_failed outcome
            self._install_ctr("meta_failed").inc()
            return None

    def _fetch_snap_frontier(self, h: int) -> np.ndarray | None:
        """Cheap pre-pin dominance probe (GET, no pin, no store
        serialization on the donor)."""
        try:
            with urllib.request.urlopen(
                    self.peer_urls[h] + SNAP_FRONTIER_PATH,
                    timeout=max(2.0, self.post_timeout),
                    context=self._peer_ssl_cli) as resp:
                d = json.loads(resp.read().decode())
            # remember the donor's size hint for the meta-fetch
            # timeout (absent on peers without a durable snapshot)
            self._donor_size_hint[h] = int(d.get("approx_bytes", 0))
            return np.asarray(d["frontier"], np.int64)
        except (urllib.error.URLError, OSError, ValueError,
                KeyError, TypeError):
            return None

    def _stream_snapshot(self, h: int, meta: dict) -> bytes:
        """Pull one pinned snapshot stream from donor ``h`` (chunked
        over a peerlink channel, rolling-CRC verified, resume from
        the last verified chunk on reconnect).  Raises
        SnapStreamError/StaleSourceError."""
        # the overall deadline must scale with the snapshot size: a
        # fixed cap aborts every attempt on a big-snapshot/slow-link
        # pull that is making steady progress (each retry starts over
        # against a NEW pin, so the peer would never catch up — the
        # exact wedge this path exists to fix).  120s of slack plus a
        # 1 MiB/s average-throughput floor; genuine no-progress is
        # the stall detector's job, not the deadline's.
        deadline = 120.0 + int(meta.get("size", 0)) / (1 << 20)
        puller = ChunkPuller(
            self.peer_urls[h], meta,
            ssl_context=self._peer_ssl_cli,
            timeout=self.post_timeout,
            window=4, deadline_s=deadline,
            abort=self.done.is_set,
            on_reject=lambda k: self.flight.record(
                "snap_install", outcome="chunk_reject", chunk=k,
                donor=h),
            verifier=ChunkVerifier(device=self.device),
            name=f"snap{self.slot}from{h}")
        try:
            return puller.run()
        finally:
            puller.close()

    def _pull_snapshot(self) -> None:
        """Streamed snapshot install (msgSnap-as-pull).

        Donors are tried in leader-hint order (then the remaining
        peers): meta pin → dominance check → chunked stream →
        install.  Installs only when the snapshot's frontier
        dominates our applied vector — the store blob is the merged
        state of ALL groups, so a partial install could regress
        groups that are ahead; a uniformly-behind (fresh or
        restarted) member always qualifies, which is the case the
        pull path exists for.  A TRANSPORT-class failure (donor
        unreachable, meta unreadable, stream aborted) re-arms
        ``_need_pull`` with backoff instead of dropping it (the
        pre-PR-6 wedge); a SNAPSHOT-class miss (not dominating,
        rejected by every lane) does NOT re-arm — it means appends
        are already flowing on lanes ahead of the pin, and the next
        genuine need_snap frame re-sets the flag if a lane is still
        behind the compaction point (an unconditional re-arm here
        turns the benign already-caught-up case into an infinite
        pull loop — found by the deep-lag drill)."""
        lead = self.mr.leader_hint()
        hinted = sorted({int(s) for s in lead
                         if s >= 0 and s != self.slot})
        rest = [p for p in range(self.m)
                if p != self.slot and p not in hinted]
        donors = hinted + rest
        tried = 0
        transport_failed = False
        for h in donors:
            if self.done.is_set():
                return
            # cheap dominance pre-probe BEFORE the meta pin: a pin
            # makes the donor serialize + CRC-chain its whole store
            # under its lock and hold the blob for the cache TTL —
            # a spurious _need_pull on a caught-up peer must not
            # cost every donor that (the probe is one small GET).
            # Dominance is re-checked post-pin and again under the
            # lock at install; this is only the cheap early exit.
            probe = self._fetch_snap_frontier(h)
            if probe is None:
                continue  # unreachable donor: not an attempt
            with self.lock:
                probe_dominates = bool((probe >= self.applied).all())
            if not probe_dominates:
                log.info("dist[%d]: donor %d frontier probe does "
                         "not dominate; skipping without pin",
                         self.slot, h)
                self._install_ctr("not_dominating").inc()
                tried += 1
                continue
            meta = self._fetch_snap_meta(h)
            if meta is None:
                continue  # unreachable donor: not an attempt
            tried += 1
            # one stale-pin retry per donor: the pin may have aged
            # out (or the donor restarted) between meta and chunks
            for attempt in range(2):
                try:
                    frontier = np.asarray(meta["frontier"], np.int64)
                    terms = np.asarray(meta["terms"], np.int64)
                    members = (np.asarray(meta["members"], bool)
                               if "members" in meta else None)
                    if frontier.shape != self.applied.shape:
                        raise ValueError("frontier shape mismatch")
                except (KeyError, TypeError, ValueError):
                    # parseable JSON but not a stream header (donor
                    # bug / version skew): the documented meta_failed
                    # outcome — a bare KeyError here would kill the
                    # pull thread instead of counting + backing off
                    self._install_ctr("meta_failed").inc()
                    transport_failed = True
                    break
                with self.lock:
                    dominates = bool((frontier >= self.applied).all())
                if not dominates:
                    log.info("dist[%d]: snapshot from %d does not "
                             "dominate; skipping", self.slot, h)
                    self._install_ctr("not_dominating").inc()
                    break
                try:
                    payload = self._stream_snapshot(h, meta)
                except StaleSourceError:
                    meta = self._fetch_snap_meta(h)
                    if meta is None or attempt == 1:
                        self._install_ctr("stream_failed").inc()
                        transport_failed = True
                        break
                    continue
                except SnapStreamError as e:
                    log.warning("dist[%d]: snapshot stream from %d "
                                "failed: %s", self.slot, h, e)
                    self._install_ctr("stream_failed").inc()
                    transport_failed = True
                    break
                try:
                    blob = json.loads(payload.decode())
                except ValueError:
                    # verified chunks but an unparseable payload:
                    # donor-side serialization bug, not transport
                    self._install_ctr("stream_failed").inc()
                    break
                # _snap_mutex first, as snapshot() takes it: the
                # install saves this host's snapshot below
                with self._snap_mutex, self.lock:
                    # dominance re-checked under the lock: appends
                    # absorbed during the (unlocked) stream may have
                    # advanced us past this snapshot
                    if not (frontier >= self.applied).all():
                        self._install_ctr("stale").inc()
                        break
                    inst = self.mr.install_snapshot(
                        frontier, terms, members=members)
                    if not inst.any():
                        self._install_ctr("stale").inc()
                        break
                    self.store.recovery(blob["store"].encode())
                    self.applied = frontier.copy()
                    self.raft_index = blob.get("applied_total",
                                               self.raft_index)
                    self.raft_term = max(self.raft_term,
                                         int(terms.max()))
                    try:
                        # the installed state exists in no record of
                        # this host's WAL: save it as this host's
                        # snapshot (at its own replay floor) before a
                        # frontier record claims it, or a restart
                        # would replay an older snapshot and lose it
                        blob["seq"] = self._replay_floor(self.seq)
                        self.ss.save_snap(Snapshot(
                            data=json.dumps(blob).encode(),
                            index=blob["seq"], term=self.raft_term))
                        self._persist([])
                    except EtcdNoSpace:
                        # the install is in-memory state; a member
                        # that restarts before space returns simply
                        # re-pulls (need_snap re-fires)
                        self._enter_nospace("install persist")
                    # the installed frontier may cover parked
                    # follower reads, and the snapshot's membership
                    # feeds the read path's quorum math
                    self._refresh_member_cache()
                    if self._waits.pending:
                        for ch in self._waits.release(self.applied):
                            ch.close(True)
                    self._pull_backoff.reset()
                    self._pull_not_before = 0.0
                    log.info("dist[%d]: installed streamed snapshot "
                             "from host %d (%d lanes, %d bytes)",
                             self.slot, h, int(inst.sum()),
                             len(payload))
                self._install_ctr("ok").inc()
                return
        if tried == 0:
            self._install_ctr("no_donor").inc()
        if tried == 0 or transport_failed:
            self._arm_pull_retry()

    # -- runtime membership (server.go:382-404, 542-559, per host) --------

    def add_member(self, slot: int,
                   timeout: float | None = 30.0) -> None:
        """Grow every group to include the host at member ``slot``
        (its URL must already be in peer_urls — slots are pre-sized;
        start the cluster with spare slots via ``live``).  One
        ConfChange per group, committed under the OLD quorum."""
        self._conf_change(True, slot, timeout)

    def remove_member(self, slot: int,
                      timeout: float | None = 30.0) -> None:
        self._conf_change(False, slot, timeout)

    def _conf_change(self, add: bool, slot: int,
                     timeout: float | None) -> None:
        """Each group's ConfChange goes through do() — which forwards
        to THAT group's leader host like any write (leadership is
        per-group and commonly split across hosts, so a local-queue-
        only submission would commit on this host's lanes and drop
        the rest, diverging per-group membership).  Groups run
        concurrently; any failure raises after the sweep."""
        if not (0 <= slot < self.m):
            raise ValueError(
                f"slot {slot} out of range ({self.m} member slots "
                f"= len(peer_urls); start with spare URLs to grow)")
        from concurrent.futures import ThreadPoolExecutor

        payload = json.dumps({"add": bool(add), "slot": int(slot)})

        def one(gi: int):
            self.do(Request(method="CONFCHANGE", id=gen_id(),
                            path=f"/_confchange/{gi}", val=payload),
                    timeout=timeout)

        with ThreadPoolExecutor(min(self.g, 16)) as pool:
            futs = {gi: pool.submit(one, gi) for gi in range(self.g)}
            failed = [gi for gi, f in futs.items()
                      if f.exception() is not None]
        if failed:
            raise TimeoutError(
                f"conf change uncommitted on {len(failed)} group(s) "
                f"(e.g. {failed[:4]}): "
                f"{futs[failed[0]].exception()}")

    def _apply_conf_change(self, gi: int, r: Request) -> None:
        d = json.loads(r.val)
        mask = np.zeros(self.g, bool)
        mask[gi] = True
        self.mr.apply_conf_change(bool(d["add"]), int(d["slot"]),
                                  mask=mask)
        # the read path's quorum-basis math keys off membership
        self._refresh_member_cache()

    def members_of(self, gi: int) -> np.ndarray:
        """[M] live-membership mask of group ``gi``."""
        return _ledger.fetch("dist.server", self.mr.state.members)[gi]

    # -- RaftTimer --------------------------------------------------------

    def index(self) -> int:
        return self.raft_index

    def term(self) -> int:
        return self.raft_term


# -- peer HTTP plumbing -----------------------------------------------------


class _PeerHTTPServer(ThreadingHTTPServer):
    """Peer/batch listener.  The stdlib default listen backlog of 5
    drops SYNs (= connection resets) the moment a read-heavy client
    pool opens its connections together — the get_many lane
    serves dozens of concurrent client connections, not just the
    two peer hosts.  Backlog is centralized in the front door
    so the peer/client asymmetry cannot reappear."""

    request_queue_size = LISTEN_BACKLOG


def pack_requests(reqs: list[Request]) -> bytes:
    """Batch-propose body: u32 count, then u32 length + marshaled
    Request per item (the /mraft/propose_many frame; shared by the
    server parser and bench/client writers)."""
    import struct

    parts = [struct.pack("<I", len(reqs))]
    for r in reqs:
        b = r.marshal()
        parts.append(struct.pack("<I", len(b)))
        parts.append(b)
    return b"".join(parts)


def unpack_requests(body: bytes) -> list[Request]:
    import struct

    if len(body) < 4:
        raise ValueError("short batch frame")
    (n,) = struct.unpack_from("<I", body, 0)
    pos, out = 4, []
    for _ in range(n):
        if pos + 4 > len(body):
            raise ValueError("truncated batch frame")
        (ln,) = struct.unpack_from("<I", body, pos)
        pos += 4
        if pos + ln > len(body):
            raise ValueError("truncated batch item")
        out.append(Request.unmarshal(body[pos:pos + ln]))
        pos += ln
    return out


def _refwd_not_leader(server: "DistServer", reqs: list[Request],
                      res: list, timeout: float = 30.0) -> list:
    """do_many answers follower-received writes with
    ``TimeoutError("not leader")`` — the batch lane never
    re-forwards (its clients target leaders).  The role-split ingest
    always posts to its LOCAL shard, so on follower hosts every
    write would bounce; re-drive just the misses through the
    single-op path, which forwards to the group leader.  The extra
    hop is only paid on non-leader hosts for non-leader groups."""
    out = list(res)
    for i, x in enumerate(out):
        if isinstance(x, TimeoutError) and "not leader" in str(x):
            try:
                out[i] = server.do(reqs[i], timeout=timeout)
            except Exception as e:
                out[i] = e
    return out


def _make_peer_handler(server: DistServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # per-connection socket timeout: bounds the deferred TLS
        # handshake and any stalled peer read in the worker thread
        timeout = 30

        def log_message(self, *a):  # quiet
            pass

        def _body(self) -> bytes:
            n = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(n)

        def do_POST(self):
            try:
                if self.path == "/mraft/faults":
                    # runtime fault control: the nemesis
                    # drill arms and clears failpoint specs mid-run.
                    # Routed BEFORE the http.peer failpoint below —
                    # an armed http.peer drop must never lock out
                    # its own clear path.  Body: {"spec": "...",
                    # "seed": N}; empty spec clears.  A bad spec is
                    # a loud 400 — a typo'd failpoint must never
                    # silently inject nothing.
                    try:
                        d = json.loads(self._body() or b"{}")
                        _faults.FAULTS.configure(
                            d.get("spec", ""), seed=d.get("seed"))
                        self._reply(200, json.dumps(
                            {"ok": True,
                             "spec": _faults.FAULTS.spec}).encode())
                    except (_faults.FaultSpecError, ValueError,
                            TypeError) as e:
                        self._reply(400, json.dumps(
                            {"ok": False,
                             "message": str(e)}).encode())
                    return
                # http.peer failpoint: whole-surface delay / error /
                # connection drop for the peer tier
                try:
                    if _faults.hit("http.peer") == _faults.DROP:
                        self.close_connection = True
                        return
                except OSError:
                    self._reply(503, b"")
                    return
                if self.path == "/mraft":
                    try:
                        out = server.handle_frame(self._body())
                    except ServerStoppedError:
                        self._reply(503, b"")
                        return
                    except EtcdNoSpace:
                        # read-only member: a distinct status the
                        # sender reads as "frame refused" (teardown
                        # + probe), distinct from the stopping 503
                        # in the logs
                        self._reply(507, b"")
                        return
                    except FrameDropped:
                        # injected inbound loss: no response at all —
                        # the sender sees a dead connection, exactly
                        # like a lost frame
                        self.close_connection = True
                        return
                    self._reply(200, out)
                elif self.path == SNAP_META_PATH:
                    # pin a fresh snapshot serialization; the reply
                    # is the stream header (id + chunk CRC chain)
                    self._body()
                    self._reply(200, server.snapshot_stream_meta())
                elif self.path == SNAP_CHUNK_PATH:
                    code, data = server.snapshot_stream_chunk(
                        self._body())
                    self._reply(code, data)
                elif self.path == "/mraft/propose":
                    try:
                        resp = server.handle_forward(
                            self._body(), timeout=5.0)
                        ev = resp.event.to_dict() \
                            if resp.event is not None else None
                        self._reply(200, json.dumps(
                            {"ok": True, "event": ev}).encode())
                    except Exception as e:
                        code = getattr(e, "error_code", 300)
                        self._reply(200, json.dumps(
                            {"ok": False, "errorCode": code,
                             "message": str(e)}).encode())
                elif self.path == "/mraft/propose_many":
                    # pipelined batch (do_many): one connection keeps
                    # a whole window of writes in flight.  The reply
                    # is error-sparse — {"n": N, "errs": {idx: ...}}
                    # — because at window 512 a per-request verdict
                    # list made the leader encode (and every client
                    # decode) ~12 KB of JSON per batch on the serving
                    # core; the common all-ok batch is now ~20 bytes.
                    # A client that advertised the binary framing
                    # (Accept) gets the fixed-width DCB1 form
                    # instead — 16 bytes all-ok, no JSON encode.
                    try:
                        # the propose BODY is the version-stable
                        # packed Request batch on every wire (a
                        # downgrade must never re-send a write), so
                        # its parse is ingest cost, not client-wire
                        # cost — attributed apart from the
                        # Accept-negotiated client.* stages
                        with tracer.stage("dist.parse_batch"):
                            reqs = unpack_requests(self._body())
                        res = server.do_many(reqs, timeout=30.0)
                        if self._binary_ok():
                            with tracer.stage("client.marshal"):
                                body = bytes(
                                    clientmsg.pack_propose_response(
                                        len(res),
                                        {i: (getattr(x, "error_code",
                                                     300), str(x))
                                         for i, x in enumerate(res)
                                         if not isinstance(
                                             x, Response)}))
                            self._reply(200, body,
                                        ctype=clientmsg.CONTENT_TYPE)
                            return
                        with tracer.stage("client.marshal"):
                            errs = {}
                            for i, x in enumerate(res):
                                if not isinstance(x, Response):
                                    errs[str(i)] = {
                                        "errorCode": getattr(
                                            x, "error_code", 300),
                                        "message": str(x)}
                            body = json.dumps(
                                {"n": len(res),
                                 "errs": errs}).encode()
                        self._reply(200, body)
                    except Exception as e:
                        self._reply(400, json.dumps(
                            {"ok": False,
                             "message": str(e)}).encode())
                elif self.path == ROLE_FWD_PATH:
                    # role-split ingest -> shard handoff:
                    # the packed DRH1 batch carries per-op flags the
                    # version-stable Request marshal deliberately
                    # omits (serializable), and the reply shape is
                    # frame-negotiated — acks for write batches,
                    # leaf values for read batches, full v2 events
                    # for the coalesced single-op lane.  Both
                    # directions are stage-metered so the bench gate
                    # can hold the handoff share under the client
                    # JSON share it replaced.
                    try:
                        with tracer.stage("role.handoff_parse"):
                            blobs, opflags, reply = \
                                rolemsg.unpack_fwd_request(
                                    self._body())
                            reqs = []
                            for b, fl in zip(blobs,
                                             opflags.tolist()):
                                r = Request.unmarshal(b)
                                if fl & rolemsg.OP_SERIALIZABLE:
                                    r.serializable = True
                                reqs.append(r)
                        if reply == rolemsg.REPLY_ACKS:
                            res = _refwd_not_leader(
                                server, reqs,
                                server.do_many(reqs, timeout=30.0))
                            with tracer.stage(
                                    "role.handoff_marshal"):
                                out = rolemsg.pack_fwd_acks(
                                    len(res),
                                    {i: (getattr(x, "error_code",
                                                 300), str(x))
                                     for i, x in enumerate(res)
                                     if not isinstance(x, Response)})
                        elif reply == rolemsg.REPLY_VALS:
                            res = server.read_many(reqs,
                                                   timeout=30.0)
                            vals: list = []
                            errs_r: dict = {}
                            for i, x in enumerate(res):
                                if isinstance(x, Response):
                                    ev = x.event
                                    vals.append(
                                        ev.node.value
                                        if ev is not None
                                        and ev.node is not None
                                        else None)
                                else:
                                    vals.append(None)
                                    errs_r[i] = (getattr(
                                        x, "error_code", 300),
                                        str(x))
                            with tracer.stage(
                                    "role.handoff_marshal"):
                                out = rolemsg.pack_fwd_vals(
                                    vals, errs_r)
                        else:
                            # mixed lane: plain GETs ride the
                            # zero-WAL read path (linearizable via
                            # ReadIndex; serializable flag already
                            # restored above), everything else —
                            # writes and QGET quorum reads — goes
                            # through the proposal coalescer; the
                            # two result streams stitch back in
                            # request order
                            ridx = [i for i, r in enumerate(reqs)
                                    if r.method == "GET"
                                    and not r.quorum]
                            widx = [i for i, r in enumerate(reqs)
                                    if r.method != "GET"
                                    or r.quorum]
                            results: list = [None] * len(reqs)
                            if widx:
                                wreqs = [reqs[i] for i in widx]
                                for i, x in zip(
                                        widx, _refwd_not_leader(
                                            server, wreqs,
                                            server.do_many(
                                                wreqs,
                                                timeout=30.0))):
                                    results[i] = x
                            if ridx:
                                for i, x in zip(
                                        ridx, server.read_many(
                                            [reqs[i] for i in ridx],
                                            timeout=30.0)):
                                    results[i] = x
                            final = []
                            for x in results:
                                if isinstance(x, Response):
                                    final.append(
                                        x.event if x.event
                                        is not None else
                                        EtcdError(300, "no event"))
                                else:
                                    final.append(x)
                            with tracer.stage(
                                    "role.handoff_marshal"):
                                out = rolemsg.pack_fwd_response(
                                    final)
                        self._reply(200, out)
                    except ServerStoppedError:
                        self._reply(503, b"")
                    except (FrameError, ValueError) as e:
                        self._reply(400, json.dumps(
                            {"ok": False,
                             "message": str(e)}).encode())
                elif self.path == READ_INDEX_PATH:
                    # follower reads: the leader's confirmed
                    # read index for one group (lease answers
                    # instantly; otherwise the request waits in the
                    # batched ReadIndex queue)
                    try:
                        d = json.loads(self._body() or b"{}")
                        rd = server.read_index(int(d.get("group",
                                                         -1)),
                                               timeout=5.0)
                        self._reply(200, json.dumps(
                            {"rd": rd}).encode())
                    except ServerStoppedError:
                        self._reply(503, b"")
                    except (TimeoutError, ValueError) as e:
                        # 200 with an err body: "not leader" is an
                        # answer, not a transport failure — the
                        # keep-alive pool must not tear the socket
                        self._reply(200, json.dumps(
                            {"err": str(e)}).encode())
                elif self.path == GET_MANY_PATH:
                    # batched zero-WAL read lane (the GET
                    # analog of propose_many): values ride back so
                    # read-burst clients (bench, chaos linz gate)
                    # can check what they observed.  Body is a JSON
                    # array of path strings (the compact form — a
                    # read's wire cost is its key), a binary DCB1
                    # path frame (magic-sniffed), or a packed
                    # Request batch (flagged reads).
                    try:
                        body = self._body()
                        if body[:1] == b"[":
                            with tracer.stage("client.parse"):
                                reqs = json.loads(body)
                                if not all(isinstance(p, str)
                                           for p in reqs):
                                    raise ValueError(
                                        "path list must be strings")
                        elif body[:4] == b"DCB1":
                            with tracer.stage("client.parse"):
                                reqs = clientmsg.unpack_get_request(
                                    body)
                        else:
                            # flagged reads ride the version-stable
                            # packed batch — ingest cost, like the
                            # propose body
                            with tracer.stage("dist.parse_batch"):
                                reqs = unpack_requests(body)
                        res = server.read_many(reqs, timeout=30.0)
                        vals: list = []
                        errs_b: dict = {}
                        for i, x in enumerate(res):
                            if isinstance(x, Response):
                                ev = x.event
                                vals.append(
                                    ev.node.value if ev is not None
                                    and ev.node is not None
                                    else None)
                            elif isinstance(x, Exception):
                                vals.append(None)
                                errs_b[i] = (getattr(
                                    x, "error_code", 300), str(x))
                            else:
                                # compact path-string entry: the raw
                                # leaf value (None for a directory)
                                vals.append(x)
                        if self._binary_ok():
                            with tracer.stage("client.marshal"):
                                # the codec takes str leaf values
                                # directly and encodes chunk-wise
                                # into the one output buffer; no
                                # bytes() re-copy of a KB-scale body
                                out = clientmsg.pack_get_response(
                                    vals, errs_b)
                            self._reply(200, out,
                                        ctype=clientmsg.CONTENT_TYPE)
                            return
                        with tracer.stage("client.marshal"):
                            out = json.dumps(
                                {"n": len(res), "vals": vals,
                                 "errs": {
                                     str(i): {"errorCode": c,
                                              "message": m}
                                     for i, (c, m)
                                     in errs_b.items()}}).encode()
                        self._reply(200, out)
                    except ServerStoppedError:
                        self._reply(503, b"")
                    except Exception as e:
                        self._reply(400, json.dumps(
                            {"ok": False,
                             "message": str(e)}).encode())
                else:
                    self._reply(404, b"")
            except Exception:
                log.exception("peer handler failed")
                try:
                    self._reply(500, b"")
                except Exception:
                    pass

        def do_GET(self):
            if self.path == "/mraft/faults":
                # active spec + per-(point, action) injection counts
                # (the nemesis replay gate compares these)
                self._reply(200, json.dumps(
                    _faults.FAULTS.snapshot()).encode())
            elif self.path == "/mraft/snapshot":
                self._reply(200, server.snapshot_blob())
            elif self.path == SNAP_FRONTIER_PATH:
                self._reply(200, server.snapshot_frontier())
            elif self.path == "/mraft/obs":
                # JSON registry snapshot (bucket counts + exact ring
                # percentiles): the cross-process merge form —
                # scripts/dist_bench.py pools the three hosts'
                # ack-RTT buckets from here
                self._reply(200, _obs.registry.snapshot_json())
            elif self.path == "/mraft/obs/light":
                # no exact-percentile ring sorts: the role
                # supervisor's per-second scrape form
                self._reply(200,
                            _obs.registry.snapshot_json(light=True))
            elif self.path == "/mraft/obs/flight":
                # flight-recorder dump: the ring + clock
                # anchors + per-stage wall/cpu/device sums — what
                # chaos_drill harvests on gate failure and
                # scripts/trace_stitch.py merges across nodes
                self._reply(200, server.flight.dump_json())
            elif self.path == "/mraft/obs/timeseries":
                # windowed-delta ring: rates and windowed percentiles
                # over the last ETCD_TS_RETENTION steps
                from ..obs import timeseries as _timeseries

                self._reply(200,
                            _timeseries.start_default()
                            .snapshot_json())
            elif self.path == "/mraft/obs/slo":
                # declared-objective verdict: burn rates over the
                # ring, the same body as GET /v2/stats/slo
                from ..obs import slo as _slo

                self._reply(200, _slo.default_verdict_json())
            elif self.path == "/mraft/leaders":
                # leadership-transition trace for the chaos drill's
                # recovery decomposition; lock-free reads of small
                # numpy arrays (diagnostic endpoint, torn reads
                # tolerable)
                body = json.dumps({
                    "slot": server.slot,
                    "lead": [bool(x) for x in server.mr.is_leader()],
                    "elected_at":
                        [float(x) for x in server._elected_at],
                    "elected_term":
                        [int(x) for x in server._elected_term],
                    "first_apply_at":
                        [float(x) for x in server._first_apply_at],
                }).encode()
                self._reply(200, body)
            else:
                self._reply(404, b"")

        def _binary_ok(self) -> bool:
            """Negotiation gate: answer in the binary client framing
            only when this server speaks it AND the request's Accept
            header asked for it (a JSON-only client never sees a
            binary byte; a binary client against a JSON-only server
            reads the missing reply Content-Type as 'negotiate
            down')."""
            return (server.wire_binary and clientmsg.CONTENT_TYPE
                    in (self.headers.get("Accept") or ""))

        def _reply(self, code: int, body: bytes,
                   ctype: str | None = None) -> None:
            self.send_response(code)
            if ctype is not None:
                self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            if body:
                self.wfile.write(body)

    return Handler
