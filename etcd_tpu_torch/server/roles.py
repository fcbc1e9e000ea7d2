"""Compartmentalized serving: role-split multi-process topology (the
port's copy of ``etcd_tpu/server/roles.py``).

One etcd-tpu "node" becomes a small supervised process tree, the
compartmentalization move from "Scaling Replicated State Machines
with Compartmentalization" — each GIL-bound concern gets its own
process so the serving tier scales with host cores before hosts:

    supervisor (this module, `--role supervise`)
    ├── ingest       stateless client front door + batcher: parses
    │                client wire (JSON/DCB1), coalesces per-shard
    │                lanes, forwards packed DRH1 batches over
    │                peerlink to the LOCAL shard (which runs the
    │                usual leader-forwarding underneath)
    ├── worker       apply/watch fanout: consumes each shard's
    │                committed stream off a shared-memory ring into
    │                a mirror Store and serves watches (wait= client
    │                requests 307 here from the ingest)
    └── shard s ∈ 0..S-1   a full DistServer owning G/S raft groups;
                     shard s peers only with shard s of other hosts
                     (S independent consensus planes)

Port map (every host derives it from the same inputs, so the bench
can address any role of any host):

    shard s peer port   = peer_base_port + m*s      (m = host count)
    ingest client port  = --client-port
    worker watch port   = --client-port + m

Handoff wire forms are the packed DRH1 frames in wire/rolemsg.py;
both directions run under `role.handoff_marshal`/`role.handoff_parse`
stage rows so dist_bench can hold the handoff share under the client
JSON share it replaced.  The shard -> worker committed stream rides
server/shmring.py: cursors live in the shared segment, so a killed
worker resumes exactly at its persisted tail — no replay, no
double-apply.

Supervision: children die with the supervisor (PDEATHSIG + a ppid
watchdog), and a killed role is respawned with the same arguments;
`<data-dir>/roles.json` maps role -> {pid, port} on every (re)spawn
so a harness can pick victims and verify the replacement.

The device: only the shard processes touch the card.  Each shard's
``DistServer`` runs on CUDA unless ``ETCD_TORCH_DEVICE`` names another
device (``cpu`` for tests); the supervisor never resolves a device and
its children inherit the variable, so the caller's choice reaches every
shard.  Without CUDA and without that variable a shard raises, and the
supervisor respawns it as it respawns any dead role.  A shard prints
one JSON line before ``ROLE-READY``: its restart seconds, the replay
lane the restart took and its raw-CRC kernel launches.

Documented limitations (by design): the worker's mirror store rebases
event indices after a worker restart (old waitIndex watches see 401
EventIndexCleared, exactly etcd's history-window semantics), and
recursive reads/watches see only keys whose first path segment routes
to the same shard.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import queue
import signal
import subprocess
import sys
import threading
import time
import urllib.request

from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..obs import aggregate as _aggregate
from ..obs import metrics as _obs
from ..obs import profiler as _profiler
from ..obs import slo as _slo
from ..obs import timeseries as _timeseries
from ..obs.exporter import (
    CONTENT_TYPE as _PROM_CTYPE,
    render_prometheus_snapshot,
)
from ..obs.flight import FlightRecorder, install_crash_dump
from ..utils.errors import (
    ECODE_RAFT_INTERNAL,
    EtcdError,
    EtcdOverCapacity,
)
from ..utils.trace import tracer
from ..wire import clientmsg, rolemsg
from ..wire.distmsg import FrameError
from .multigroup import group_of
from .peerlink import KeepAlivePool
from .server import Response, apply_request_to_store, gen_id
from .shmring import ShmRing

log = logging.getLogger(__name__)

ROLE_FWD_PATH = "/mraft/role_fwd"

#: committed-stream ring span per shard; at ~100 B/committed entry
#: this buffers seconds of full-rate apply traffic for the worker
RING_BYTES = 1 << 22

#: per-shard ingest lane depth.  Bounded: the front door's admission
#: control (max_inflight 4096 process-wide) saturates long before
#: this, so a full lane only ever means the shard link is wedged —
#: shed loudly rather than queue invisibly.
LANE_DEPTH = 8192

_LANE_MAX_BATCH = 256


def worker_port(client_port: int, m: int) -> int:
    """The apply/watch worker's client port.  Stride by the host
    count: deployments allocate consecutive client ports per host,
    so +m lands every host's worker in a disjoint band."""
    return client_port + m


def shard_peer_urls(peers: list[str], s: int) -> list[str]:
    """Peer base URLs for shard ``s``'s consensus plane: same hosts,
    port strided by the host count."""
    m = len(peers)
    out = []
    for u in peers:
        scheme, _, rest = u.partition("://")
        host, _, port = rest.rpartition(":")
        out.append(f"{scheme}://{host}:{int(port) + m * s}")
    return out


def ring_name(client_port: int, s: int) -> str:
    """Deterministic per-(host, shard) segment name: a respawned
    supervisor reclaims (unlink + recreate) the previous run's
    segments instead of leaking them."""
    return f"etcdtpu_{client_port}_r{s}"


def _arm_parent_death() -> None:
    """Die with the supervisor: a SIGKILLed host would otherwise leave
    orphaned role processes squatting the derived ports and failing
    the restart.  PDEATHSIG where available,
    plus a portable ppid watchdog."""
    if sys.platform.startswith("linux"):
        try:
            import ctypes

            libc = ctypes.CDLL("libc.so.6", use_errno=True)
            libc.prctl(1, signal.SIGTERM, 0, 0, 0)  # PR_SET_PDEATHSIG
        except Exception:  # pragma: no cover - exotic libc
            pass
    ppid = os.getppid()

    def _watch():
        while True:
            if os.getppid() != ppid:
                os._exit(0)
            time.sleep(0.5)

    threading.Thread(target=_watch, daemon=True,
                     name="ppid-watchdog").start()


def attach_ring(name: str) -> ShmRing:
    """Attach to an existing ring WITHOUT handing it to this
    process's resource tracker: on 3.10 an attaching process
    registers the segment and unlinks it at exit, which would tear
    the ring down under the surviving roles the first time one of
    them restarts."""
    ring = ShmRing(name)
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister(ring._shm._name, "shared_memory")
    except Exception:  # pragma: no cover - tracker internals moved
        pass
    return ring


class CommitSink:
    """DistServer.commit_sink adapter: packs each apply round's
    (group, gindex, payload) rows into one COMMIT frame and pushes
    it onto the shard's ring.  ``seq`` restarts with the producer;
    the consumer resyncs via the ring generation."""

    def __init__(self, ring: ShmRing):
        self.ring = ring
        self.seq = 0
        ring.bump_generation()

    def push(self, rows: list[tuple[int, int, bytes]]) -> None:
        self.seq += 1
        self.ring.push(rolemsg.pack_commit(self.seq, rows))


# -- ingest role ------------------------------------------------------------


class _StubStore:
    def __init__(self, remote):
        self._r = remote

    def index(self) -> int:
        return self._r.index()

    def json_stats(self) -> bytes:
        return b"{}"


class _StubStats:
    def to_json(self) -> bytes:
        return b"{}"


class _StubCluster:
    def __init__(self, urls):
        self._urls = urls

    def get(self):
        return self

    def client_urls_all(self) -> list[str]:
        return self._urls


class RemoteEtcd:
    """The ingest role's ``etcd`` seam for FrontDoor: every op is
    coalesced onto a per-shard lane, forwarded as one packed DRH1
    batch to the local shard, and the full v2 events ride back in
    the fixed-row FWD_RESP form — the front door renders them
    exactly as if the store were in-process."""

    def __init__(self, host: str, client_port: int,
                 peers: list[str], slot: int, shards: int,
                 timeout: float = 15.0):
        self.shards = shards
        self.slot = slot
        # local shard s answers on this host's strided peer port
        self.shard_urls = [
            shard_peer_urls(peers, s)[slot] for s in range(shards)]
        self.pool = KeepAlivePool(timeout=timeout)
        self.stopping = False
        # per-LANE etcd_index high-water marks: slot s is written
        # only by lane thread s (a bare shared ``self._index`` max
        # was a check-then-act race across lanes — two interleaved
        # updates could move the published index BACKWARD, and the
        # 429 retry hint with it); readers take the max
        self._hiwat = [0] * max(shards, 1)  # owner: ingest-lanes
        self.store = _StubStore(self)
        self.server_stats = _StubStats()
        self.leader_stats = _StubStats()
        self.cluster_store = _StubCluster(
            [f"http://{host}:{client_port}"])
        self._lanes = []
        for s in range(shards):
            q: queue.Queue = queue.Queue(maxsize=LANE_DEPTH)
            t = threading.Thread(target=self._lane, args=(s, q),
                                 daemon=True,
                                 name=f"ingest-lane-s{s}")
            self._lanes.append((q, t))
            t.start()

    def index(self) -> int:
        return max(self._hiwat)

    def term(self) -> int:
        return 0

    def stop(self) -> None:
        self.stopping = True

    # -- single-op lane ---------------------------------------------------

    def do(self, rr, timeout: float | None = None) -> Response:
        sid = group_of(rr.path, self.shards)
        done = threading.Event()
        box: list = [None]
        try:
            self._lanes[sid][0].put_nowait((rr, box, done))
        except queue.Full:
            raise EtcdOverCapacity(
                cause="ingest lane full", index=self.index(),
                retry_after=1.0) from None
        if not done.wait(timeout if timeout else 30.0):
            raise TimeoutError("shard handoff timed out")
        x = box[0]
        if isinstance(x, Exception):
            raise x
        return x

    def _lane(self, sid: int, q: queue.Queue) -> None:
        while not self.stopping:
            try:
                first = q.get(timeout=0.5)
            except queue.Empty:
                continue
            batch = [first]
            # coalesce whatever queued up behind the head op —
            # batching without added latency (the lane only ever
            # waits on an EMPTY queue)
            while len(batch) < _LANE_MAX_BATCH:
                try:
                    batch.append(q.get_nowait())
                except queue.Empty:
                    break
            self._flush(sid, batch)

    def _flush(self, sid: int, batch: list) -> None:
        try:
            with tracer.stage("role.handoff_marshal"):
                frame = rolemsg.pack_fwd_request(
                    [rr.marshal() for rr, _, _ in batch],
                    [rolemsg.OP_SERIALIZABLE if rr.serializable
                     else 0 for rr, _, _ in batch],
                    rolemsg.REPLY_EVENTS)
            out = self.pool.post(("lane", sid),
                                 self.shard_urls[sid],
                                 ROLE_FWD_PATH, frame)
            if out is None or out[0] != 200:
                raise EtcdError(ECODE_RAFT_INTERNAL,
                                f"shard {sid} unreachable")
            with tracer.stage("role.handoff_parse"):
                results = rolemsg.unpack_fwd_response(out[1])
            if len(results) != len(batch):
                raise EtcdError(ECODE_RAFT_INTERNAL,
                                "shard reply count mismatch")
        except Exception as e:
            err = (e if isinstance(e, EtcdError)
                   else EtcdError(ECODE_RAFT_INTERNAL, str(e)))
            for _, box, done in batch:
                box[0] = err
                done.set()
            return
        for (rr, box, done), res in zip(batch, results):
            if isinstance(res, tuple):
                code, cause, eidx = res
                box[0] = EtcdError(code, cause, eidx)
            else:
                if res.etcd_index > self._hiwat[sid]:
                    self._hiwat[sid] = res.etcd_index
                box[0] = Response(event=res)
            done.set()

    # -- batch routes ------------------------------------------------------

    def _forward_batch(self, reqs: list, reply: int
                       ) -> tuple[list, dict]:
        """Partition a client batch by shard, forward each partition
        as one DRH1 frame, merge results back into request order.
        Returns (vals, errs) for REPLY_VALS and (ignored, errs) for
        REPLY_ACKS."""
        parts: dict[int, list[int]] = {}
        for i, rr in enumerate(reqs):
            parts.setdefault(group_of(rr.path, self.shards),
                             []).append(i)
        vals: list = [None] * len(reqs)
        errs: dict[int, tuple[int, str]] = {}
        for sid, idxs in parts.items():
            try:
                with tracer.stage("role.handoff_marshal"):
                    frame = rolemsg.pack_fwd_request(
                        [reqs[i].marshal() for i in idxs],
                        [rolemsg.OP_SERIALIZABLE
                         if reqs[i].serializable else 0
                         for i in idxs], reply)
                out = self.pool.post(("batch", sid),
                                     self.shard_urls[sid],
                                     ROLE_FWD_PATH, frame)
                if out is None or out[0] != 200:
                    raise EtcdError(ECODE_RAFT_INTERNAL,
                                    f"shard {sid} unreachable")
                with tracer.stage("role.handoff_parse"):
                    if reply == rolemsg.REPLY_ACKS:
                        _n, sub = rolemsg.unpack_fwd_acks(out[1])
                    else:
                        svals, sub = rolemsg.unpack_fwd_vals(out[1])
                        for j, i in enumerate(idxs):
                            vals[i] = svals[j]
            except Exception as e:
                code = getattr(e, "error_code", ECODE_RAFT_INTERNAL)
                for i in idxs:
                    errs[i] = (code, str(e))
                continue
            for j, (code, msg) in sub.items():
                errs[idxs[j]] = (code, msg)
        return vals, errs

    def route_propose_many(self, method, path, query, headers,
                           body) -> tuple[int, dict, bytes]:
        try:
            from .distserver import unpack_requests

            with tracer.stage("dist.parse_batch"):
                reqs = unpack_requests(body)
            _, errs = self._forward_batch(reqs, rolemsg.REPLY_ACKS)
            if clientmsg.CONTENT_TYPE in (headers.get("accept")
                                          or ""):
                with tracer.stage("client.marshal"):
                    out = bytes(clientmsg.pack_propose_response(
                        len(reqs), errs))
                return 200, {"Content-Type":
                             clientmsg.CONTENT_TYPE}, out
            with tracer.stage("client.marshal"):
                out = json.dumps(
                    {"n": len(reqs),
                     "errs": {str(i): {"errorCode": c, "message": m}
                              for i, (c, m) in errs.items()}}
                ).encode()
            return 200, {"Content-Type": "application/json"}, out
        except Exception as e:
            return 400, {}, json.dumps(
                {"ok": False, "message": str(e)}).encode()

    def route_get_many(self, method, path, query, headers,
                       body) -> tuple[int, dict, bytes]:
        try:
            from .distserver import unpack_requests
            from ..wire.requests import Request

            if body[:1] == b"[":
                with tracer.stage("client.parse"):
                    paths = json.loads(body)
                    if not all(isinstance(p, str) for p in paths):
                        raise ValueError("path list must be strings")
                    reqs = [Request(method="GET", path=p,
                                    id=gen_id()) for p in paths]
            elif body[:4] == b"DCB1":
                with tracer.stage("client.parse"):
                    reqs = [Request(method="GET", path=p,
                                    id=gen_id())
                            for p in clientmsg.unpack_get_request(
                                body)]
            else:
                with tracer.stage("dist.parse_batch"):
                    reqs = unpack_requests(body)
            vals, errs = self._forward_batch(reqs,
                                             rolemsg.REPLY_VALS)
            svals = [None if v is None else v.decode()
                     for v in vals]
            if clientmsg.CONTENT_TYPE in (headers.get("accept")
                                          or ""):
                with tracer.stage("client.marshal"):
                    out = clientmsg.pack_get_response(svals, errs)
                return 200, {"Content-Type":
                             clientmsg.CONTENT_TYPE}, bytes(out)
            with tracer.stage("client.marshal"):
                out = json.dumps(
                    {"n": len(reqs), "vals": svals,
                     "errs": {str(i): {"errorCode": c, "message": m}
                              for i, (c, m) in errs.items()}}
                ).encode()
            return 200, {"Content-Type": "application/json"}, out
        except Exception as e:
            return 400, {}, json.dumps(
                {"ok": False, "message": str(e)}).encode()


def _obs_routes(flight: FlightRecorder) -> dict:
    """/mraft/obs + /mraft/obs/flight + /mraft/obs/timeseries +
    /mraft/obs/slo for a role process — same shapes the shard's
    peer tier serves, so harvest_rings and the bench stage scraper
    address every role uniformly."""
    return {
        "/mraft/obs": lambda *a: (
            200, {"Content-Type": "application/json"},
            _obs.registry.snapshot_json()),
        "/mraft/obs/light": lambda *a: (
            200, {"Content-Type": "application/json"},
            _obs.registry.snapshot_json(light=True)),
        "/mraft/obs/flight": lambda *a: (
            200, {"Content-Type": "application/json"},
            flight.dump_json()),
        "/mraft/obs/timeseries": lambda *a: (
            200, {"Content-Type": "application/json"},
            _timeseries.start_default().snapshot_json()),
        "/mraft/obs/slo": lambda *a: (
            200, {"Content-Type": "application/json"},
            _slo.default_verdict_json()),
    }


def _start_role_obs() -> None:
    """Always-on per-role observability: the sampling profiler and
    the windowed-delta ring (both idempotent, both env-gated)."""
    _profiler.start_default()
    _timeseries.start_default()


def run_ingest(args) -> None:
    from .frontdoor import FrontDoorConfig, serve_frontdoor

    _arm_parent_death()
    done = _arm_signals()
    _start_role_obs()
    m = len(args.peers.split(","))
    flight = FlightRecorder(node=f"{args.name}-ingest",
                            slot=args.slot, role="ingest")
    install_crash_dump(flight, args.flight_dir)
    remote = RemoteEtcd("127.0.0.1", args.client_port,
                        args.peers.split(","), args.slot,
                        args.shards)
    routes = {
        "/mraft/propose_many": remote.route_propose_many,
        "/mraft/get_many": remote.route_get_many,
    }
    routes.update(_obs_routes(flight))
    serve_frontdoor(
        remote, "127.0.0.1", args.client_port,
        config=FrontDoorConfig.from_env(os.environ),
        extra_routes=routes,
        watch_redirect="http://127.0.0.1:%d" % worker_port(
            args.client_port, m))
    print("ROLE-READY ingest", flush=True)
    _serve_forever(done, remote.stop)


# -- worker role ------------------------------------------------------------


class WorkerEtcd:
    """The apply/watch worker's ``etcd`` seam: a mirror Store fed by
    the shards' committed streams.  Watches and local reads are
    real; anything needing consensus is refused (clients reach this
    port only via the ingest's watch redirect)."""

    def __init__(self, host: str, port: int):
        from ..store import Store

        self.store = Store()
        self.lock = threading.Lock()
        self.server_stats = _StubStats()
        self.leader_stats = _StubStats()
        self.cluster_store = _StubCluster([f"http://{host}:{port}"])

    def do(self, rr, timeout: float | None = None) -> Response:
        # apply_request_to_store has no GET branch (GETs never ride
        # the committed log) — serve the mirror read directly; store
        # errors (key not found, ...) propagate as EtcdError for the
        # front door to map
        if rr.method == "GET" and not rr.wait:
            with self.lock:
                return Response(event=self.store.get(
                    rr.path, rr.recursive, rr.sorted))
        raise EtcdError(ECODE_RAFT_INTERNAL,
                        "watch worker serves reads and watches only")

    def index(self) -> int:
        return self.store.index()

    def term(self) -> int:
        return 0


def run_worker(args) -> None:
    from .frontdoor import FrontDoorConfig, serve_frontdoor
    from ..wire.requests import Request

    _arm_parent_death()
    done = _arm_signals()
    _start_role_obs()
    m = len(args.peers.split(","))
    port = worker_port(args.client_port, m)
    flight = FlightRecorder(node=f"{args.name}-worker",
                            slot=args.slot, role="worker")
    install_crash_dump(flight, args.flight_dir)
    etcd = WorkerEtcd("127.0.0.1", port)
    rings = [attach_ring(ring_name(args.client_port, s))
             for s in range(args.shards)]
    stop = threading.Event()
    # (shard, group) -> highest applied gindex.  In-memory is
    # enough: the ring's shared tail cursor is the restart cursor —
    # a respawned worker resumes AFTER everything it already
    # consumed, so replay (double-apply) is structurally impossible.
    frontier: dict[tuple[int, int], int] = {}
    last_seq: dict[int, tuple[int, int]] = {}

    def consume() -> None:
        backoff = 0.0002
        while not stop.is_set():
            busy = False
            for sid, ring in enumerate(rings):
                data = ring.pop()
                if data is None:
                    continue
                busy = True
                try:
                    with tracer.stage("role.handoff_parse"):
                        seq, groups, gidx, blobs = \
                            rolemsg.unpack_commit(data)
                except FrameError as e:
                    log.warning("worker: bad commit frame from "
                                "shard %d: %s", sid, e)
                    continue
                gen = ring.generation
                prev = last_seq.get(sid)
                if prev is not None and prev[0] == gen \
                        and seq != prev[1] + 1:
                    # ring overran (or shard skipped): events were
                    # lost for fanout — loud, not fatal (watchers
                    # resync via waitIndex + 401 semantics)
                    log.warning(
                        "worker: commit seq gap from shard %d "
                        "(%d -> %d, %d ring drops)", sid,
                        prev[1], seq, ring.dropped)
                last_seq[sid] = (gen, seq)
                with etcd.lock, etcd.store.fanout_round(), \
                        tracer.stage("role.apply"):
                    for g, gi, blob in zip(groups.tolist(),
                                           gidx.tolist(), blobs):
                        key = (sid, int(g))
                        if int(gi) <= frontier.get(key, -1):
                            continue  # duplicate delivery guard
                        frontier[key] = int(gi)
                        try:
                            apply_request_to_store(
                                etcd.store, Request.unmarshal(blob))
                        except EtcdError:
                            # apply-time verdicts (CAS misses, ...)
                            # already went to the writer via the
                            # shard; the mirror only needs the state
                            pass
                        except Exception:
                            log.exception(
                                "worker: mirror apply failed")
            if busy:
                backoff = 0.0002
            else:
                time.sleep(backoff)
                backoff = min(backoff * 2, 0.002)

    threading.Thread(target=consume, daemon=True,
                     name="worker-consume").start()
    serve_frontdoor(etcd, "127.0.0.1", port,
                    config=FrontDoorConfig.from_env(os.environ),
                    extra_routes=_obs_routes(flight))
    print("ROLE-READY worker", flush=True)
    _serve_forever(done, stop.set)


# -- shard role -------------------------------------------------------------


def run_shard(args) -> None:
    from ..ops.crc_cuda import raw_crc_cuda
    from ..wal.backend_policy import get_policy
    from .distserver import DistServer

    _arm_parent_death()
    done = _arm_signals()
    _start_role_obs()
    s = args.shard_index
    peers = args.peers.split(",")
    g_local = args.groups // args.shards
    t0 = time.perf_counter()
    srv = DistServer(
        os.path.join(args.data_dir, f"shard{s}"), slot=args.slot,
        peer_urls=shard_peer_urls(peers, s), g=g_local,
        cap=args.cap, name=f"{args.name}-s{s}",
        max_batch_ents=args.max_batch_ents,
        tick_interval=args.tick_interval,
        post_timeout=args.post_timeout,
        election=args.election_ticks,
        pipeline_depth=args.pipeline_depth,
        coalesce_us=args.coalesce_us,
        snap_count=args.snap_count,
        lease_ticks=args.lease_ticks,
        device=os.environ.get("ETCD_TORCH_DEVICE") or None)
    restart_s = time.perf_counter() - t0
    decision = get_policy().decisions.get("restart") or {}
    print(json.dumps({
        "role": f"shard{s}", "pid": os.getpid(), "fresh": srv.fresh,
        "restart_s": None if srv.fresh else restart_s,
        "lane": None if srv.fresh else decision.get("route"),
        "raw_crc_launches": raw_crc_cuda.launches,
        "raw_crc_largest": list(raw_crc_cuda.largest),
        "device": str(srv.device)}), flush=True)
    srv.flight.role = f"shard{s}"
    install_crash_dump(srv.flight, args.flight_dir)
    srv.start()
    # committed-stream tap attached AFTER start(): WAL-replay
    # applies recover pre-crash state and must not re-enter the
    # worker's mirror (the ring tail already passed them)
    srv.commit_sink = CommitSink(
        attach_ring(ring_name(args.client_port, s)))
    if args.bootstrap:
        deadline = time.time() + 60.0
        while time.time() < deadline:
            lead = srv.mr.is_leader()
            if lead.all():
                break
            srv._campaign(~lead)
            time.sleep(0.3)
    print(f"ROLE-READY shard{s}", flush=True)
    _serve_forever(done, srv.stop)


def _arm_signals() -> threading.Event:
    """Register the role's stop handler FIRST — install_crash_dump
    chains onto (and re-raises into) the disposition it finds, so
    the order is: dump the flight ring, then stop."""
    done = threading.Event()

    def _term(signum, frame):
        done.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    return done


def _serve_forever(done: threading.Event, on_stop) -> None:
    while not done.is_set():
        done.wait(1.0)
    try:
        on_stop()
    finally:
        os._exit(0)


# -- supervisor -------------------------------------------------------------

ROLES_FILE = "roles.json"


def supervisor_obs_port(client_port: int, m: int) -> int:
    """The supervisor's merged-plane port.  Hosts already occupy
    the [client, client+m) ingest and [client+m, client+2m) worker
    bands; +2m lands every host's supervisor in a third disjoint
    band."""
    return client_port + 2 * m


class SupervisorObs:
    """The supervisor's merged observability plane: one scrape
    thread pulls every child role's
    ``/mraft/obs`` snapshot into a
    :class:`~..obs.aggregate.MetricsAggregator` (stale-marked,
    monotone across respawns), feeds the merged cumulative view
    through a supervisor-level time-series ring, and serves:

    - ``/metrics`` — one Prometheus exposition of every role with a
      ``role`` label (0.0.4-conformant, HELP/TYPE once per family);
    - ``/mraft/obs`` — the merged JSON view + per-role liveness;
    - ``/mraft/obs/timeseries`` — the merged windowed-delta ring;
    - ``/mraft/obs/slo`` and ``/v2/stats/slo`` — the cluster-level
      SLO verdict evaluated over the merged ring;
    - ``/mraft/roles`` — role -> {port, up, stale_s} discovery.

    A down/mid-respawn child never yields a scrape error from these
    endpoints: its last-known samples stay, ``etcd_role_up`` drops
    to 0, and the next incarnation folds in monotone."""

    def __init__(self, targets: dict[str, int], port: int,
                 interval: float | None = None,
                 stale_after: float = _aggregate.STALE_AFTER_S,
                 self_registry: _obs.Registry | None = None,
                 host: str = "127.0.0.1"):
        self.targets = dict(targets)
        self.port = port
        if interval is None:
            try:
                interval = float(os.environ.get(
                    "ETCD_OBS_SCRAPE_S") or 1.0)
            except ValueError:
                interval = 1.0
        self.interval = interval
        self.host = host
        self._self_reg = self_registry
        self.agg = _aggregate.MetricsAggregator(
            stale_after=stale_after)
        self.ts = _timeseries.TimeSeries(self.agg.merged_families,
                                         step=interval)
        self.slo = _slo.SLOEvaluator(self.ts,
                                     registry=self_registry)
        self._stop = threading.Event()
        self._httpd: ThreadingHTTPServer | None = None

    # -- scraping ---------------------------------------------------------

    def scrape_once(self, timeout: float = 1.5) -> None:
        """One scrape round over every child, then one ring step
        over the merged view.  Child failures are absorbed (counted,
        stale-marked) — the merged plane never errors with them."""
        for role, port in sorted(self.targets.items()):
            # the light form: no exact-percentile ring sorts on the
            # child — the merge only consumes count/sum/buckets,
            # and the scrape runs every second on a shared core
            url = f"http://{self.host}:{port}/mraft/obs/light"
            try:
                with urllib.request.urlopen(url, timeout=timeout) \
                        as resp:
                    snap = json.loads(resp.read())
                self.agg.observe(role, snap)
                outcome = "ok"
            except Exception:
                self.agg.scrape_failed(role)
                outcome = "error"
            if self._self_reg is not None:
                self._self_reg.counter(
                    "etcd_obs_scrape_total", role=role,
                    outcome=outcome).inc()
        if self._self_reg is not None:
            # the supervisor is itself a role in the merged view
            self.agg.observe("supervisor",
                             self._self_reg.snapshot(light=True))
        self.ts.step_once()

    def _scrape_loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.scrape_once()
            except Exception:  # pragma: no cover - defensive
                log.exception("roles: supervisor scrape failed")

    # -- serving ----------------------------------------------------------

    def roles_body(self) -> bytes:
        live = self.agg.roles()
        body = {role: dict(port=port, **live.get(role, {}))
                for role, port in self.targets.items()}
        body["supervisor"] = {"port": self.port, "up": True}
        return (json.dumps({"roles": body}, sort_keys=True)
                + "\n").encode()

    def _make_handler(self):
        obs = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # pragma: no cover - quiet
                pass

            def do_GET(self):
                try:
                    ctype = "application/json"
                    if self.path == "/metrics":
                        body = render_prometheus_snapshot(
                            obs.agg.merged_families())
                        ctype = _PROM_CTYPE
                    elif self.path == "/mraft/obs":
                        body = obs.agg.merged_json()
                    elif self.path == "/mraft/obs/timeseries":
                        body = obs.ts.snapshot_json()
                    elif self.path in ("/mraft/obs/slo",
                                       "/v2/stats/slo"):
                        body = obs.slo.verdict_json()
                    elif self.path == "/mraft/roles":
                        body = obs.roles_body()
                    else:
                        self.send_response(404)
                        self.send_header("Content-Length", "0")
                        self.end_headers()
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length",
                                     str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except Exception:  # pragma: no cover - conn died
                    pass

        return Handler

    def start(self) -> "SupervisorObs":
        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          self._make_handler())
        self._httpd.daemon_threads = True
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True,
                         name="supervisor-obs-http").start()
        threading.Thread(target=self._scrape_loop, daemon=True,
                         name="supervisor-obs-scrape").start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()


class Supervisor:
    """Spawns and nurses the role tree for one host slot."""

    def __init__(self, args):
        self.args = args
        self.m = len(args.peers.split(","))
        self.children: dict[str, subprocess.Popen] = {}
        self.ports: dict[str, int] = {}
        self.rings: list[ShmRing] = []
        self.stopping = False
        self._spawned_at: dict[str, float] = {}
        self.obs: SupervisorObs | None = None

    def role_names(self) -> list[str]:
        return (["ingest", "worker"]
                + [f"shard{s}" for s in range(self.args.shards)])

    def _child_argv(self, role: str) -> list[str]:
        a = self.args
        argv = [sys.executable, "-m", "etcd_tpu_torch.server.roles",
                "--role", {"ingest": "ingest",
                           "worker": "worker"}.get(role, "shard"),
                "--data-dir", a.data_dir, "--slot", str(a.slot),
                "--peers", a.peers,
                "--client-port", str(a.client_port),
                "--shards", str(a.shards),
                "--groups", str(a.groups), "--cap", str(a.cap),
                "--name", a.name,
                "--max-batch-ents", str(a.max_batch_ents),
                "--pipeline-depth", str(a.pipeline_depth),
                "--coalesce-us", str(a.coalesce_us),
                "--lease-ticks", str(a.lease_ticks),
                "--election-ticks", str(a.election_ticks),
                "--tick-interval", str(a.tick_interval),
                "--post-timeout", str(a.post_timeout),
                "--flight-dir", a.flight_dir]
        if a.snap_count is not None:
            argv += ["--snap-count", str(a.snap_count)]
        if role.startswith("shard"):
            argv += ["--shard-index", role[5:]]
            if a.bootstrap and role not in self._spawned_at:
                argv += ["--bootstrap"]
        return argv

    def _port_of(self, role: str) -> int:
        a = self.args
        if role == "ingest":
            return a.client_port
        if role == "worker":
            return worker_port(a.client_port, self.m)
        s = int(role[5:])
        base = a.peers.split(",")[a.slot]
        return int(base.rpartition(":")[2]) + self.m * s

    def spawn(self, role: str) -> None:
        argv = self._child_argv(role)
        self.children[role] = subprocess.Popen(argv)
        self.ports[role] = self._port_of(role)
        self._spawned_at[role] = time.monotonic()
        self._write_roles_file()
        log.info("roles: spawned %s pid=%d port=%d", role,
                 self.children[role].pid, self.ports[role])

    def _write_roles_file(self) -> None:
        path = os.path.join(self.args.data_dir, ROLES_FILE)
        tmp = path + ".tmp"
        body = {r: {"pid": p.pid, "port": self.ports[r]}
                for r, p in self.children.items()}
        if self.obs is not None:
            body["supervisor"] = {"pid": os.getpid(),
                                  "port": self.obs.port}
        with open(tmp, "w") as f:
            json.dump(body, f)
        os.replace(tmp, path)

    def start(self) -> None:
        os.makedirs(self.args.data_dir, exist_ok=True)
        for s in range(self.args.shards):
            name = ring_name(self.args.client_port, s)
            # reclaim any segment a SIGKILLed previous supervisor
            # left behind — deterministic names make the leak
            # self-healing
            try:
                ShmRing(name).unlink()
            except (FileNotFoundError, ValueError, FrameError):
                pass
            self.rings.append(ShmRing(name, capacity=RING_BYTES,
                                      create=True))
        for role in self.role_names():
            self.spawn(role)
        try:
            self.obs = SupervisorObs(
                dict(self.ports),
                supervisor_obs_port(self.args.client_port, self.m),
                self_registry=_obs.registry).start()
            self._write_roles_file()  # now carries the supervisor
        except OSError as e:
            # the merged plane is additive — a squatted obs port
            # must never take the serving tree down with it
            log.warning("roles: merged obs plane unavailable: %s",
                        e)
            self.obs = None

    def wait_ready(self, timeout: float = 90.0) -> bool:
        """Every role port answers (and, with --bootstrap, every
        shard leads all its groups)."""
        deadline = time.time() + timeout
        probes = {
            r: (f"http://127.0.0.1:{self._port_of(r)}"
                + ("/mraft/leaders" if r.startswith("shard")
                   else "/v2/machines"))
            for r in self.role_names()}
        pending = dict(probes)
        while time.time() < deadline:
            for r, u in list(pending.items()):
                try:
                    with urllib.request.urlopen(u, timeout=2.0) \
                            as resp:
                        body = resp.read()
                except Exception:
                    continue
                if r.startswith("shard") and self.args.bootstrap:
                    try:
                        if not all(json.loads(body)["lead"]):
                            continue
                    except Exception:
                        continue
                del pending[r]
            if not pending:
                return True
            time.sleep(0.2)
        log.warning("roles: not ready after %.0fs: %s", timeout,
                    sorted(pending))
        return False

    def run(self) -> None:
        """Nurse loop: respawn dead children until stopped."""
        while not self.stopping:
            for role, proc in list(self.children.items()):
                if proc.poll() is None or self.stopping:
                    continue
                age = time.monotonic() - self._spawned_at[role]
                log.warning("roles: %s (pid %d) exited rc=%s after "
                            "%.1fs; respawning", role, proc.pid,
                            proc.returncode, age)
                if age < 0.5:
                    time.sleep(0.5)  # crash-loop damper
                self.spawn(role)
            time.sleep(0.2)

    def stop(self) -> None:
        self.stopping = True
        if self.obs is not None:
            self.obs.stop()
        for proc in self.children.values():
            if proc.poll() is None:
                proc.terminate()
        deadline = time.time() + 5.0
        for proc in self.children.values():
            try:
                proc.wait(timeout=max(0.1,
                                      deadline - time.time()))
            except subprocess.TimeoutExpired:
                proc.kill()
        for ring in self.rings:
            ring.close()
            ring.unlink()


def supervise(args) -> None:
    _profiler.start_default()
    sup = Supervisor(args)

    def _term(signum, frame):
        sup.stop()
        os._exit(0)

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    sup.start()
    sup.wait_ready()
    print("READY", flush=True)
    try:
        sup.run()
    finally:
        sup.stop()


# -- CLI --------------------------------------------------------------------


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="etcd_tpu_torch.server.roles")
    ap.add_argument("--role", required=True,
                    choices=["supervise", "ingest", "worker",
                             "shard"])
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--slot", type=int, required=True)
    ap.add_argument("--peers", required=True,
                    help="comma-separated slot-indexed peer base "
                         "URLs (shard 0 plane; shard s strides by "
                         "the host count)")
    ap.add_argument("--client-port", type=int, required=True)
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--shard-index", type=int, default=0)
    ap.add_argument("--groups", type=int, default=8,
                    help="TOTAL groups across shards (must divide "
                         "evenly)")
    ap.add_argument("--cap", type=int, default=64)
    ap.add_argument("--name", default="dist")
    ap.add_argument("--max-batch-ents", type=int, default=32)
    ap.add_argument("--pipeline-depth", type=int, default=8)
    ap.add_argument("--coalesce-us", type=int, default=2000)
    ap.add_argument("--lease-ticks", type=int, default=30)
    ap.add_argument("--election-ticks", type=int, default=60)
    ap.add_argument("--tick-interval", type=float, default=0.05)
    ap.add_argument("--post-timeout", type=float, default=2.0)
    ap.add_argument("--snap-count", type=int, default=None)
    ap.add_argument("--flight-dir", default="trace_artifacts")
    ap.add_argument("--bootstrap", action="store_true")
    return ap


def main(argv=None) -> None:
    ap = make_parser()
    args = ap.parse_args(argv)
    if args.groups % args.shards:
        ap.error(f"--groups {args.groups} must divide by "
                 f"--shards {args.shards}")
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s " + args.role + " %(message)s")
    if args.role == "supervise":
        supervise(args)
    elif args.role == "ingest":
        run_ingest(args)
    elif args.role == "worker":
        run_worker(args)
    else:
        run_shard(args)


if __name__ == "__main__":
    main()
