"""Server orchestration: the hub tying Node+WAL+snap+store+sender
together (reference etcdserver/server.go; the port's copy of
``etcd_tpu/server/server.py``).

One apply-loop thread runs the reference's ``run()`` select loop
(server.go:247-323): tick the raft clock, pull Ready batches, persist
HardState+entries BEFORE sending messages (the durability contract),
apply committed entries to the store, trigger waiting clients, fire
snapshots every ``snap_count`` applies, and propose leader SYNCs that
expire TTL keys deterministically cluster-wide.  The co-hosted server
(``multigroup.py``) and the distributed tier share its serving seams:
``Response``, ``apply_request_to_store``, ``gen_id``, the two server
errors, ``DEFAULT_SNAP_COUNT`` and the restart replay
``_replay_wal_raw``.

The restart differs from the reference in four ways:

- ``--storage-backend=tpu`` keeps its promise without the router's
  ``strict_device`` flag: it replays on the ``stream`` lane (unless the
  ``ETCD_REPLAY_BACKEND`` override names another), recorded as the
  router would record it.
- Only a crash-torn tail (:class:`TornTailError`, never acked) goes to
  the host repair path, on every backend; any other failure of a lane
  raises instead of falling back to the host, so a failed kernel is
  never hidden.
- ``device`` is passed through to the replay lanes, the router's probe
  and the snapshot hash (CUDA unless the caller asks for the CPU).
- The snapshot hash is ``ops.crc_kernel.auto_crc32c`` on that device
  whenever the backend is not ``host``; there is no host fallback for
  a missing device library.
"""

from __future__ import annotations

import functools
import json
import logging
import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from ..raft import Node, Peer, STATE_LEADER, restart_node, start_node
from ..snap import NoSnapshotError, Snapshotter
from ..store import Store, Watcher
from ..utils.backoff import Backoff
from ..utils.errors import EtcdError, EtcdNoSpace
from ..utils.trace import tracer
from ..utils.wait import Wait
from ..wal import WAL, TornTailError, exist as wal_exist
from ..wal.backend_policy import DEVICE_MIN_BYTES, get_policy
from ..wire import (
    CONF_CHANGE_ADD_NODE,
    CONF_CHANGE_REMOVE_NODE,
    ConfChange,
    ENTRY_CONF_CHANGE,
    ENTRY_NORMAL,
    HardState,
    MSG_APP,
    Message,
    Snapshot,
    is_empty_snap,
)
from ..wire.requests import Info, Request
from ..obs import metrics as _obs
from .cluster import ATTRIBUTES_SUFFIX, Cluster, ClusterStore, Member
from .stats import LeaderStats, ServerStats
from .config import ServerConfig
from .sender import new_sender

log = logging.getLogger(__name__)

# classic-tier read accounting: plain GETs here are local-replica
# (serializable) serves; see the do() comment
_M_READ_SERIALIZABLE = _obs.registry.counter(
    "etcd_read_serve_total", path="serializable", outcome="ok")

DEFAULT_SYNC_TIMEOUT = 1.0
DEFAULT_SNAP_COUNT = 10000  # reference server.go:29
DEFAULT_PUBLISH_RETRY_INTERVAL = 5.0

TICK_INTERVAL = 0.1       # reference server.go:182
SYNC_INTERVAL = 0.5       # reference server.go:183
ELECTION_TICKS = 10       # reference server.go:136,168
HEARTBEAT_TICKS = 1


class UnknownMethodError(Exception):
    pass


class ServerStoppedError(Exception):
    pass


def gen_id() -> int:
    """Random nonzero 63-bit id (reference server.go:575-580)."""
    n = 0
    while n == 0:
        n = random.getrandbits(63)
    return n


@dataclass
class Response:
    """Reference server.go:45-49."""

    event: object | None = None
    watcher: Optional[Watcher] = None
    err: Exception | None = None


def apply_request_to_store(store: Store, r: Request) -> Response:
    """Map a committed Request onto a store call (reference
    server.go:503-540); shared by the single-group server and the
    co-hosted multi-group server (multigroup.py)."""
    expr = r.expiration / 1e9 if r.expiration else None

    def f(call):
        try:
            return Response(event=call())
        except EtcdError as e:
            return Response(err=e)

    if r.method == "POST":
        return f(lambda: store.create(r.path, r.dir, r.val, True, expr))
    if r.method == "PUT":
        exists, exists_set = r.prev_exist, r.prev_exist is not None
        if exists_set:
            if exists:
                return f(lambda: store.update(r.path, r.val, expr))
            return f(lambda: store.create(r.path, r.dir, r.val, False,
                                          expr))
        if r.prev_index > 0 or r.prev_value != "":
            return f(lambda: store.compare_and_swap(
                r.path, r.prev_value, r.prev_index, r.val, expr))
        return f(lambda: store.set(r.path, r.dir, r.val, expr))
    if r.method == "DELETE":
        if r.prev_index > 0 or r.prev_value != "":
            return f(lambda: store.compare_and_delete(
                r.path, r.prev_value, r.prev_index))
        return f(lambda: store.delete(r.path, r.dir, r.recursive))
    if r.method == "QGET":
        # through-the-log quorum read: counted at apply — every
        # replica applies the entry, so per-host stats attribute the
        # replication cost, not just the origin's serve (split)
        store.stats.inc_read_path("quorum")
        return f(lambda: store.get(r.path, r.recursive, r.sorted))
    if r.method == "SYNC":
        store.delete_expired_keys(r.time / 1e9)
        return Response()
    return Response(err=UnknownMethodError(r.method))


class WalSnapStorage:
    """The Storage seam (reference server.go:51-62): WAL + snapshotter
    behind one interface so the device-backed replay path can swap in."""

    def __init__(self, wal: WAL, snapshotter: Snapshotter):
        self.wal = wal
        self.snapshotter = snapshotter

    def save(self, st: HardState, ents) -> None:
        """MUST block until st and ents are on stable storage."""
        self.wal.save(st, ents)

    def save_snap(self, snap: Snapshot) -> None:
        self.snapshotter.save_snap(snap)

    def cut(self) -> None:
        self.wal.cut()

    def probe_space(self) -> None:
        """NOSPACE recovery probe: raises EtcdNoSpace while
        the disk still refuses."""
        self.wal.probe_space()

    def gc(self, index: int) -> int:
        """Segment GC behind the DURABLE snapshot window: the
        run loop calls this right after ``save_snap`` returns — the
        snapshotter fsyncs file+dir before returning, so the
        delete-after-fsync ordering holds.  The boundary is the
        OLDEST retained snapshot (not ``index``, the newest): the
        corrupt-newest fallback ladder needs WAL coverage from
        whichever kept snapshot load() lands on."""
        floor = self.snapshotter.retained_floor()
        return self.wal.gc(index if floor is None
                           else min(index, floor))


class EtcdServer:
    """Reference server.go:191-218."""

    def __init__(self, *, store: Store, node: Node, id: int,
                 attributes: dict, storage, send: Callable,
                 cluster_store: ClusterStore,
                 snap_count: int = DEFAULT_SNAP_COUNT,
                 tick_interval: float = TICK_INTERVAL,
                 sync_interval: float = SYNC_INTERVAL,
                 leader_stats: LeaderStats | None = None):
        self.store = store
        self.node = node
        self.id = id
        self.attributes = attributes
        self.storage = storage
        self.send = send
        self.cluster_store = cluster_store
        self.snap_count = snap_count or DEFAULT_SNAP_COUNT
        self.tick_interval = tick_interval
        self.sync_interval = sync_interval

        self.w = Wait()
        self.done = threading.Event()
        self._thread: threading.Thread | None = None
        self._publish_thread: threading.Thread | None = None
        self.raft_index = 0
        self.raft_term = 0
        # NOSPACE read-only mode: a persist that hits
        # EtcdNoSpace HOLDS its Ready — the Ready contract (persist
        # before send) is preserved by simply not advancing: no
        # messages leave, nothing applies, writes are rejected with
        # errorCode 405, and the held Ready is re-persisted at probe
        # cadence until the disk takes it.  The node just experiences
        # a very slow disk.
        self._nospace = False
        self._held_ready = None
        self._nospace_backoff = Backoff(base=0.25, cap=5.0,
                                        site="nospace_probe")
        self._nospace_probe_t = 0.0
        self._m_nospace = _obs.registry.gauge("etcd_nospace_active")
        self.server_stats = ServerStats(
            attributes.get("Name", ""), id)
        self.leader_stats = leader_stats or LeaderStats(id)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Reference server.go:223-241."""
        self._start()
        self._publish_thread = threading.Thread(
            target=self.publish, args=(DEFAULT_PUBLISH_RETRY_INTERVAL,),
            daemon=True)
        self._publish_thread.start()

    def _start(self) -> None:
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.node.stop()
        self.done.set()
        # the apply loop itself calls stop() on should_stop
        # (server.go:295-298); a thread cannot join itself
        if self._thread is not None \
                and self._thread is not threading.current_thread():
            self._thread.join(timeout=5)
        # release the fanout dispatcher/delivery threads AFTER the
        # apply loop joined — a batch it submits mid-shutdown must
        # still dispatch (close drains the queue before exiting; a
        # close-then-submit would strand events).  getattr: test
        # scaffolds build bare servers without a store
        st = getattr(self, "store", None)
        if st is not None:
            st.fanout.close()

    # -- raft message input ------------------------------------------------

    def process(self, m: Message) -> None:
        """Peer /raft endpoint feeds here (server.go:243-245)."""
        if m.type == MSG_APP:
            self.server_stats.recv_append()
        self.node.step(m)

    # -- the apply loop ----------------------------------------------------

    def run(self) -> None:
        """Reference server.go:247-323."""
        is_leader = False
        snapi = 0
        appliedi = 0
        nodes: list[int] = []
        next_tick = time.monotonic() + self.tick_interval
        next_sync = time.monotonic() + self.sync_interval

        while not self.done.is_set():
            now = time.monotonic()
            if now >= next_tick:
                self.node.tick()
                next_tick = now + self.tick_interval
            if is_leader and now >= next_sync:
                # no SYNC proposals while read-only: the node's
                # in-memory log must not outgrow a WAL that cannot
                # take records (same guard as the dist/multigroup
                # tiers)
                if not self._nospace:
                    self.sync(DEFAULT_SYNC_TIMEOUT)
                next_sync = now + self.sync_interval

            wait_for = min(next_tick - now,
                           (next_sync - now) if is_leader else
                           self.tick_interval)
            if self._nospace and self._held_ready is None \
                    and time.monotonic() >= self._nospace_probe_t:
                # snapshot-triggered NOSPACE (no Ready to hold):
                # probe the disk directly
                try:
                    probe = getattr(self.storage, "probe_space",
                                    None)
                    if probe is not None:
                        probe()
                    self._exit_nospace()
                except EtcdNoSpace as e:
                    self._enter_nospace(None, e)
            if self._held_ready is not None:
                # NOSPACE hold: don't pop further Readys (the node's
                # unsent messages and unapplied commits queue behind
                # this one); retry the held persist at probe cadence
                if time.monotonic() < self._nospace_probe_t:
                    self.done.wait(max(min(wait_for, 0.05), 0.001))
                    continue
                rd = self._held_ready
            else:
                rd = self.node.ready(timeout=max(wait_for, 0.001))
                if rd is None:
                    continue

            # persist BEFORE send (the Ready contract, node.go:41-60)
            try:
                with tracer.stage("server.persist"):
                    self.storage.save(rd.hard_state, rd.entries)
                    self.storage.save_snap(rd.snapshot)
                    if not is_empty_snap(rd.snapshot):
                        # the snapshot just became durable (file +
                        # dir fsync inside save_snap): segments
                        # wholly behind it are dead weight — GC
                        # here, never before the fsync
                        # (delete-after-fsync rule).  getattr: the
                        # Storage seam is duck-typed and test
                        # recorders predate gc()
                        gc = getattr(self.storage, "gc", None)
                        if gc is not None:
                            gc(rd.snapshot.index)
            except EtcdNoSpace as e:
                self._enter_nospace(rd, e)
                continue
            if self._held_ready is not None:
                self._exit_nospace()
            for m in rd.messages:
                if m.type == MSG_APP:
                    self.server_stats.send_append()
            with tracer.stage("server.send"):
                self.send(rd.messages)

            # one fanout dispatch per committed batch: mutations only
            # queue their events; match + watcher delivery happen on
            # the engine's thread after this block
            with tracer.stage("server.apply"), self.store.fanout_round():
                for e in rd.committed_entries:
                    if e.type == ENTRY_NORMAL:
                        r = Request.unmarshal(e.data)
                        self.w.trigger(r.id, self.apply_request(r))
                    elif e.type == ENTRY_CONF_CHANGE:
                        cc = ConfChange.unmarshal(e.data)
                        self.apply_conf_change(cc)
                        self.w.trigger(cc.id, None)
                    else:  # pragma: no cover
                        raise AssertionError("unexpected entry type")
                    self.raft_index = e.index
                    self.raft_term = e.term
                    appliedi = e.index

            if rd.soft_state is not None:
                nodes = rd.soft_state.nodes
                is_leader = rd.soft_state.raft_state == STATE_LEADER
                self.server_stats.set_state(
                    rd.soft_state.raft_state, rd.soft_state.lead)
                if rd.soft_state.should_stop:
                    self.stop()
                    return

            if rd.snapshot.index > snapi:
                snapi = rd.snapshot.index

            # recover from snapshot if it is more updated than applied
            # (server.go:306-311)
            if rd.snapshot.index > appliedi:
                self.store.recovery(rd.snapshot.data)
                appliedi = rd.snapshot.index

            if appliedi - snapi > self.snap_count:
                try:
                    self.snapshot(appliedi, nodes)
                except EtcdNoSpace as e:
                    # no Ready to hold here — just go read-only and
                    # probe; the snapshot trigger re-fires once
                    # space returns
                    self._enter_nospace(None, e)
                snapi = appliedi

    # -- NOSPACE read-only mode ------------------------------------

    def _enter_nospace(self, rd, e: EtcdNoSpace) -> None:
        if rd is not None:
            self._held_ready = rd
        if not self._nospace:
            self._nospace = True
            self._nospace_backoff.reset()
            self._m_nospace.set(1)
            log.error("etcdserver: ENTERING NOSPACE read-only mode "
                      "(%s): writes rejected with errorCode 405, "
                      "reads keep serving", e.cause)
        self._nospace_probe_t = (time.monotonic()
                                 + self._nospace_backoff.next())

    def _exit_nospace(self) -> None:
        self._held_ready = None
        if self._nospace:
            self._nospace = False
            self._nospace_backoff.reset()
            self._m_nospace.set(0)
            log.warning("etcdserver: NOSPACE recovered — accepting "
                        "writes again")

    # -- client request path -----------------------------------------------

    def do(self, r: Request, timeout: float | None = None) -> Response:
        """Propose writes/quorum-GETs through raft; serve plain
        GET/watch locally (reference server.go:337-380)."""
        if r.id == 0:
            raise ValueError("r.id cannot be 0")
        if r.method == "GET" and r.quorum:
            r.method = "QGET"
        if r.method in ("POST", "PUT", "DELETE", "QGET"):
            if self._nospace:
                # read-only NOSPACE mode: the distinct error code,
                # not a timeout (reads below still serve)
                raise EtcdNoSpace(
                    cause="member is read-only (NOSPACE)")
            data = r.marshal()
            ch = self.w.register(r.id)
            try:
                self.node.propose(data, timeout=timeout)
            except TimeoutError:
                self.w.trigger(r.id, None)  # GC wait
                raise
            import queue as _q

            try:
                x = ch.get(timeout=timeout)
            except _q.Empty:
                self.w.trigger(r.id, None)  # GC wait
                raise TimeoutError("request timed out")
            if x is None:
                # stop, a GC'd registration, or a duplicate request
                # id whose channel was already consumed (Chan is
                # one-shot: later receivers observe closure)
                if self.done.is_set():
                    raise ServerStoppedError()
                raise TimeoutError("request superseded")
            resp = x
            if resp.err is not None:
                raise resp.err
            return resp
        if r.method == "GET":
            if r.wait:
                wc = self.store.watch(r.path, r.recursive, r.stream,
                                      r.since)
                return Response(watcher=wc)
            # the classic tier keeps reference read semantics: a
            # plain GET serves the local replica, which on a
            # follower is a SERIALIZABLE read — counted as such so
            # the per-path split stays honest (linearizable reads
            # on this tier go through ?quorum=true; the zero-WAL
            # lease/ReadIndex machinery lives on the dist tier)
            _M_READ_SERIALIZABLE.inc()
            self.store.stats.inc_read_path("serializable")
            ev = self.store.get(r.path, r.recursive, r.sorted)
            return Response(event=ev)
        raise UnknownMethodError(r.method)

    # -- membership --------------------------------------------------------

    def add_member(self, memb: Member, timeout: float | None = None) -> None:
        """Reference server.go:382-395."""
        cc = ConfChange(id=gen_id(), type=CONF_CHANGE_ADD_NODE,
                        node_id=memb.id,
                        context=json.dumps(memb.to_dict()).encode())
        self._configure(cc, timeout)

    def remove_member(self, id: int, timeout: float | None = None) -> None:
        cc = ConfChange(id=gen_id(), type=CONF_CHANGE_REMOVE_NODE,
                        node_id=id)
        self._configure(cc, timeout)

    def _configure(self, cc: ConfChange,
                   timeout: float | None = None) -> None:
        """Reference server.go:417-433."""
        ch = self.w.register(cc.id)
        try:
            self.node.propose_conf_change(cc, timeout=timeout)
        except TimeoutError:
            self.w.trigger(cc.id, None)
            raise
        import queue as _q

        try:
            ch.get(timeout=timeout)
        except _q.Empty:
            self.w.trigger(cc.id, None)
            raise TimeoutError("conf change timed out")

    # -- RaftTimer ---------------------------------------------------------

    def index(self) -> int:
        return self.raft_index

    def term(self) -> int:
        return self.raft_term

    # -- periodic work -----------------------------------------------------

    def sync(self, timeout: float) -> None:
        """Leader-only SYNC proposal carrying wall time: applied
        deterministically as DeleteExpiredKeys cluster-wide
        (reference server.go:438-456)."""
        req = Request(method="SYNC", id=gen_id(),
                      time=int(time.time() * 1e9))
        data = req.marshal()

        def bg():
            try:
                self.node.propose(data, timeout=timeout)
            except (TimeoutError, Exception):
                pass

        threading.Thread(target=bg, daemon=True).start()

    def publish(self, retry_interval: float) -> None:
        """Register server attributes under its member key
        (reference server.go:463-491)."""
        b = json.dumps(self.attributes)
        req = Request(id=gen_id(), method="PUT",
                      path=Member(id=self.id).store_key()
                      + ATTRIBUTES_SUFFIX,
                      val=b)
        while not self.done.is_set():
            try:
                self.do(req, timeout=retry_interval)
                log.info("etcdserver: published %s to the cluster",
                         self.attributes)
                return
            except ServerStoppedError:
                return
            except Exception as e:
                log.warning("etcdserver: publish error: %s", e)
                req.id = gen_id()

    # -- apply -------------------------------------------------------------

    def apply_request(self, r: Request) -> Response:
        """Map a committed Request onto a store call
        (reference server.go:503-540)."""
        return apply_request_to_store(self.store, r)

    def apply_conf_change(self, cc: ConfChange) -> None:
        """Reference server.go:542-559."""
        self.node.apply_conf_change(cc)
        if cc.type == CONF_CHANGE_ADD_NODE:
            m = Member.from_dict(json.loads(cc.context))
            if cc.node_id != m.id:
                raise AssertionError("unexpected nodeID mismatch")
            self.cluster_store.add(m)
        elif cc.type == CONF_CHANGE_REMOVE_NODE:
            self.cluster_store.remove(cc.node_id)
        else:  # pragma: no cover
            raise AssertionError("unexpected ConfChange type")

    def snapshot(self, snapi: int, snapnodes: list[int]) -> None:
        """Store snapshot -> raft compaction -> WAL cut
        (reference server.go:562-571)."""
        with tracer.span("server.snapshot"):
            d = self.store.save()
            self.node.compact(snapi, snapnodes, d)
            self.storage.cut()


def _replay_wal_raw(waldir: str, index: int, backend: str,
                    stage: str = "restart", device=None):
    """WAL replay honoring --storage-backend (``host`` | ``tpu`` |
    ``auto``) through the measured router (``wal/backend_policy``), the
    decision recorded under ``stage``.

    - ``host``: the host path (``WAL.read_all`` with torn-tail repair).
    - ``tpu``: the ``stream`` lane on ``device`` (the raw-CRC kernel on
      the card), or the lane ``ETCD_REPLAY_BACKEND`` names.
    - ``auto``: the router's lane; below ``DEVICE_MIN_BYTES`` it answers
      ``host`` without touching the device, and the native host scan
      runs when the library loaded.

    The fast lanes return entries as an un-materialized ``EntryBlock``
    (struct-of-arrays, the form ``gereplay.scan`` feeds on); the
    repair-capable host path returns an Entry list.  A crash-torn tail
    (``TornTailError``) on a fast lane goes to the host repair path,
    which truncates it; any other failure raises.
    """
    if backend != "host":
        from .. import native
        from ..wal.replay_device import open_replay_device

        size = sum(os.path.getsize(os.path.join(waldir, f))
                   for f in os.listdir(waldir))
        pol = get_policy()
        if backend == "tpu":
            route, why = pol._env_route()
            if route is None:
                route, why = "stream", "strict_device"
            pol.note(stage, route, why, size_bytes=size)
        else:
            route = pol.route(stage, size_bytes=size, device=device)
        env_forced = pol.decisions[stage]["why"].startswith("env ")
        # the native host scan beats the pure-Python decoder at every
        # size; the device lanes keep the amortization threshold unless
        # the operator's override or the tpu backend demands them
        use_fast = (backend == "tpu" or env_forced
                    or size >= DEVICE_MIN_BYTES
                    or (route == "host" and native.available()))
        if use_fast:
            try:
                with tracer.span("replay.device"):
                    w, md, hard_state, block = open_replay_device(
                        waldir, index, route=route, device=device)
                log.info("etcdserver: %s-route replay of %d entries "
                         "(%d bytes)", route, len(block), size)
                return w, md, hard_state, block
            except TornTailError:
                # a crash-torn tail must heal on EVERY backend: the torn
                # bytes were never acked (acks only follow fsync)
                log.warning("etcdserver: %s-route replay found a torn "
                            "tail; host repair path", route)
                pol.note(stage, "host", f"{route} lane failed "
                         f"(TornTailError); host repair path")
    with tracer.span("replay.host"):
        w = WAL.open_at_index(waldir, index)
        md, hard_state, ents = w.read_all(repair=True)
    return w, md, hard_state, ents


def _replay_wal(waldir: str, index: int, backend: str, device=None):
    """WAL replay honoring --storage-backend (the north-star seam:
    same (metadata, state, entries) out of either execution path)."""
    from ..wal.replay_device import EntryBlock

    w, md, hard_state, out = _replay_wal_raw(waldir, index, backend,
                                             device=device)
    if isinstance(out, EntryBlock):
        out = out.entries()
    return w, md, hard_state, out


def new_server(cfg: ServerConfig, *, discoverer=None,
               post_fn=None, device=None) -> EtcdServer:
    """Bootstrap/restart split (reference server.go:87-188).  The
    restart's replay lanes and the snapshot hash run on ``device``
    (CUDA unless the caller names another; resolved before any disk
    mutation, so without CUDA it raises here)."""
    from .. import default_device
    from ..ops.crc_kernel import auto_crc32c, warm_device
    from ..snap import DEFAULT_SNAP_KEEP

    device = default_device(device)
    cfg.verify()
    crc_fn = None
    if getattr(cfg, "storage_backend", "auto") != "host":
        # large snapshot blobs hash on the card (the raw-CRC kernel)
        # when the one-time race says it wins; small ones on the host.
        # The card's first use is made here, not under the apply loop
        # at the first snapshot, where it outlasts the request timeout.
        crc_fn = functools.partial(auto_crc32c, device=device)
        warm_device(device)
    snapdir = os.path.join(cfg.data_dir, "snap")
    os.makedirs(snapdir, mode=0o700, exist_ok=True)

    ss = Snapshotter(snapdir, crc_fn=crc_fn,
                     keep=int(os.environ.get("ETCD_SNAP_KEEP",
                                             DEFAULT_SNAP_KEEP)))
    st = Store()
    # watch fanout runs on its own delivery stage so the apply loop
    # never blocks on watcher queues (ETCD_WATCH_WORKERS scales
    # delivery threads)
    st.fanout.start()
    m = cfg.cluster.find_name(cfg.name)
    waldir = os.path.join(cfg.data_dir, "wal")

    if not wal_exist(waldir):
        if cfg.discovery_url:
            if discoverer is None:
                from ..discovery import Discoverer

                discoverer = Discoverer(cfg.discovery_url, m.id,
                                        str(cfg.cluster))
            s = discoverer.discover()
            cfg.cluster.set_from_string(s)
        elif cfg.cluster_state != "new":
            raise RuntimeError(
                "initial cluster state unset and no wal or discovery "
                "URL found")
        w = WAL.create(waldir, Info(id=m.id).marshal())
        peers = [Peer(id=id, context=json.dumps(
            cfg.cluster[id].to_dict()).encode())
            for id in cfg.cluster.ids()]
        n = start_node(m.id, peers, ELECTION_TICKS, HEARTBEAT_TICKS)
    else:
        if cfg.discovery_url:
            log.warning(
                "etcd: ignoring discovery URL: etcd has already been "
                "initialized and has a valid log in %s", waldir)
        index = 0
        snapshot = None
        try:
            snapshot = ss.load()
        except NoSnapshotError:
            pass
        if snapshot is not None:
            log.info("etcdserver: restart from snapshot at index %d",
                     snapshot.index)
            st.recovery(snapshot.data)
            index = snapshot.index
        w, md, hard_state, ents = _replay_wal(
            waldir, index, getattr(cfg, "storage_backend", "auto"),
            device=device)
        info = Info.unmarshal(md or b"")
        if info.id != m.id:
            raise RuntimeError(
                f"unexpected nodeid {info.id:x}, want {m.id:x}")
        n = restart_node(m.id, ELECTION_TICKS, HEARTBEAT_TICKS, snapshot,
                         hard_state, ents)

    cls = ClusterStore(st)
    lstats = LeaderStats(m.id)
    return EtcdServer(
        store=st,
        node=n,
        id=m.id,
        attributes={"Name": cfg.name,
                    "ClientURLs": cfg.client_urls},
        storage=WalSnapStorage(w, ss),
        send=new_sender(cls, post_fn=post_fn, leader_stats=lstats,
                        tls_info=getattr(cfg, "peer_tls", None)),
        leader_stats=lstats,
        cluster_store=cls,
        snap_count=cfg.snap_count,
    )
