"""Hierarchical KV store with MVCC-ish indices, TTLs, and watches
(reference store/store.go).

Host-side by design: the pointer-chasing tree is the wrong shape for a
TPU; what moves to the device is the consensus/durability data plane
beneath it.  A stop-the-world RW lock guards the tree exactly like the
reference's worldLock (store.go:71).
"""

from __future__ import annotations

import json
import posixpath
import threading

from ..utils.errors import (
    ECODE_KEY_NOT_FOUND,
    ECODE_NODE_EXIST,
    ECODE_NOT_DIR,
    ECODE_NOT_FILE,
    ECODE_ROOT_RONLY,
    ECODE_TEST_FAILED,
    EtcdError,
)
from .event import (
    COMPARE_AND_DELETE,
    COMPARE_AND_SWAP,
    CREATE,
    DELETE,
    EXPIRE,
    GET,
    SET,
    UPDATE,
    new_event,
)
from .event_history import EventHistory
from .node_internal import (
    COMPARE_INDEX_NOT_MATCH,
    COMPARE_VALUE_NOT_MATCH,
    Node,
    PERMANENT,
    child_path,
)
from .stats import (
    COMPARE_AND_DELETE_FAIL,
    COMPARE_AND_DELETE_SUCCESS,
    COMPARE_AND_SWAP_FAIL,
    COMPARE_AND_SWAP_SUCCESS,
    CREATE_FAIL,
    CREATE_SUCCESS,
    DELETE_FAIL,
    DELETE_SUCCESS,
    EXPIRE_COUNT,
    GET_FAIL,
    GET_SUCCESS,
    SET_FAIL,
    SET_SUCCESS,
    Stats,
    UPDATE_FAIL,
    UPDATE_SUCCESS,
)
from .fanout import Emit, FanoutEngine
from .ttl_heap import TTLKeyHeap
from .watcher import Watcher, WatcherHub

from ..obs import metrics as _obs

_M_TTL_BATCH = _obs.registry.histogram("etcd_ttl_expire_batch_size")

DEFAULT_VERSION = 2

# expire times before this are treated as permanent (store.go:34-38)
MIN_EXPIRE_TIME = 946684800.0  # 2000-01-01T00:00:00Z


def clean_path(p: str) -> str:
    # fast path: an already-clean absolute path (the overwhelmingly
    # common case — client paths arrive cleaned once at the API
    # layer, then every store op re-cleans defensively; normpath's
    # python loop was ~20% of a Set in the reference-shape
    # microbench).  Conditions exactly delimit inputs normpath would
    # return unchanged: absolute, no empty/"."/".." segments, no
    # trailing slash (except root itself).
    if (p.startswith("/") and "//" not in p
            and (p == "/" or not p.endswith("/"))
            and "/./" not in p and "/../" not in p
            and not p.endswith(("/.", "/.."))):
        return p
    out = posixpath.normpath(posixpath.join("/", p))
    # Go's path.Clean collapses a leading double slash; POSIX normpath
    # preserves it
    if out.startswith("//"):
        out = out[1:]
    return out




def _compare_fail_cause(n: Node, which: int, prev_value: str,
                        prev_index: int) -> str:
    """Reference store.go:186-195."""
    if which == COMPARE_INDEX_NOT_MATCH:
        return f"[{prev_index} != {n.modified_index}]"
    if which == COMPARE_VALUE_NOT_MATCH:
        return f"[{prev_value} != {n.value}]"
    return (f"[{prev_value} != {n.value}] "
            f"[{prev_index} != {n.modified_index}]")


class Store:
    def __init__(self, history_capacity: int = 1000):
        self.current_version = DEFAULT_VERSION
        self.current_index = 0
        self.root = Node.new_dir(self, "/", self.current_index, None, "",
                                 PERMANENT)
        self.stats = Stats()
        self.watcher_hub = WatcherHub(history_capacity)
        self.ttl_key_heap = TTLKeyHeap()
        self.world_lock = threading.RLock()
        # batched watch fanout: mutations append committed
        # events here (under the world lock) and the engine matches +
        # delivers them AFTER the lock is released — per mutation on
        # a bare store, per apply round on the server tiers
        # (fanout_round), on the engine's own threads once a server
        # called fanout.start()
        self.fanout = FanoutEngine(self.watcher_hub)
        self._pending: list[Emit] = []
        self._round_depth = 0

    # -- queries -----------------------------------------------------------

    def version(self) -> int:
        return self.current_version

    def index(self) -> int:
        with self.world_lock:
            return self.current_index

    def get(self, node_path: str, recursive: bool, sorted_: bool) -> Event:
        """Reference store.go:103-123."""
        with self.world_lock:
            node_path = clean_path(node_path)
            try:
                n = self._internal_get(node_path)
            except EtcdError:
                self.stats.inc(GET_FAIL)
                raise
            e = new_event(GET, node_path, n.modified_index, n.created_index)
            e.etcd_index = self.current_index
            n.load_extern(e.node, recursive, sorted_)
            self.stats.inc(GET_SUCCESS)
            return e

    def get_value(self, node_path: str) -> str | None:
        """Leaf-value fast lane for the batched read path.

        ``get()`` allocates an Event + extern-node tree per call; at
        the tens-of-thousands-of-reads/s the zero-WAL lane serves,
        that allocation dominates the actual tree walk.  Same
        key-not-found EtcdError as get(); a directory yields None
        (the batched lane reads leaves — callers needing listings
        use the full form)."""
        with self.world_lock:
            node_path = clean_path(node_path)
            try:
                n = self._internal_get(node_path)
            except EtcdError:
                self.stats.inc(GET_FAIL)
                raise
            self.stats.inc(GET_SUCCESS)
            return None if n.is_dir() else n.value

    def get_values(self, paths: list[str]) -> list:
        """Batched leaf-value reads: ONE world-lock take and one
        stats update for the whole batch (the get_many lane serves
        hundreds of keys per call; a lock cycle per key is pure
        overhead there).  Per-path results: the value string, None
        for a directory, or the key-not-found EtcdError."""
        out: list = []
        ok = fail = 0
        with self.world_lock:
            for p in paths:
                try:
                    n = self._internal_get(clean_path(p))
                except EtcdError as e:
                    fail += 1
                    out.append(e)
                    continue
                ok += 1
                out.append(None if n.is_dir() else n.value)
        if ok:
            self.stats.inc(GET_SUCCESS, ok)
        if fail:
            self.stats.inc(GET_FAIL, fail)
        return out

    # -- fanout plumbing -------------------------------------------------

    def _emit(self, e: Event, removed: list[str] | None = None) -> None:
        """Record a committed event for fanout.  Call with the world
        lock held; dispatch happens after release — immediately
        (``fanout.kick`` at the end of the mutation) or at the end of
        the enclosing ``fanout_round``."""
        self._pending.append(Emit(e, removed))
        if self._round_depth == 0:
            batch, self._pending = self._pending, []
            self.fanout.submit(batch)

    def fanout_round(self):
        """Context manager batching every mutation inside it into ONE
        fanout dispatch — the apply loops wrap each committed batch in
        this, so an apply round costs one match sweep instead of a
        hub round trip per event."""
        return _FanoutRound(self)

    # -- mutations ---------------------------------------------------------

    def create(self, node_path: str, dir: bool, value: str, unique: bool,
               expire_time: float | None) -> Event:
        """Create; fails if the node exists (store.go:128-142)."""
        with self.world_lock:
            try:
                e = self._internal_create(node_path, dir, value, unique,
                                          False, expire_time, CREATE)
            except EtcdError:
                self.stats.inc(CREATE_FAIL)
                raise
            e.etcd_index = self.current_index
            self._emit(e)
            self.stats.inc(CREATE_SUCCESS)
        self.fanout.kick()
        return e

    def set(self, node_path: str, dir: bool, value: str,
            expire_time: float | None) -> Event:
        """Create or replace (store.go:145-183)."""
        with self.world_lock:
            prev = None
            try:
                prev = self._internal_get(node_path)
            except EtcdError as ge:
                if ge.error_code != ECODE_KEY_NOT_FOUND:
                    self.stats.inc(SET_FAIL)
                    raise
            try:
                e = self._internal_create(node_path, dir, value, False,
                                          True, expire_time, SET)
            except EtcdError:
                self.stats.inc(SET_FAIL)
                raise
            e.etcd_index = self.current_index
            if prev is not None:
                ext = prev.repr(False, False)
                ext.key = clean_path(node_path)
                e.prev_node = ext
            self._emit(e)
            self.stats.inc(SET_SUCCESS)
        self.fanout.kick()
        return e

    def update(self, node_path: str, new_value: str,
               expire_time: float | None) -> Event:
        """Update value/ttl of an existing node (store.go:397-449)."""
        with self.world_lock:
            node_path = clean_path(node_path)
            if node_path == "/":
                raise EtcdError(ECODE_ROOT_RONLY, "/", self.current_index)
            curr_index = self.current_index
            next_index = curr_index + 1
            try:
                n = self._internal_get(node_path)
            except EtcdError:
                self.stats.inc(UPDATE_FAIL)
                raise
            e = new_event(UPDATE, node_path, next_index, n.created_index)
            e.etcd_index = next_index
            e.prev_node = n.repr(False, False)

            if n.is_dir() and new_value:
                self.stats.inc(UPDATE_FAIL)
                raise EtcdError(ECODE_NOT_FILE, node_path, curr_index)

            if n.is_dir():
                e.node.dir = True
            else:
                n.write(new_value, next_index)
                e.node.value = new_value

            n.update_ttl(expire_time)
            e.node.expiration, e.node.ttl = n.expiration_and_ttl()

            self.current_index = next_index
            self._emit(e)
            self.stats.inc(UPDATE_SUCCESS)
        self.fanout.kick()
        return e

    def compare_and_swap(self, node_path: str, prev_value: str,
                         prev_index: int, value: str,
                         expire_time: float | None) -> Event:
        """Reference store.go:197-250."""
        with self.world_lock:
            node_path = clean_path(node_path)
            if node_path == "/":
                raise EtcdError(ECODE_ROOT_RONLY, "/", self.current_index)
            try:
                n = self._internal_get(node_path)
            except EtcdError:
                self.stats.inc(COMPARE_AND_SWAP_FAIL)
                raise
            if n.is_dir():
                self.stats.inc(COMPARE_AND_SWAP_FAIL)
                raise EtcdError(ECODE_NOT_FILE, node_path,
                                self.current_index)
            ok, which = n.compare(prev_value, prev_index)
            if not ok:
                cause = _compare_fail_cause(n, which, prev_value,
                                            prev_index)
                self.stats.inc(COMPARE_AND_SWAP_FAIL)
                raise EtcdError(ECODE_TEST_FAILED, cause,
                                self.current_index)

            self.current_index += 1
            e = new_event(COMPARE_AND_SWAP, node_path, self.current_index,
                          n.created_index)
            e.etcd_index = self.current_index
            e.prev_node = n.repr(False, False)

            n.write(value, self.current_index)
            n.update_ttl(expire_time)
            e.node.value = value
            e.node.expiration, e.node.ttl = n.expiration_and_ttl()

            self._emit(e)
            self.stats.inc(COMPARE_AND_SWAP_SUCCESS)
        self.fanout.kick()
        return e

    def delete(self, node_path: str, dir: bool, recursive: bool) -> Event:
        """Reference store.go:254-306."""
        with self.world_lock:
            node_path = clean_path(node_path)
            if node_path == "/":
                raise EtcdError(ECODE_ROOT_RONLY, "/", self.current_index)
            if recursive:  # recursive implies dir
                dir = True
            try:
                n = self._internal_get(node_path)
            except EtcdError:
                self.stats.inc(DELETE_FAIL)
                raise

            next_index = self.current_index + 1
            e = new_event(DELETE, node_path, next_index, n.created_index)
            e.etcd_index = next_index
            e.prev_node = n.repr(False, False)
            if n.is_dir():
                e.node.dir = True

            # removed subtree paths collect into the emit record; the
            # engine notifies each with deleted=True (the reference's
            # callback -> notifyWatchers shape, store.go:254-306)
            removed: list[str] = []
            try:
                n.remove(dir, recursive, removed.append)
            except EtcdError:
                self.stats.inc(DELETE_FAIL)
                raise

            self.current_index += 1
            self._emit(e, removed)
            self.stats.inc(DELETE_SUCCESS)
        self.fanout.kick()
        return e

    def compare_and_delete(self, node_path: str, prev_value: str,
                           prev_index: int) -> Event:
        """Reference store.go:308-353."""
        with self.world_lock:
            node_path = clean_path(node_path)
            try:
                n = self._internal_get(node_path)
            except EtcdError:
                self.stats.inc(COMPARE_AND_DELETE_FAIL)
                raise
            if n.is_dir():
                self.stats.inc(COMPARE_AND_SWAP_FAIL)
                raise EtcdError(ECODE_NOT_FILE, node_path,
                                self.current_index)
            ok, which = n.compare(prev_value, prev_index)
            if not ok:
                cause = _compare_fail_cause(n, which, prev_value,
                                            prev_index)
                self.stats.inc(COMPARE_AND_DELETE_FAIL)
                raise EtcdError(ECODE_TEST_FAILED, cause,
                                self.current_index)

            self.current_index += 1
            e = new_event(COMPARE_AND_DELETE, node_path,
                          self.current_index, n.created_index)
            e.etcd_index = self.current_index
            e.prev_node = n.repr(False, False)

            removed = []
            n.remove(False, False, removed.append)
            self._emit(e, removed)
            self.stats.inc(COMPARE_AND_DELETE_SUCCESS)
        self.fanout.kick()
        return e

    # -- watch -------------------------------------------------------------

    def watch(self, key: str, recursive: bool, stream: bool,
              since_index: int) -> Watcher:
        """Reference store.go:355-370."""
        with self.world_lock:
            key = clean_path(key)
            if since_index == 0:
                since_index = self.current_index + 1
            try:
                return self.watcher_hub.watch(key, recursive, stream,
                                              since_index,
                                              self.current_index)
            except EtcdError as e:
                e.index = self.current_index
                raise

    def watch_many(self, specs, mux=None, mid_base: int = 0) -> list:
        """Batched watch registration: one world-lock take to
        pin the since-index floor, then ONE hub-lock take for the
        whole batch — 100k watches cost two lock round trips, not
        100k.  ``specs`` is an iterable of
        ``(key, recursive, stream, since_index)`` (since 0 = future
        events only, like :meth:`watch`); returns a list aligned with
        it of Watchers (or the per-spec EtcdError a compacted history
        raised).  With ``mux`` set, events deliver into that shared
        :class:`~.fanout.WatchMux` tagged ``mid_base`` + spec
        position (callers registering in chunks pass the running
        offset)."""
        with self.world_lock:
            cur = self.current_index
        norm = [(clean_path(k), bool(r), bool(st),
                 (cur + 1 if since == 0 else since))
                for k, r, st, since in specs]
        return self.watcher_hub.watch_many(norm, cur, mux=mux,
                                           mid_base=mid_base)

    # -- TTL expiry --------------------------------------------------------

    def delete_expired_keys(self, cutoff: float) -> None:
        """Remove everything expiring at/before cutoff
        (store.go:559-587).  Driven by the leader's SYNC proposal so
        expiry is deterministic across the cluster.  The heap drains
        in ONE pass under the world lock and the whole EXPIRE batch
        rides one fanout dispatch — mass lease churn costs one match
        sweep, and no watcher queue is touched under the lock
        (the per-key pop/notify loop was the 2014 shape)."""
        n = 0
        with self.fanout_round():
            with self.world_lock:
                while True:
                    node = self.ttl_key_heap.top()
                    if node is None or node.expire_time > cutoff:
                        break
                    self.current_index += 1
                    e = new_event(EXPIRE, node.path, self.current_index,
                                  node.created_index)
                    e.etcd_index = self.current_index
                    e.prev_node = node.repr(False, False)

                    removed: list[str] = []
                    self.ttl_key_heap.pop()
                    node.remove(True, True, removed.append)
                    self._emit(e, removed)
                    n += 1
                if n:
                    self.stats.inc(EXPIRE_COUNT, n)
        if n:
            _M_TTL_BATCH.observe(n)

    # -- internals ---------------------------------------------------------

    def _walk(self, node_path: str, walk_func):
        """Reference store.go:373-392."""
        components = node_path.split("/")
        curr = self.root
        for comp in components[1:]:
            if not comp:
                return curr
            curr = walk_func(curr, comp)
        return curr

    def _internal_create(self, node_path: str, dir: bool, value: str,
                         unique: bool, replace: bool,
                         expire_time: float | None, action: str) -> Event:
        """Reference store.go:451-529."""
        curr_index = self.current_index
        next_index = curr_index + 1

        if unique:  # append unique item under the node path
            node_path += "/" + str(next_index)

        node_path = clean_path(node_path)
        if node_path == "/":
            raise EtcdError(ECODE_ROOT_RONLY, "/", curr_index)

        # expire times in the deep past mean permanent (store.go:467-471)
        if expire_time is not None and expire_time < MIN_EXPIRE_TIME:
            expire_time = PERMANENT

        dir_name, node_name = posixpath.split(node_path)

        try:
            d = self._walk(dir_name, self._check_dir)
        except EtcdError as err:
            self.stats.inc(SET_FAIL)
            err.index = curr_index
            raise

        e = new_event(action, node_path, next_index, next_index)
        e_node = e.node

        n = d.get_child(node_name)
        if n is not None:
            if replace:
                if n.is_dir():
                    raise EtcdError(ECODE_NOT_FILE, node_path, curr_index)
                e.prev_node = n.repr(False, False)
                n.remove(False, False, None)
            else:
                raise EtcdError(ECODE_NODE_EXIST, node_path, curr_index)

        if not dir:
            e_node.value = value
            n = Node.new_kv(self, node_path, value, next_index, d, "",
                            expire_time)
        else:
            e_node.dir = True
            n = Node.new_dir(self, node_path, next_index, d, "",
                             expire_time)

        d.add(n)

        if not n.is_permanent():
            self.ttl_key_heap.push(n)
            e_node.expiration, e_node.ttl = n.expiration_and_ttl()

        self.current_index = next_index
        return e

    def _internal_get(self, node_path: str) -> Node:
        """Reference store.go:532-556."""
        node_path = clean_path(node_path)

        def walk_func(parent: Node, name: str) -> Node:
            if not parent.is_dir():
                raise EtcdError(ECODE_NOT_DIR, parent.path,
                                self.current_index)
            child = parent.children.get(name)
            if child is not None:
                return child
            raise EtcdError(ECODE_KEY_NOT_FOUND,
                            child_path(parent.path, name),
                            self.current_index)

        return self._walk(node_path, walk_func)

    def _check_dir(self, parent: Node, dir_name: str) -> Node:
        """Get-or-create intermediate directory (store.go:593-609)."""
        node = parent.children.get(dir_name)
        if node is not None:
            if node.is_dir():
                return node
            raise EtcdError(ECODE_NOT_DIR, node.path, self.current_index)
        n = Node.new_dir(self, child_path(parent.path, dir_name),
                         self.current_index + 1, parent, parent.acl,
                         PERMANENT)
        parent.children[dir_name] = n
        return n

    # -- snapshot ----------------------------------------------------------

    def save(self) -> bytes:
        """Clone under the world lock, serialize outside it
        (store.go:615-634).  JSON shape mirrors the reference's
        marshaled store struct so snapshots interoperate."""
        # settle in-flight fanout first so the cloned event history
        # covers every already-applied event (worker mode dispatches
        # asynchronously; bounded wait — a stalled delivery must not
        # block snapshots)
        self.fanout.drain(timeout=1.0)
        with self.world_lock:
            root_clone = self.root.clone()
            hub_clone = self.watcher_hub.clone()
            stats_clone = self.stats.clone()
            index = self.current_index
            version = self.current_version
        doc = {
            "Root": root_clone.to_json_dict(),
            "WatcherHub": {
                "EventHistory": hub_clone.event_history.to_json_dict(),
            },
            "CurrentIndex": index,
            "Stats": stats_clone.to_dict(),
            "CurrentVersion": version,
        }
        return json.dumps(doc).encode()

    def recovery(self, state: bytes) -> None:
        """Rebuild the tree, stats, and event history; re-register
        TTLs (store.go:640-653 does a full json.Unmarshal)."""
        with self.world_lock:
            doc = json.loads(state)
            self.current_index = doc.get("CurrentIndex", 0)
            self.current_version = doc.get("CurrentVersion",
                                           DEFAULT_VERSION)
            if "Stats" in doc:
                self.stats = Stats.from_dict(doc["Stats"])
            hub_doc = doc.get("WatcherHub") or {}
            if hub_doc.get("EventHistory"):
                self.watcher_hub.event_history = \
                    EventHistory.from_json_dict(hub_doc["EventHistory"])
            self.ttl_key_heap = TTLKeyHeap()
            self.root = Node.from_json_dict(self, doc["Root"])
            self.root.recover_and_clean()

    # -- stats -------------------------------------------------------------

    def json_stats(self) -> bytes:
        with self.world_lock:
            self.stats.watchers = self.watcher_hub.count
            return self.stats.to_json()

    def total_transactions(self) -> int:
        return self.stats.total_transactions()


class _FanoutRound:
    """Reentrant deferred-dispatch scope (see Store.fanout_round)."""

    __slots__ = ("store",)

    def __init__(self, store: Store):
        self.store = store

    def __enter__(self):
        with self.store.world_lock:
            self.store._round_depth += 1
        return self

    def __exit__(self, *exc):
        st = self.store
        with st.world_lock:
            st._round_depth -= 1
            if st._round_depth == 0 and st._pending:
                batch, st._pending = st._pending, []
                st.fanout.submit(batch)
        st.fanout.kick()
        return False
