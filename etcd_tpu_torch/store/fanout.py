"""Batched watch/TTL fanout engine.

The reference dispatches watches inside the store's world lock: every
mutation walks the event key's ancestors and pushes into watcher
channels while the whole tree is stalled.  This engine makes delivery
a separately-scaled stage (the compartmentalization shape of
PAPERS.md "Scaling Replicated State Machines with
Compartmentalization"): mutations only APPEND their committed events
to a per-round batch; the engine then

1. **matches** the batch against the hub's hashed tables under the
   hub mutex only — exact-path buckets plus recursive-prefix buckets
   probed at the depths that actually have watchers, so the
   ``[events x registered-prefixes]`` product is resolved by hash
   lookups and never materialized (host-side; the devledger decides
   if a device-batched form is ever warranted), and
2. **delivers** the matches to watcher queues outside every lock,
   under an explicit slow-watcher policy: counted eviction
   (default) or opt-in backpressure
   (``ETCD_WATCH_OVERFLOW=block``).

Two execution modes share that pipeline.  Inline (a bare ``Store``):
the mutating thread drains the submit queue itself right after
releasing the world lock — tests and direct users keep synchronous
semantics.  Worker mode (the server tiers): ``start()`` spawns a
dispatcher thread (plus optional delivery workers) and the apply
loop never touches a watcher queue at all.

Ordering: batches enter the submit deque under the store's world
lock, so the deque order IS the store's index order; the inline
drain lock / single dispatcher keep dispatch serialized, and
per-watcher delivery order is preserved in worker mode by hashing
each watcher to a fixed delivery worker.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

from ..obs import metrics as _obs
from .watcher import (
    NOTIFY_SENT,
    Watcher,
    WatcherHub,
)

_M_DELIVERED = _obs.registry.counter("etcd_watch_delivered_total")
_M_MATCH_S = _obs.registry.histogram("etcd_watch_dispatch_seconds",
                                     stage="match")
_M_DELIVER_S = _obs.registry.histogram("etcd_watch_dispatch_seconds",
                                       stage="deliver")

_EMPTY: tuple = ()


class Emit:
    """One committed mutation's fanout record: the event plus the
    subtree paths a delete/expire removed (each of which notifies its
    own exact/recursive watchers with ``deleted=True``, reference
    store.go:254-306 callback shape)."""

    __slots__ = ("event", "removed")

    def __init__(self, event, removed=None):
        self.event = event
        self.removed = removed


class WatchMux:
    """Shared delivery sink for a batch-registered watch group: one
    bounded channel of ``(member_id, event)`` pairs consumed by a
    single stream (the POST /v2/watch serving shape).  ``None``
    events signal member closure (eviction or removal).  Overflow
    follows the engine policy via ``block_s``: non-blocking offers
    fail (the member is evicted, counted), blocking offers ride the
    stall deadline."""

    __slots__ = ("_cv", "_items", "capacity", "closed")

    def __init__(self, capacity: int = 4096):
        self._cv = threading.Condition(threading.Lock())
        self._items: deque = deque()
        self.capacity = capacity
        self.closed = False

    def offer(self, mid: int, e, block_s: float | None = None) -> bool:
        with self._cv:
            if self.closed:
                return False
            if len(self._items) >= self.capacity:
                if not block_s:
                    return False
                if not self._cv.wait_for(
                        lambda: self.closed
                        or len(self._items) < self.capacity, block_s) \
                        or self.closed:
                    return False
            self._items.append((mid, e))
            self._cv.notify_all()
            return True

    def offer_closed(self, mid: int) -> None:
        """Member-closure marker; bypasses capacity like the watcher
        queue's sacrificed-slot sentinel — closure must always land."""
        with self._cv:
            if not self.closed:
                self._items.append((mid, None))
                self._cv.notify_all()

    def pop(self, timeout: float | None = None):
        """Next ``(member_id, event)``; None on timeout or mux close."""
        with self._cv:
            if not self._cv.wait_for(
                    lambda: self._items or self.closed, timeout):
                return None
            if not self._items:
                return None
            item = self._items.popleft()
            self._cv.notify_all()
            return item

    def close(self) -> None:
        with self._cv:
            self.closed = True
            self._items.clear()
            self._cv.notify_all()


class FanoutEngine:
    """Per-apply-round batched dispatch over a :class:`WatcherHub`."""

    def __init__(self, hub: WatcherHub, *,
                 overflow: str | None = None,
                 block_s: float | None = None):
        self.hub = hub
        overflow = overflow or os.environ.get("ETCD_WATCH_OVERFLOW",
                                              "evict")
        if overflow not in ("evict", "block"):
            raise ValueError(
                f"watch overflow policy must be 'evict' or 'block', "
                f"got {overflow!r}")
        self.overflow = overflow
        if block_s is None:
            block_s = float(os.environ.get("ETCD_WATCH_BLOCK_S",
                                           "1.0"))
        #: per-put stall budget handed to Watcher._enqueue; None in
        #: evict mode (non-blocking puts)
        self.block_s = block_s if overflow == "block" else None
        self._cv = threading.Condition(threading.Lock())
        self._q: deque = deque()       # FIFO of emit batches
        self._busy = 0                 # batches being dispatched
        self._stop = False
        self._dispatcher: threading.Thread | None = None
        self._workers: list = []       # (thread, cv, deque) triples
        self._inline_lock = threading.Lock()
        self.rounds = 0                # dispatch rounds completed

    # -- producer side (store) -----------------------------------------

    def submit(self, emits: list) -> None:
        """Append one round's batch.  Called with the store's world
        lock held — a deque append only, so submit order is index
        order and the lock never waits on watcher queues."""
        with self._cv:
            self._q.append(emits)
            self._busy += 1
            if self._dispatcher is not None:
                self._cv.notify()

    def kick(self) -> None:
        """Inline mode: drain the submit queue on the calling thread
        (AFTER it released the world lock).  Worker mode: no-op — the
        dispatcher owns the queue."""
        if self._dispatcher is not None:
            return
        while True:
            with self._cv:
                if not self._q:
                    return
            # serialize dispatch across mutating threads; each holder
            # drains everything queued, so a batch submitted while
            # another thread dispatches is picked up by that thread
            # or by this one after it — never stranded
            with self._inline_lock:
                while True:
                    with self._cv:
                        if not self._q:
                            break
                        batch = self._q.popleft()
                    try:
                        self._dispatch(batch)
                    finally:
                        with self._cv:
                            self._busy -= 1
                            self._cv.notify_all()
            return

    # -- worker mode ---------------------------------------------------

    def start(self, workers: int | None = None) -> None:
        """Spawn the dispatcher (and ``workers-1`` extra delivery
        threads) — the server tiers call this so apply loops never
        deliver.  Idempotent."""
        if self._dispatcher is not None:
            return
        if workers is None:
            workers = int(os.environ.get("ETCD_WATCH_WORKERS", "1"))
        workers = max(1, workers)
        for i in range(workers - 1):
            cv = threading.Condition(threading.Lock())
            dq: deque = deque()
            t = threading.Thread(target=self._worker_loop,
                                 args=(cv, dq),
                                 name=f"watch-fanout-w{i}",
                                 daemon=True)
            self._workers.append((t, cv, dq))
            t.start()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="watch-fanout",
            daemon=True)
        self._dispatcher.start()

    def close(self) -> None:
        """Stop the engine AFTER draining: the dispatcher finishes
        every submitted batch (its loop exits only on empty queue),
        and the worker sentinels are appended only once it has — a
        sentinel racing ahead of the final partitions would strand
        them behind it in the worker FIFOs."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        d = self._dispatcher
        if d is not None and d is not threading.current_thread():
            d.join(timeout=5)
        for _t, cv, dq in self._workers:
            with cv:
                dq.append(None)
                cv.notify_all()
        for t, _cv, _dq in self._workers:
            if t is not threading.current_thread():
                t.join(timeout=5)

    def drain(self, timeout: float | None = 1.0) -> bool:
        """Wait until every submitted batch has fully dispatched
        (store.save() calls this so a snapshot's event history
        includes events already applied)."""
        with self._cv:
            return self._cv.wait_for(
                lambda: self._busy == 0 or self._stop, timeout)

    def _dispatch_loop(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._stop:
                    self._cv.wait()
                if self._stop and not self._q:
                    return
                batch = self._q.popleft()
            try:
                self._dispatch(batch)
            finally:
                with self._cv:
                    self._busy -= 1
                    self._cv.notify_all()

    def _worker_loop(self, cv, dq) -> None:
        while True:
            with cv:
                while not dq:
                    cv.wait()
                items = dq.popleft()
            if items is None:
                return
            self._deliver(items)

    # -- the dispatch pipeline -----------------------------------------

    def _dispatch(self, emits: list) -> None:
        t0 = time.perf_counter()
        with self.hub.mutex:
            matches = self._match(emits)
        _M_MATCH_S.observe(time.perf_counter() - t0)
        self.rounds += 1
        if not matches:
            return
        if not self._workers:
            self._deliver(matches)
            return
        # partition by watcher so each watcher's events always ride
        # the same worker's FIFO — per-watcher order is preserved
        # without any cross-worker barrier.  The shard is the hub's
        # registration serial: id()/hash() are address-derived and
        # allocator alignment parks them all in one partition for
        # even worker counts
        n = len(self._workers) + 1
        parts: list[list] = [[] for _ in range(n)]
        for m in matches:
            parts[m[0]._shard % n].append(m)
        for (_t, cv, dq), part in zip(self._workers, parts[1:]):
            if part:
                with cv:
                    dq.append(part)
                    cv.notify()
        if parts[0]:
            self._deliver(parts[0])

    def _match(self, emits: list) -> list:
        """Resolve the batch against the hashed tables (called with
        the hub mutex held): history insertion and the match snapshot
        are atomic w.r.t. registration, so a concurrent ``watch()``
        either scans the event from history or is in the tables
        before this snapshot."""
        hub = self.hub
        exact = hub.exact
        recursive = hub.recursive
        rec_depths = hub.rec_depths
        add_event = hub.event_history.add_event
        out: list = []
        for em in emits:
            e = em.event
            add_event(e)
            idx = e.index()
            key = e.node.key
            if em.removed:
                # subtree removal: every removed path notifies its
                # own watchers with deleted=True (always fires:
                # removed paths are at/below the event key, so the
                # hidden filter never applies — reference
                # watcher_hub.go:120-131 via the delete callback)
                for p in em.removed:
                    for w in exact.get(p, _EMPTY):
                        if not w.removed and idx >= w.since_index:
                            out.append((w, e))
                    for w in recursive.get(p, _EMPTY):
                        if not w.removed and idx >= w.since_index:
                            out.append((w, e))
            # exact watchers fire only AT the key
            for w in exact.get(key, _EMPTY):
                if not w.removed and idx >= w.since_index:
                    out.append((w, e))
            if rec_depths:
                segs = key.split("/")
                n = len(segs) - 1
                # deepest hidden segment: a recursive watcher ABOVE
                # it must not hear the event (is_hidden semantics,
                # watcher_hub.go:147-157); the watch at the key
                # itself always fires
                h = 0
                for i in range(1, n + 1):
                    if segs[i].startswith("_"):
                        h = i
                for d in rec_depths:
                    if d > n or (d < h and d != n):
                        continue
                    p = "/" if d == 0 else "/".join(segs[:d + 1])
                    for w in recursive.get(p, _EMPTY):
                        if not w.removed and idx >= w.since_index:
                            out.append((w, e))
        return out

    def _deliver(self, matches: list) -> None:
        """Queue matched events — outside the hub mutex and the
        store's world lock (the subsystem's core invariant: slow
        watchers can stall only this stage, never the apply path)."""
        t0 = time.perf_counter()
        sent = 0
        fired: set[int] = set()        # one-shots fired this round
        removals: list[Watcher] = []
        block_s = self.block_s
        for w, e in matches:
            if w.removed:
                continue
            if not w.stream and id(w) in fired:
                continue
            if w._enqueue(e, block_s) == NOTIFY_SENT:
                sent += 1
                if not w.stream:
                    fired.add(id(w))
                    removals.append(w)
        if removals:
            with self.hub.mutex:
                for w in removals:
                    if not w.removed and w._remove_cb is not None:
                        w._remove_cb()
            for w in removals:
                w._close()
        if sent:
            _M_DELIVERED.inc(sent)
        _M_DELIVER_S.observe(time.perf_counter() - t0)
