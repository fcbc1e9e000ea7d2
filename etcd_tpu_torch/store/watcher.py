"""Watchers and the watcher hub (reference store/watcher.go,
store/watcher_hub.go), restructured for the fanout subsystem.

The reference keeps ONE per-path list and fans every event out with a
per-ancestor walk inside the store's world lock.  Here registration is
split into hashed tables the batched dispatch engine
(store/fanout.py) resolves per apply round:

- ``exact``: non-recursive watchers, keyed by their watched path —
  they fire only for events AT that path (or its deletion as part of
  a subtree removal).
- ``recursive``: recursive watchers, keyed by their watched prefix,
  with a per-depth occupancy index so matching an event touches only
  the prefix depths that actually have watchers (hash lookups, never
  a full ancestor walk).

The reference's buffered channel becomes a bounded queue: delivery is
non-blocking by default, and a watcher whose queue overflows is
EVICTED (slow watcher eviction, watcher.go:61-72) — counted in
``etcd_watch_evictions_total{reason}`` and routed through the hub's
removal callback so the accounting can never run twice.  Backpressure
(block-until-space with a stall deadline) is the engine's opt-in
alternative policy.
"""

from __future__ import annotations

import os
import posixpath
import queue
import threading
from collections import deque

from ..obs import metrics as _obs
from ..utils.errors import EtcdError
from .event import Event
from .event_history import EventHistory
from .node_internal import child_path

_CLOSED = object()  # sentinel marking a closed event channel

#: Watcher.notify / Watcher._enqueue outcomes.  SENT stays truthy and
#: SKIPPED falsy so legacy boolean callers keep working; EVICTED is the
#: distinct third outcome the old bool API conflated with SENT (the
#: double-close bug this split fixes).
NOTIFY_SKIPPED = 0
NOTIFY_SENT = 1
NOTIFY_EVICTED = 2

#: per-watcher queue bound (the reference's 100-slot channel)
WATCH_QUEUE_SIZE = int(os.environ.get("ETCD_WATCH_QUEUE", "100"))

_M_ACTIVE = _obs.registry.gauge("etcd_watchers_active")


def _evict_counter(reason: str):
    return _obs.registry.counter("etcd_watch_evictions_total",
                                 reason=reason)


_M_EVICT_OVERFLOW = _evict_counter("overflow")
_M_EVICT_STALL = _evict_counter("stall")


class BoundedEventQueue:
    """Slim bounded MPSC queue (deque + one condition).

    ``queue.Queue`` carries three conditions and ~1 KiB of state per
    instance; at the 100k-watcher scale the fanout subsystem targets
    that overhead dominates the watcher itself.  API is the
    ``queue.Queue`` subset the watcher paths use (``put_nowait`` /
    ``get`` raise the stdlib ``queue.Full`` / ``queue.Empty`` so
    callers need no new vocabulary)."""

    __slots__ = ("_cv", "_items", "maxsize")

    def __init__(self, maxsize: int):
        self._cv = threading.Condition(threading.Lock())
        self._items: deque = deque()
        self.maxsize = maxsize

    def put_nowait(self, item) -> None:
        with self._cv:
            if len(self._items) >= self.maxsize:
                raise queue.Full
            self._items.append(item)
            self._cv.notify_all()

    def put(self, item, timeout: float | None = None) -> bool:
        """Blocking put; False when ``timeout`` expired with the queue
        still full (the backpressure policy's stall signal)."""
        with self._cv:
            if self._cv.wait_for(
                    lambda: len(self._items) < self.maxsize, timeout):
                self._items.append(item)
                self._cv.notify_all()
                return True
            return False

    def get(self, timeout: float | None = None):
        with self._cv:
            if not self._cv.wait_for(lambda: bool(self._items),
                                     timeout):
                raise queue.Empty
            item = self._items.popleft()
            self._cv.notify_all()
            return item

    def get_nowait(self):
        with self._cv:
            if not self._items:
                raise queue.Empty
            item = self._items.popleft()
            self._cv.notify_all()
            return item

    def qsize(self) -> int:
        with self._cv:
            return len(self._items)


class Watcher:
    """One registered watch (reference store/watcher.go:26-90)."""

    __slots__ = ("event_queue", "recursive", "stream", "since_index",
                 "start_index", "hub", "removed", "_remove_cb",
                 "_shard", "_closed")

    def __init__(self, hub: "WatcherHub", recursive: bool, stream: bool,
                 since_index: int, start_index: int,
                 queue_size: int | None = None):
        self.event_queue = BoundedEventQueue(
            queue_size or WATCH_QUEUE_SIZE)
        self.recursive = recursive
        self.stream = stream
        self.since_index = since_index
        self.start_index = start_index
        self.hub = hub
        self.removed = False
        self._remove_cb = None
        # delivery-worker affinity: a hub-assigned serial, NOT id()
        # or hash() — CPython object addresses are allocator-aligned,
        # so address-derived modulos degenerate to one partition
        self._shard = 0
        self._closed = False

    def start_index_(self) -> int:
        return self.start_index

    def next_event(self, timeout: float | None = None) -> Event | None:
        """Block for the next event; None when the watcher was removed
        (channel closed) or the timeout expired."""
        try:
            item = self.event_queue.get(timeout=timeout)
        except queue.Empty:
            return None
        if item is _CLOSED:
            return None
        return item

    def notify(self, e: Event, original_path: bool,
               deleted: bool) -> int:
        """Non-blocking send.  Returns NOTIFY_SENT (delivered),
        NOTIFY_SKIPPED (condition not met), or NOTIFY_EVICTED — the
        watcher overflowed and was removed (reference
        watcher.go:46-79).  Callers must treat EVICTED as NOT fired:
        the eviction already closed the channel and ran the removal
        callback, so the one-shot close path may not run again."""
        if (self.recursive or original_path or deleted) \
                and e.index() >= self.since_index:
            return self._enqueue(e)
        return NOTIFY_SKIPPED

    def _enqueue(self, e: Event, block_s: float | None = None) -> int:
        """Queue the event under the engine's overflow policy:
        non-blocking eviction by default, block-until-space with a
        stall deadline when ``block_s`` is set (opt-in
        backpressure)."""
        try:
            self.event_queue.put_nowait(e)
            return NOTIFY_SENT
        except queue.Full:
            if block_s:
                if self.event_queue.put(e, timeout=block_s):
                    return NOTIFY_SENT
                return self._evict(_M_EVICT_STALL)
            return self._evict(_M_EVICT_OVERFLOW)

    def _evict(self, ctr) -> int:
        """Missed a notification: remove, close, count — removal goes
        through the hub's ``_remove_cb`` (idempotent, owns the count
        and table bookkeeping) so eviction can never double-account."""
        with self.hub.mutex:
            if self._remove_cb is not None:
                self._remove_cb()
            else:
                self.removed = True
        self._close()
        ctr.inc()
        return NOTIFY_EVICTED

    def remove(self) -> None:
        """Public removal; idempotent (watcher.go:84-90)."""
        with self.hub.mutex:
            self._close()
            if self._remove_cb:
                self._remove_cb()

    def _close(self) -> None:
        """Signal closure exactly ONCE: evict-then-remove (or racing
        removers) must not emit a second closure — a duplicate mux
        closed marker would double-decrement the serving side's
        open-member count.  Subclasses override ``_deliver_close``,
        not this guard."""
        with self.hub.mutex:
            if self._closed:
                return
            self._closed = True
        self._deliver_close()

    def _deliver_close(self) -> None:
        """The sentinel must always land so a draining consumer
        observes closure (a closed Go channel stays readable); on a
        full queue we sacrifice one buffered event for it."""
        try:
            self.event_queue.put_nowait(_CLOSED)
        except queue.Full:
            try:
                self.event_queue.get_nowait()
            except queue.Empty:
                pass
            try:
                self.event_queue.put_nowait(_CLOSED)
            except queue.Full:  # pragma: no cover
                pass


class MuxWatcher(Watcher):
    """A watcher delivering into a shared :class:`~.fanout.WatchMux`
    sink instead of a private queue — the batched-registration serving
    shape: one bounded channel carries a whole watch group's events,
    tagged with the member id, so 100k watches cost one consumer
    stream instead of 100k queues."""

    __slots__ = ("mux", "mid", "replay")

    def __init__(self, hub, recursive, stream, since_index,
                 start_index, mux, mid: int):
        super().__init__(hub, recursive, stream, since_index,
                         start_index, queue_size=1)
        self.mux = mux
        self.mid = mid
        #: history catch-up start index, set at registration when the
        #: requested since-index hit the in-window history: the
        #: CONSUMER streams [replay, since_index) out of the history
        #: ring outside every lock (a mux member can lag a whole
        #: window; buffering that replay in the mux evicted it)
        self.replay: int | None = None

    def _enqueue(self, e: Event, block_s: float | None = None) -> int:
        if self.mux.offer(self.mid, e, None):
            return NOTIFY_SENT
        if block_s:
            # backpressure arm: block up to the stall deadline, then
            # evict with the stall reason (mirrors the base class so
            # the {reason} split stays honest for mux members)
            if self.mux.offer(self.mid, e, block_s):
                return NOTIFY_SENT
            return self._evict(_M_EVICT_STALL)
        return self._evict(_M_EVICT_OVERFLOW)

    def _deliver_close(self) -> None:
        self.mux.offer_closed(self.mid)

    def next_event(self, timeout: float | None = None):
        raise TypeError("mux watcher events arrive via WatchMux.pop")


def key_depth(path: str) -> int:
    """Segment depth of a clean absolute path ('/' -> 0, '/a/b' -> 2)."""
    return 0 if path == "/" else path.count("/")


class WatcherHub:
    """Hashed watcher tables + the event-history ring
    (reference store/watcher_hub.go:19-160).

    ``mutex`` guards the tables AND brackets history scans with
    registration: the dispatch engine adds a round's events to history
    and snapshots its matches under this lock, so a concurrently
    registering watcher either sees the event in history or is in the
    tables before the match — an event can be delivered twice across
    the seam but never lost."""

    def __init__(self, capacity: int):
        self.mutex = threading.RLock()
        self.exact: dict[str, list[Watcher]] = {}
        self.recursive: dict[str, list[Watcher]] = {}
        #: prefix depth -> live recursive-watcher count; the dispatch
        #: engine probes only these depths per event key
        self.rec_depths: dict[int, int] = {}
        self.count = 0
        self._serial = 0  # round-robin shard source for delivery
        self.event_history = EventHistory(capacity)

    def watch(self, key: str, recursive: bool, stream: bool, index: int,
              store_index: int, mux=None, mid: int = 0) -> Watcher:
        """Register a watch, serving from history if possible
        (watcher_hub.go:41-97)."""
        with self.mutex:
            return self._watch_locked(key, recursive, stream, index,
                                      store_index, mux, mid)

    def watch_many(self, specs, store_index: int, mux=None,
                   mid_base: int = 0) -> list:
        """Batched registration: ONE mutex take for the whole batch
        (a hub-lock round trip per watcher is pure overhead at the
        100k-registration scale).  ``specs`` is an iterable of
        ``(key, recursive, stream, since_index)``; returns a list
        aligned with it — a Watcher, or the EtcdError a compacted
        history raised for that spec."""
        out = []
        with self.mutex:
            for i, (key, recursive, stream, index) in enumerate(specs):
                try:
                    out.append(self._watch_locked(
                        key, recursive, stream, index, store_index,
                        mux, mid_base + i))
                except EtcdError as e:  # history cleared past since
                    out.append(e)
        return out

    def _watch_locked(self, key, recursive, stream, index, store_index,
                      mux, mid) -> Watcher:
        event = self.event_history.scan(key, recursive, index)

        if mux is not None:
            w: Watcher = MuxWatcher(self, recursive, stream, index,
                                    store_index, mux, mid)
            if event is not None:
                event.etcd_index = store_index
                if not stream:
                    # one-shot served from history, then a completion
                    # marker (a long-poll client re-issues; a mux
                    # member has no other way to learn it is done)
                    if w._enqueue(event) == NOTIFY_SENT:
                        w._close()
                    return w
                # stream member: a history hit must not orphan the
                # stream (the legacy single-watch path long-polls and
                # re-issues, a mux stream cannot).  The replay itself
                # is DEFERRED to the consumer — a member can lag a
                # whole history window and pushing that through the
                # bounded mux during registration evicted it.  Live
                # delivery starts after the current window
                # (since_index = last_index + 1; dispatch appends
                # under this same mutex, so there is no gap) and the
                # consumer streams [replay, since_index) from the
                # history ring at its own pace.
                w.replay = event.index()
                w.since_index = self.event_history.last_index + 1
        else:
            w = Watcher(self, recursive, stream, index, store_index)
            if event is not None:
                event.etcd_index = store_index
                w._enqueue(event)
                return w

        table = self.recursive if recursive else self.exact
        lst = table.setdefault(key, [])
        lst.append(w)
        self._serial += 1
        w._shard = self._serial
        depth = key_depth(key)
        if recursive:
            self.rec_depths[depth] = self.rec_depths.get(depth, 0) + 1

        def remove():
            if w.removed:
                return
            w.removed = True
            try:
                lst.remove(w)
            except ValueError:
                pass
            self.count -= 1
            _M_ACTIVE.inc(-1)
            if recursive:
                left = self.rec_depths.get(depth, 0) - 1
                if left <= 0:
                    self.rec_depths.pop(depth, None)
                else:
                    self.rec_depths[depth] = left
            if not lst and table.get(key) is lst:
                del table[key]

        w._remove_cb = remove
        self.count += 1
        _M_ACTIVE.inc()
        return w

    def remove_many(self, watchers) -> None:
        """Batched removal: one mutex take, then the closes (which may
        block on a mux sink) outside it."""
        with self.mutex:
            for w in watchers:
                if isinstance(w, Watcher) and not w.removed \
                        and w._remove_cb is not None:
                    w._remove_cb()
        for w in watchers:
            if isinstance(w, Watcher):
                w._close()

    # -- legacy synchronous fan-out ------------------------------------

    def notify(self, e: Event) -> None:
        """Synchronous ancestor-path fan-out: an event at /foo/bar
        notifies watchers at /, /foo, and /foo/bar
        (watcher_hub.go:99-115).  The store's batched path goes
        through the fanout engine instead; this single-event form is
        kept for direct hub users and shares the same delivery
        primitives."""
        e = self.event_history.add_event(e)
        segments = e.node.key.split("/")
        curr_path = "/"
        for segment in segments:
            # keys are clean absolute paths, so the only empty
            # segment is the leading one (posixpath.join semantics
            # for these shapes, without its per-call overhead)
            if segment:
                curr_path = child_path(curr_path, segment)
            self.notify_watchers(e, curr_path, False)

    def notify_watchers(self, e: Event, node_path: str,
                        deleted: bool) -> None:
        with self.mutex:
            for table in (self.exact, self.recursive):
                lst = table.get(node_path)
                if not lst:
                    continue
                for w in list(lst):
                    original_path = e.node.key == node_path
                    if not (original_path
                            or not is_hidden(node_path, e.node.key)):
                        continue
                    res = w.notify(e, original_path, deleted)
                    if res == NOTIFY_SENT and not w.stream:
                        # one-shot watcher fired: removal rides the
                        # hub callback (the single owner of count and
                        # table state), close lands the sentinel.
                        # An EVICTED outcome already did both —
                        # running them again was the double-close bug.
                        if w._remove_cb is not None:
                            w._remove_cb()
                        w._close()

    def clone(self) -> "WatcherHub":
        c = WatcherHub(self.event_history.queue.capacity)
        c.event_history = self.event_history.clone()
        return c


def is_hidden(watch_path: str, key_path: str) -> bool:
    """Whether key_path is hidden relative to watch_path
    (reference watcher_hub.go:147-157)."""
    if len(watch_path) > len(key_path):
        return False
    after_path = posixpath.normpath("/" + key_path[len(watch_path):])
    return "/_" in after_path
