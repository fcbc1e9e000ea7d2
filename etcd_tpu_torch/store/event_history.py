"""Ring-buffer event history for watcher catch-up
(reference store/event_history.go, store/event_queue.go).

Sized from the reference's envelope: 20K/s max throughput x 2 x 50ms
RTT => 1000-2000 events (watcher_hub.go:28-29).
"""

from __future__ import annotations

import threading

from ..utils.errors import ECODE_EVENT_INDEX_CLEARED, EtcdError
from .event import Event


class EventQueue:
    """Fixed-capacity circular queue (reference store/event_queue.go)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.events: list[Event | None] = [None] * capacity
        self.size = 0
        self.front = 0
        self.back = 0

    def insert(self, e: Event) -> None:
        self.events[self.back] = e
        self.back = (self.back + 1) % self.capacity
        if self.size == self.capacity:  # dequeue oldest
            self.front = (self.front + 1) % self.capacity
        else:
            self.size += 1


class EventHistory:
    def __init__(self, capacity: int):
        self.queue = EventQueue(capacity)
        self.start_index = 0
        self.last_index = 0
        self._lock = threading.Lock()

    def add_event(self, e: Event) -> Event:
        with self._lock:
            self.queue.insert(e)
            self.last_index = e.index()
            self.start_index = self.queue.events[self.queue.front].index()
        return e

    def scan(self, key: str, recursive: bool, index: int) -> Event | None:
        """First event at/after ``index`` matching key; None on a future
        index; error when the history was compacted past ``index``
        (reference event_history.go:44-90)."""
        with self._lock:
            if index < self.start_index:
                raise EtcdError(
                    ECODE_EVENT_INDEX_CLEARED,
                    f"the requested history has been cleared "
                    f"[{self.start_index}/{index}]")
            if index > self.last_index:  # future index
                return None
            offset = index - self.start_index
            i = (self.queue.front + offset) % self.queue.capacity
            while True:
                e = self.queue.events[i]
                ok = e.node.key == key
                if recursive:
                    k = key if key.endswith("/") else key + "/"
                    ok = ok or e.node.key.startswith(k)
                if ok:
                    return e
                i = (i + 1) % self.queue.capacity
                if i == self.queue.back:
                    return None

    def clone(self) -> "EventHistory":
        # under _lock: the fanout engine appends history on
        # its own thread (hub mutex + this lock, not the store world
        # lock), so a snapshot clone racing a dispatch could tear
        # front/back against the events array without it
        with self._lock:
            c = EventHistory(self.queue.capacity)
            c.queue.events = list(self.queue.events)
            c.queue.size = self.queue.size
            c.queue.front = self.queue.front
            c.queue.back = self.queue.back
            c.start_index = self.start_index
            c.last_index = self.last_index
            return c

    def to_json_dict(self) -> dict:
        return {
            "Queue": {
                "Events": [e.to_dict() if e else None
                           for e in self.queue.events],
                "Size": self.queue.size,
                "Front": self.queue.front,
                "Back": self.queue.back,
                "Capacity": self.queue.capacity,
            },
            "StartIndex": self.start_index,
            "LastIndex": self.last_index,
        }

    @classmethod
    def from_json_dict(cls, d: dict) -> "EventHistory":
        q = d.get("Queue") or {}
        eh = cls(q.get("Capacity") or 1000)
        events = [Event.from_dict(x) if x else None
                  for x in q.get("Events", [])]
        size = q.get("Size", 0)
        front = q.get("Front", 0)
        if len(events) == eh.queue.capacity:
            # consistent snapshot: adopt the ring as stored
            eh.queue.events = events
            eh.queue.size = size
            eh.queue.front = front
            eh.queue.back = q.get("Back", 0)
            eh.start_index = d.get("StartIndex", 0)
            eh.last_index = d.get("LastIndex", 0)
            return eh
        # Events/Capacity mismatch (capacity drift across versions or
        # a hand-carried snapshot): the stored front/back arithmetic
        # is meaningless against a differently-sized array — an
        # oversized Events list would otherwise corrupt every wrap.
        # Linearize the stored ring oldest-first, keep the NEWEST
        # ``capacity`` events, and rebuild a dense ring.
        ordered = []
        if events:
            n = len(events)
            for i in range(min(size, n)):
                e = events[(front + i) % n]
                if e is not None:
                    ordered.append(e)
        ordered = ordered[-eh.queue.capacity:]
        eh.queue.events = (ordered
                           + [None] * (eh.queue.capacity
                                       - len(ordered)))
        eh.queue.size = len(ordered)
        eh.queue.front = 0
        eh.queue.back = len(ordered) % eh.queue.capacity
        eh.start_index = (ordered[0].index() if ordered
                          else d.get("StartIndex", 0))
        eh.last_index = (ordered[-1].index() if ordered
                         else d.get("LastIndex", 0))
        return eh
