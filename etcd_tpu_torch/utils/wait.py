"""Request/response correlation registry (reference wait/wait.go).

The seam where the async consensus pipeline re-synchronizes with
blocked client handlers: a proposal registers its ID, the apply loop
triggers it with the store response.
"""

from __future__ import annotations

import queue
import threading
from typing import Any


class Chan:
    """One-shot result channel with Go closed-channel semantics.

    Trigger both delivers the value and closes the channel
    (reference wait/wait.go:32-41): the first ``get`` returns the
    value, every later ``get`` returns ``None`` immediately — a
    receiver never blocks on an already-triggered ID.  ``get``
    raises ``queue.Empty`` on timeout, mirroring ``queue.Queue``
    for the server call sites.
    """

    def __init__(self) -> None:
        self._ev = threading.Event()
        self._lock = threading.Lock()
        self._val: Any = None

    def close(self, x: Any) -> None:
        with self._lock:
            self._val = x
        self._ev.set()

    def get(self, timeout: float | None = None) -> Any:
        if not self._ev.wait(timeout):
            raise queue.Empty
        with self._lock:
            v, self._val = self._val, None
        return v


class Wait:
    def __init__(self):
        self._lock = threading.Lock()
        self._m: dict[int, Chan] = {}

    def register(self, id: int) -> Chan:
        with self._lock:
            ch = self._m.get(id)
            if ch is None:
                ch = Chan()
                self._m[id] = ch
            return ch

    def trigger(self, id: int, x: Any) -> None:
        with self._lock:
            ch = self._m.pop(id, None)
        if ch is not None:
            ch.close(x)
