"""Shared jittered-exponential backoff (the port's copy of
``etcd_tpu/utils/backoff.py``).

Three subsystems had grown their own retry pacing: the streamed
snapshot pull re-arm (0.25s -> 30s, x2, +/-50% jitter — the shape
that killed the all-donors-failed wedge), the peerlink
channel reconnect (a flat 50ms wait that turned into a tight
connect/teardown loop under a persistent one-way partition), and the
API client's endpoint failover (no pacing at all).  This module is
the one copy they all ride, with per-site accounting
(``etcd_backoff_retries_total{site}``) so a retry storm is visible
on /metrics instead of only in strace.

Stdlib-only by design (peerlink and the client import it on
connection paths that must not pull torch or numpy).
"""

from __future__ import annotations

import random
import threading

from ..obs import metrics as _obs


class Backoff:
    """Jittered exponential delay sequence.

    ``next()`` returns the wait before the upcoming retry:
    ``base, base*factor, ... , cap``, each multiplied by a uniform
    jitter in ``[1-jitter, 1+jitter]`` (the snap-stream shape:
    0.25 -> 30, x2, +/-50%).  With ``first_zero=True`` the first
    ``next()`` after a reset returns 0.0 — one free immediate retry
    for transient blips (the peerlink reconnect wants this: a parked
    socket going stale is normal, only a PERSISTENT failure should
    pace) — and only non-zero waits are billed to the site counter.

    ``reset()`` re-arms after success.  Thread-safe: ``next()`` and
    ``reset()`` may race (peerlink's writer retries while its reader
    observes a response).
    """

    __slots__ = ("base", "cap", "factor", "jitter", "first_zero",
                 "_cur", "_rng", "_lock", "_ctr")

    def __init__(self, base: float = 0.25, cap: float = 30.0,
                 factor: float = 2.0, jitter: float = 0.5,
                 site: str = "", first_zero: bool = False,
                 rng: random.Random | None = None):
        if base <= 0 or cap < base or factor < 1.0:
            raise ValueError(
                f"bad backoff shape base={base} cap={cap} "
                f"factor={factor}")
        self.base = base
        self.cap = cap
        self.factor = factor
        self.jitter = jitter
        self.first_zero = first_zero
        self._cur = 0.0
        self._rng = rng if rng is not None else random.Random()
        self._lock = threading.Lock()
        self._ctr = (_obs.registry.counter(
            "etcd_backoff_retries_total", site=site) if site
            else None)

    @property
    def pending(self) -> bool:
        """True once ``next()`` has been called since the last
        reset (the sequence is mid-escalation)."""
        return self._cur != 0.0

    def next(self) -> float:
        """Advance the sequence and return the jittered wait."""
        with self._lock:
            if self._cur == 0.0 and self.first_zero:
                # sentinel: armed but the first retry is free
                self._cur = -1.0
                return 0.0
            if self._cur <= 0.0:
                self._cur = self.base
            else:
                self._cur = min(self.cap, self._cur * self.factor)
            delay = self._cur * self._rng.uniform(
                1.0 - self.jitter, 1.0 + self.jitter)
        if self._ctr is not None:
            self._ctr.inc()
        return delay

    def reset(self) -> None:
        with self._lock:
            self._cur = 0.0


__all__ = ["Backoff"]
