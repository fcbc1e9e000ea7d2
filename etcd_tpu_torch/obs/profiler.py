"""Always-on sampling profiler (the port's copy of
``etcd_tpu/obs/profiler.py``).

One daemon thread wakes at ``ETCD_PROFILE_HZ`` (default 5 Hz, 0
disables) and attributes every OTHER thread's current stack:

- **stage**: the innermost active ``tracer.stage()`` on the sampled
  thread, read from the cross-thread mirror ``utils.trace``
  publishes on stage enter/exit ('-' when the thread is outside
  every stage — idle waits, unstaged plumbing);
- **domain**: the thread-ownership domain from the owners table
  (``obs/owners.py`` DOMAINS), resolved by walking the sampled stack
  for a frame whose (file, function) matches a registered owner
  root.  The reference reads the same domains from its static
  ownership checker's registry; the port keeps them as data.

Samples land in ``etcd_profile_samples_total{stage,domain}``; the
sampler meters its own CPU-per-wall cost into
``etcd_profile_overhead_ratio``.  ``dist_bench --profile-overhead``
measures the end-to-end cost against a profiler-off arm; per-role
sample tables merge through the supervisor plane like every other
family.

The sampling core is ``sys._current_frames()`` — one C call under
the GIL, no per-thread locks, no target-thread cooperation — plus a
bounded frame walk per thread.  Stdlib-only.
"""

from __future__ import annotations

import os
import sys
import threading
import time

from . import metrics as _metrics
from .owners import DOMAINS

DEFAULT_HZ = 5.0

#: frames to walk outward per sampled stack when resolving the
#: ownership domain (roots sit near the stack bottom; the walk is
#: from the innermost frame, so allow a realistic call depth)
_MAX_WALK = 64


def _domain_roots() -> dict[tuple[str, str], str]:
    """(file basename, function name) -> domain, from the owners
    table."""
    roots: dict[tuple[str, str], str] = {}
    for name, dom in DOMAINS.items():
        for rel, scope in dom.owners:
            key = (rel.rsplit("/", 1)[-1],
                   scope.rsplit(".", 1)[-1])
            roots.setdefault(key, name)
    return roots


class Profiler:
    """One sampling thread over this process's threads."""

    def __init__(self, registry: _metrics.Registry | None = None,
                 hz: float = DEFAULT_HZ):
        self._reg = (registry if registry is not None
                     else _metrics.registry)
        self.interval = 1.0 / max(hz, 0.1)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._roots = _domain_roots()
        # code object -> domain name or None: code objects are
        # interned per function, so after warmup the frame walk is
        # one dict hit per frame instead of two rsplits + a tuple —
        # the per-sample cost that decides whether "always-on" is
        # honest on a shared core
        self._code_domain: dict[object, str | None] = {}
        self._counters: dict[tuple[str, str], _metrics.Counter] = {}
        self._overhead = self._reg.gauge(
            "etcd_profile_overhead_ratio")
        self.samples = 0

    # -- attribution ------------------------------------------------------

    def _domain_of(self, frame) -> str:
        cache = self._code_domain
        f = frame
        for _ in range(_MAX_WALK):
            if f is None:
                break
            code = f.f_code
            try:
                dom = cache[code]
            except KeyError:
                dom = cache[code] = self._roots.get(
                    (code.co_filename.rsplit("/", 1)[-1],
                     code.co_name))
                if len(cache) > 65536:  # pragma: no cover - bound
                    cache.clear()
            if dom is not None:
                return dom
            f = f.f_back
        return "-"

    def sample_once(self) -> int:
        """Attribute one snapshot of every other thread's stack;
        returns the number of samples recorded."""
        from ..utils import trace as _trace

        stages = _trace.active_stages()
        me = threading.get_ident()
        n = 0
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            stage = stages.get(tid, "-")
            dom = self._domain_of(frame)
            key = (stage, dom)
            c = self._counters.get(key)
            if c is None:
                c = self._counters[key] = self._reg.counter(
                    "etcd_profile_samples_total", stage=stage,
                    domain=dom)
            c.inc()
            n += 1
        self.samples += n
        return n

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "Profiler":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="obs-profiler")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        t0 = time.monotonic()
        cpu = 0.0
        last_pub = t0
        while not self._stop.wait(self.interval):
            c0 = time.thread_time()
            try:
                self.sample_once()
            except Exception:  # pragma: no cover - interpreter edge
                pass
            cpu += time.thread_time() - c0
            now = time.monotonic()
            if now - last_pub >= 1.0:
                self._overhead.set(cpu / max(now - t0, 1e-9))
                last_pub = now


_default: Profiler | None = None
_default_lock = threading.Lock()


def start_default() -> Profiler | None:
    """Arm the process-wide profiler (idempotent); every role main
    and the dist server call this at start.  ``ETCD_PROFILE_HZ=0``
    disables — the profiler-off arm of the overhead figure."""
    global _default
    try:
        hz = float(os.environ.get("ETCD_PROFILE_HZ", DEFAULT_HZ))
    except ValueError:
        hz = DEFAULT_HZ
    if hz <= 0:
        return None
    with _default_lock:
        if _default is None:
            _default = Profiler(hz=hz).start()
        return _default


__all__ = ["DEFAULT_HZ", "Profiler", "start_default"]
