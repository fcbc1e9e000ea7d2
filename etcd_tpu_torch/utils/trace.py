"""Host tracing and an optional device-profile capture (the port's copy
of ``etcd_tpu/utils/trace.py``).

Every hot seam of the co-hosted server (WAL persist, replay, consensus
round, apply, snapshot) runs under a named span; aggregated latency
stats (count/mean/p50/p99/max over a sliding window) are served at
``/v2/stats/spans``.  The Tracer is a facade over the metrics registry:
``record`` lands in the ``etcd_span_seconds`` histogram family (a ring
of 256 samples per span), and ``stage`` adds per-stage wall, thread-CPU
and device seconds to ``etcd_stage_seconds``.

``ETCD_TRACE_DIR=/path`` arms a ``torch.profiler`` capture of the CPU
and CUDA activity at server start (:func:`maybe_start_profile`); the
Chrome-trace JSON lands in that directory at :func:`stop_profile`.  The
reference arms ``jax.profiler`` the same way.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time

from ..obs import metrics as _metrics

log = logging.getLogger(__name__)

_SPAN_FAMILY = "etcd_span_seconds"  # catalog family backing spans

#: thread-local stack of active _StageCtx instances: the device ledger
#: charges device block/dispatch seconds to the INNERMOST stage so the
#: wall/cpu/device columns of etcd_stage_seconds sum honestly
_stage_tls = threading.local()

#: thread ident -> innermost active stage name, published by
#: _StageCtx enter/exit for the sampling profiler (obs/profiler.py)
#: — a cross-thread-readable mirror of the thread-local stack (one
#: GIL-atomic dict store per stage pass; the profiler must never
#: touch another thread's TLS)
_active_stages: dict[int, str] = {}


def active_stages() -> dict[int, str]:
    """Snapshot of {thread ident: innermost active stage name}."""
    return dict(_active_stages)


def note_device_seconds(dt: float) -> None:
    """Charge ``dt`` seconds of device dispatch/block time to the
    innermost active stage() on this thread (no-op outside one)."""
    stack = getattr(_stage_tls, "stack", None)
    if stack:
        stack[-1].device_s += dt


class _Span:
    __slots__ = ("tracer", "name", "t0")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer = tracer
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.tracer.record(self.name, time.perf_counter() - self.t0)
        return False


class _StageCtx:
    """One pass through a labeled stage: wall + thread-CPU + device
    attribution.  Also records the plain span."""

    __slots__ = ("tracer", "name", "t0", "c0", "device_s")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer = tracer
        self.name = name

    def __enter__(self):
        self.device_s = 0.0
        stack = getattr(_stage_tls, "stack", None)
        if stack is None:
            stack = _stage_tls.stack = []
        stack.append(self)
        _active_stages[threading.get_ident()] = self.name
        self.t0 = time.perf_counter()
        self.c0 = time.thread_time()
        return self

    def __exit__(self, *exc):
        cpu = time.thread_time() - self.c0
        wall = time.perf_counter() - self.t0
        stack = _stage_tls.stack
        stack.pop()
        tid = threading.get_ident()
        if stack:
            _active_stages[tid] = stack[-1].name
        else:
            _active_stages.pop(tid, None)
        self.tracer.record(self.name, wall)
        self.tracer.record_stage(self.name, wall, cpu, self.device_s)
        return False


class Tracer:
    """Span recorder over a metrics registry's span family.

    A bare ``Tracer()`` owns a private registry (test isolation); the
    module-level :data:`tracer` records into the process-wide default
    registry.
    """

    def __init__(self, registry: _metrics.Registry | None = None):
        self._reg = (registry if registry is not None
                     else _metrics.Registry())
        # per-name child cache: the record path is one dict get plus
        # the histogram lock
        self._hists: dict[str, _metrics.Histogram] = {}
        # per-stage handles: (wall, cpu, device histograms, counter)
        self._stages: dict[str, tuple] = {}

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def stage(self, name: str) -> _StageCtx:
        """Like :meth:`span`, plus per-stage CPU/device attribution in
        ``etcd_stage_seconds{stage,kind}`` and a pass count in
        ``etcd_trace_spans_total{stage}``."""
        return _StageCtx(self, name)

    def record(self, name: str, dt: float) -> None:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = self._reg.histogram(
                _SPAN_FAMILY, span=name)
        h.observe(dt)

    def record_stage(self, name: str, wall: float, cpu: float,
                     device: float = 0.0) -> None:
        handles = self._stages.get(name)
        if handles is None:
            handles = self._stages[name] = (
                self._reg.histogram("etcd_stage_seconds",
                                    stage=name, kind="wall"),
                self._reg.histogram("etcd_stage_seconds",
                                    stage=name, kind="cpu"),
                self._reg.histogram("etcd_stage_seconds",
                                    stage=name, kind="device"),
                self._reg.counter("etcd_trace_spans_total",
                                  stage=name))
        handles[0].observe(wall)
        handles[1].observe(cpu)
        if device > 0.0:
            # device samples only when the stage crossed a ledger seam
            handles[2].observe(device)
        handles[3].inc()

    def snapshot(self) -> dict:
        out = {}
        for (name,), hist in self._reg.family(
                _SPAN_FAMILY).children():
            count, total, mx, ring = hist.ring_stats()
            if not ring:
                continue
            p50 = ring[len(ring) // 2]
            p99 = ring[min(len(ring) - 1, int(len(ring) * 0.99))]
            out[name] = {
                "count": count,
                "total_ms": round(total * 1e3, 3),
                "mean_ms": round(total / count * 1e3, 3),
                "p50_ms": round(p50 * 1e3, 3),
                "p99_ms": round(p99 * 1e3, 3),
                "max_ms": round(mx * 1e3, 3),
            }
        return out

    def snapshot_json(self) -> bytes:
        return (json.dumps(self.snapshot(), sort_keys=True) +
                "\n").encode()

    def reset(self) -> None:
        self._hists = {}
        self._stages = {}
        for fam in (_SPAN_FAMILY, "etcd_stage_seconds",
                    "etcd_trace_spans_total"):
            self._reg.family(fam).clear()


#: process-wide default tracer: servers and replay paths record here
tracer = Tracer(_metrics.registry)

_profile = None
_profile_dir: str | None = None
_profile_lock = threading.Lock()


def maybe_start_profile() -> bool:
    """Start a ``torch.profiler`` capture (CPU, and CUDA where the card
    is present) when ``ETCD_TRACE_DIR`` is set.  Idempotent; returns
    whether a capture is running.  A profiler that cannot start raises:
    the operator asked for the trace."""
    global _profile, _profile_dir
    d = os.environ.get("ETCD_TRACE_DIR")
    with _profile_lock:
        if not d or _profile is not None:
            return _profile is not None
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(d, exist_ok=True)
        prof = profile(activities=acts)
        prof.__enter__()
        _profile, _profile_dir = prof, d
        log.info("trace: torch profiler capturing for %s", d)
        return True


def stop_profile() -> str | None:
    """Stop the capture and write its Chrome trace into
    ``ETCD_TRACE_DIR``; returns the file's path (None when no capture
    ran)."""
    global _profile
    with _profile_lock:
        prof, _profile = _profile, None
        if prof is None:
            return None
        prof.__exit__(None, None, None)
        path = os.path.join(_profile_dir,
                            f"trace_{os.getpid()}_{int(time.time())}.json")
        prof.export_chrome_trace(path)
        log.info("trace: torch profiler trace written to %s", path)
        return path


__all__ = ["Tracer", "active_stages", "maybe_start_profile",
           "note_device_seconds", "stop_profile", "tracer"]
