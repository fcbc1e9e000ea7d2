"""Device/host transfer ledger: per-stage accounting of the device
dispatch seams (the port of ``etcd_tpu/obs/devledger.py``).

Each instrumented seam records, per named stage ("replay.verify",
"replay.stream", ...):

- **dispatches** and wall seconds inside the seam,
- **block seconds**: time spent waiting on device results
  (:meth:`DeviceLedger.block` synchronizes the CUDA device where the
  reference calls ``jax.block_until_ready``),
- **H2D / D2H bytes**: what crossed the boundary, and **fetches**: how
  many device-to-host reads (each one a host sync on the card).

They feed the ``etcd_devledger_*`` counter families of
``obs/metrics.py``.  When a seam runs inside an active
``tracer.stage(...)``, its device seconds are charged once to that
stage's ``etcd_stage_seconds{kind="device"}`` column: a ``dispatch``
seam charges its whole window at exit; ``block`` and ``fetch`` charge
only outside a dispatch seam (the window already holds them).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

from .metrics import Registry, registry as default_registry

_tls = threading.local()  # per-thread active-dispatch depth


def _charge_stage(dt: float) -> None:
    # imported here: utils/trace imports obs.metrics, and obs must
    # stay importable before utils
    from ..utils.trace import note_device_seconds

    note_device_seconds(dt)


def nbytes_of(x) -> int:
    """Best-effort byte size of one array-ish value (numpy arrays,
    torch tensors, bytes)."""
    n = getattr(x, "nbytes", None)
    if n is not None:
        return int(n)
    if isinstance(x, (bytes, bytearray, memoryview)):
        return len(x)
    return 0


class _Stage:
    __slots__ = ("dispatches", "dispatch_seconds", "block_seconds",
                 "h2d_bytes", "d2h_bytes", "fetches")

    def __init__(self, reg: Registry, stage: str):
        self.dispatches = reg.counter(
            "etcd_devledger_dispatches_total", stage=stage)
        self.dispatch_seconds = reg.counter(
            "etcd_devledger_dispatch_seconds_total", stage=stage)
        self.block_seconds = reg.counter(
            "etcd_devledger_block_seconds_total", stage=stage)
        self.h2d_bytes = reg.counter(
            "etcd_devledger_h2d_bytes_total", stage=stage)
        self.d2h_bytes = reg.counter(
            "etcd_devledger_d2h_bytes_total", stage=stage)
        self.fetches = reg.counter(
            "etcd_devledger_fetches_total", stage=stage)


class DeviceLedger:
    def __init__(self, reg: Registry | None = None):
        self._reg = reg if reg is not None else default_registry
        self._lock = threading.Lock()
        self._stages: dict[str, _Stage] = {}

    def _stage(self, stage: str) -> _Stage:
        s = self._stages.get(stage)
        if s is None:
            with self._lock:
                s = self._stages.get(stage)
                if s is None:
                    s = _Stage(self._reg, stage)
                    self._stages[stage] = s
        return s

    @contextmanager
    def dispatch(self, stage: str):
        """Time one pass through a dispatch seam."""
        s = self._stage(stage)
        depth = getattr(_tls, "dispatch_depth", 0)
        _tls.dispatch_depth = depth + 1
        t0 = time.perf_counter()
        try:
            yield s
        finally:
            dt = time.perf_counter() - t0
            _tls.dispatch_depth = depth
            s.dispatches.inc()
            s.dispatch_seconds.inc(dt)
            if depth == 0:  # a nested seam's window is inside ours
                _charge_stage(dt)

    def h2d(self, stage: str, *values) -> None:
        n = sum(nbytes_of(v) for v in values)
        if n:
            self._stage(stage).h2d_bytes.inc(n)

    def d2h(self, stage: str, *values) -> None:
        n = sum(nbytes_of(v) for v in values)
        if n:
            self._stage(stage).d2h_bytes.inc(n)

    def block(self, stage: str, value):
        """Wait for the device work behind ``value`` (a CUDA tensor, or
        anything else, which is returned as it is) with the wait billed
        to the stage; returns ``value``."""
        import torch

        s = self._stage(stage)
        t0 = time.perf_counter()
        if isinstance(value, torch.Tensor) and value.is_cuda:
            torch.cuda.synchronize(value.device)
        dt = time.perf_counter() - t0
        s.block_seconds.inc(dt)
        if not getattr(_tls, "dispatch_depth", 0):
            _charge_stage(dt)
        return value

    def fetch(self, stage: str, value):
        """Copy a tensor (on any device) to a host numpy array, billing
        the wait, which holds the device work behind ``value``, as block
        time and the result's bytes as D2H; one count per call.  A
        numpy array is returned as it is, uncounted."""
        import numpy as np
        import torch

        if not isinstance(value, torch.Tensor):
            return np.asarray(value)
        s = self._stage(stage)
        t0 = time.perf_counter()
        out = value.detach().cpu().numpy()
        dt = time.perf_counter() - t0
        s.block_seconds.inc(dt)
        s.d2h_bytes.inc(out.nbytes)
        s.fetches.inc()
        if not getattr(_tls, "dispatch_depth", 0):
            _charge_stage(dt)
        return out

    def snapshot(self) -> dict:
        """Per-stage totals of the same counters."""
        out = {}
        with self._lock:
            stages = dict(self._stages)
        for name, s in stages.items():
            out[name] = {
                "dispatches": s.dispatches.get(),
                "dispatch_seconds": round(s.dispatch_seconds.get(), 6),
                "block_seconds": round(s.block_seconds.get(), 6),
                "h2d_bytes": s.h2d_bytes.get(),
                "d2h_bytes": s.d2h_bytes.get(),
                "fetches": s.fetches.get(),
            }
        return out


#: process-wide default ledger, recording into the default registry
ledger = DeviceLedger()

__all__ = ["DeviceLedger", "ledger", "nbytes_of"]
