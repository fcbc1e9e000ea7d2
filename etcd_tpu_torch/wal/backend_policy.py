"""Measured per-stage backend router for the replay data plane.

The port of ``etcd_tpu/wal/backend_policy.py``.  A replay lane picked
statically can lose to the host path (a slow link, a busy or absent
device), so every replay-shaped stage (restart replay, bulk replay)
asks this router:

- **probe**: a cheap startup measurement of the pipeline legs: host
  fused scan (native scan_verify over a small synthetic stream), H2D
  shipping and the raw-CRC verify on ``default_device(device)``, timed
  with CUDA events on the card.  Cached in-process and, when
  ``cache_path`` is given, on disk so restarts reuse it.  A device
  probe that raises (no CUDA, a kernel that does not build or launch)
  raises out of :meth:`BackendPolicy.route`: the router never hides a
  broken card behind the host lane.
- **route**: ``host`` (fused single-pass native scan), ``device``
  (monolithic batched device verify), or ``stream`` (the chunked
  double-buffered overlap pipeline, wal/replay_device.py).  The
  device lanes are chosen ONLY when the probed pipeline floor —
  min(host_scan, h2d, device_verify), what the overlap pipeline can
  sustain — beats the probed host throughput, so a present-but-slow
  accelerator can never regress replay below the host path.  The
  router itself answers ``host`` or ``stream``; ``device`` is reached
  only by naming it.
- **override**: ``ETCD_REPLAY_BACKEND=host|device|stream`` wins over
  the probe unconditionally (operator escape hatch; read per
  decision, so tests and long-lived processes can flip it).

Every decision lands in the obs registry (``etcd_replay_backend_route``
per stage, ``etcd_replay_probe_bytes_per_sec`` per leg) and in
``snapshot()``, so a regression can be attributed to routing or to
the kernel.  Streams under ``device_min_bytes`` route to the host
without probing.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time

import torch

from .. import default_device, native
from ..obs import metrics as _obs

log = logging.getLogger(__name__)

#: the operator override: host | device | stream
ENV_KNOB = "ETCD_REPLAY_BACKEND"

ROUTES = ("host", "device", "stream")

#: default streaming chunk size: the reference's chunk sweep
#: (``scripts/replay_bench.py``) found host-path throughput flat from
#: 4 MiB up, and 4 MiB keeps at most ~12 MiB of scan arrays in flight
#: at double-buffer depth 2
DEFAULT_CHUNK_BYTES = 4 << 20

#: below this stream size the device lanes can't amortize their
#: start-up (the kernel's build and load, the card's context), so the
#: router answers "host" WITHOUT probing: a tiny-WAL restart must not
#: initialize the card just to be told what the size already says
DEVICE_MIN_BYTES = 8 << 20

#: on-disk probe cache lifetime — a stale measurement pinning the
#: route would recreate the static-choice failure mode this module
#: exists to kill
CACHE_TTL_S = 24 * 3600

# probe shapes: small enough to be a startup blip (~1 MiB host blob,
# one [2048, 384] device batch), large enough to amortize call setup
_PROBE_ENTRIES = 4096
_PROBE_PAYLOAD = 256
_PROBE_ROWS = 2048
_PROBE_WIDTH = 384

_PROBE_LEGS = ("host_scan", "host_frame", "h2d", "device_verify")


def _probe_host_default() -> dict | None:
    """Host-leg throughputs (bytes/s) over a synthetic stream:
    ``host_scan_bps`` is the FUSED pass (frame + parse + CRC — what
    the host route runs), ``host_frame_bps`` the frame/parse-only
    sweep (the streaming pipeline's host stage; the CRC rides the
    device there).  None when the native toolchain is absent."""
    if not native.available():
        return None
    blob = native.wal_gen(_PROBE_ENTRIES, _PROBE_PAYLOAD,
                          start_index=1, seed=0)

    def best_of2(fn):
        best = float("inf")
        for _ in range(2):  # best-of-2: first pass pays page faults
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return blob.nbytes / max(best, 1e-9)

    return {"host_scan_bps":
            best_of2(lambda: native.scan_verify(blob, seed=0)),
            "host_frame_bps":
            best_of2(lambda: native.wal_scan(blob))}


def _probe_device_default(device=None) -> dict:
    """H2D and raw-CRC verify throughput (bytes/s) of one
    ``[2048, 384]`` batch on ``default_device(device)``: on CUDA a copy
    from pinned memory and one kernel launch, each timed with CUDA
    events after a warm-up; on the CPU (only when asked for) by the
    host clock.  Raises without CUDA unless ``device="cpu"``."""
    from ..ops.crc_device import raw_crc_batch

    dev = default_device(device)
    rows = torch.zeros((_PROBE_ROWS, _PROBE_WIDTH), dtype=torch.uint8)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        raw_crc_batch(rows)
        verify = rows.numel() / max(time.perf_counter() - t0, 1e-9)
        return {"h2d_bps": float("inf"), "device_verify_bps": verify}
    rows = rows.pin_memory()

    def timed(fn) -> float:
        fn()  # warm: first copy, kernel build and load
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return rows.numel() / max(a.elapsed_time(b) / 1e3, 1e-9)

    with torch.cuda.device(dev):
        shipped = rows.to(dev)
        return {"h2d_bps": timed(lambda: rows.to(dev, non_blocking=True)),
                "device_verify_bps": timed(lambda: raw_crc_batch(shipped))}


class BackendPolicy:
    """One process's replay-routing state: probe results + decisions.

    ``probe_host`` / ``probe_device`` are injectable for tests (a
    simulated slow device must provably select the host route without
    hardware in the loop; an injected ``probe_device`` takes no
    arguments and may answer None for "no accelerator").  The default
    device probe runs once a process, on the ``device`` of the first
    routed call that needs it (CUDA unless ``device="cpu"``).
    """

    def __init__(self, cache_path: str | None = None,
                 probe_host=None, probe_device=None,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 device_min_bytes: int = DEVICE_MIN_BYTES):
        self._lock = threading.Lock()
        self.cache_path = cache_path
        self.chunk_bytes = int(chunk_bytes)
        self.device_min_bytes = int(device_min_bytes)
        self._probe_host_fn = probe_host or _probe_host_default
        self._probe_device_fn = probe_device
        self._probe: dict | None = None
        self.decisions: dict[str, dict] = {}
        _obs.registry.gauge("etcd_replay_stream_chunk_bytes").set(
            self.chunk_bytes)

    # -- probe ------------------------------------------------------------

    def probe(self, device=None) -> dict:
        """Measure (or recall) the per-leg throughputs, the device legs
        on ``device``.  One probe per process; ``cache_path`` extends
        the reuse across restarts.  Raises what either probe raises;
        nothing is cached then."""
        with self._lock:
            if self._probe is not None:
                return self._probe
            p = self._load_cache()
            if p is None:
                p = self._measure(device)
                self._save_cache(p)
            else:
                p["source"] = "cache"
            self._probe = p
        for leg in _PROBE_LEGS:
            _obs.registry.gauge(
                "etcd_replay_probe_bytes_per_sec", leg=leg).set(
                p.get(f"{leg}_bps") or 0.0)
        return p

    def _measure(self, device) -> dict:
        p: dict = {"source": "probe",
                   "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                       time.gmtime()),
                   "ts_epoch": time.time()}
        ph = self._probe_host_fn()
        if isinstance(ph, dict):
            p["host_scan_bps"] = ph.get("host_scan_bps")
            p["host_frame_bps"] = ph.get("host_frame_bps",
                                         ph.get("host_scan_bps"))
        else:  # injected scalar probes: one number for both legs
            p["host_scan_bps"] = ph
            p["host_frame_bps"] = ph
        dev = self._probe_device_fn() if self._probe_device_fn \
            else _probe_device_default(device)
        p["h2d_bps"] = (dev or {}).get("h2d_bps")
        p["device_verify_bps"] = (dev or {}).get("device_verify_bps")
        return p

    def _load_cache(self) -> dict | None:
        if not self.cache_path:
            return None
        try:
            with open(self.cache_path) as fh:
                doc = json.load(fh)
            if doc.get("version") != 1:
                return None
            p = dict(doc["probe"])
            age = time.time() - float(p.get("ts_epoch", 0))
            if not 0 <= age <= CACHE_TTL_S:
                log.info("backend_policy: probe cache is %.0fh old; "
                         "re-probing", age / 3600)
                return None
            return p
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def _save_cache(self, p: dict) -> None:
        if not self.cache_path:
            return
        try:
            tmp = self.cache_path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump({"version": 1, "probe": p}, fh)
            os.replace(tmp, self.cache_path)
        except OSError as e:  # cache is an optimization, never fatal
            log.warning("backend_policy: cache write failed: %r", e)

    # -- routing ----------------------------------------------------------

    def route(self, stage: str, size_bytes: int | None = None,
              device=None) -> str:
        """Pick host | device | stream for one replay-shaped stage.

        Precedence: env override > size gate > probe comparison (the
        device legs probed on ``device``).  The decision is recorded
        per ``stage`` in the registry and in :attr:`decisions`.
        """
        route, why = self._env_route()
        if route is None and size_bytes is not None \
                and size_bytes < self.device_min_bytes:
            # tiny streams: the device lanes can't amortize their
            # start-up, and the device probe would initialize the card
            # on the restart path — answer without either
            route, why = "host", (
                f"size {int(size_bytes)} B < device threshold "
                f"{self.device_min_bytes} B")
        if route is None:
            probe = self.probe(device)
            if probe.get("device_verify_bps") is None:
                route, why = "host", "no usable accelerator"
            else:
                # host route sustains the FUSED pass; the pipeline
                # sustains min over its legs — frame-only host scan
                # (CRC rides the device), H2D, device verify
                host = probe.get("host_scan_bps") or 0.0
                floor = min(x for x in (
                    probe.get("host_frame_bps") or float("inf"),
                    probe["h2d_bps"],
                    probe["device_verify_bps"]))
                if floor > host:
                    route, why = "stream", (
                        f"pipeline floor {floor:.3g} B/s > host "
                        f"{host:.3g} B/s")
                else:
                    route, why = "host", (
                        f"pipeline floor {floor:.3g} B/s <= host "
                        f"{host:.3g} B/s")
        return self.note(stage, route, why, size_bytes=size_bytes)

    def note(self, stage: str, route: str, why: str,
             size_bytes: int | None = None) -> str:
        """Record (or overwrite) a stage's decision: the registry's
        route gauges and :attr:`decisions`, so a regression can be
        attributed to the lane that ran."""
        decision = {"route": route, "why": why, "stage": stage}
        if size_bytes is not None:
            decision["size_bytes"] = int(size_bytes)
        elif stage in self.decisions \
                and "size_bytes" in self.decisions[stage]:
            decision["size_bytes"] = \
                self.decisions[stage]["size_bytes"]
        self.decisions[stage] = decision
        for r in ROUTES:
            _obs.registry.gauge("etcd_replay_backend_route",
                                stage=stage, route=r).set(
                1.0 if r == route else 0.0)
        return route

    def _env_route(self) -> tuple[str | None, str | None]:
        raw = os.environ.get(ENV_KNOB, "").strip().lower()
        if not raw:
            return None, None
        if raw not in ROUTES:
            log.warning("backend_policy: ignoring %s=%r (want one of "
                        "%s)", ENV_KNOB, raw, "/".join(ROUTES))
            return None, None
        return raw, f"env {ENV_KNOB}={raw}"

    def snapshot(self) -> dict:
        """Probe numbers + per-stage decisions, JSON-ready."""
        out = {"chunk_bytes": self.chunk_bytes,
               "decisions": dict(self.decisions)}
        if self._probe is not None:
            out["probe"] = dict(self._probe)
        return out


# -- process-wide singleton ---------------------------------------------------

_policy: BackendPolicy | None = None
_policy_lock = threading.Lock()


def get_policy() -> BackendPolicy:
    """The process's router (probe runs once, on first routed call).
    ``ETCD_REPLAY_PROBE_CACHE`` names an optional on-disk cache file
    so short-lived processes (restart loops) skip re-probing."""
    global _policy
    with _policy_lock:
        if _policy is None:
            _policy = BackendPolicy(
                cache_path=os.environ.get("ETCD_REPLAY_PROBE_CACHE")
                or None)
        return _policy


def set_policy(p: BackendPolicy | None) -> None:
    """Swap (or, with None, reset) the process router — tests."""
    global _policy
    with _policy_lock:
        _policy = p


__all__ = [
    "BackendPolicy", "DEFAULT_CHUNK_BYTES", "ENV_KNOB", "ROUTES",
    "get_policy", "set_policy",
]
