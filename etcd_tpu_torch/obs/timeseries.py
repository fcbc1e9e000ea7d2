"""Time-series rings over the metrics registry (the port's copy of
``etcd_tpu/obs/timeseries.py``).

The registry's counters and histograms are cumulative — perfect for
Prometheus, useless for "what happened in the last 10 seconds"
without two hand-timed scrapes.  This module keeps a bounded ring of
per-step DELTAS so windowed rates ("acked/s over the last 10 s") and
windowed percentiles ("ack-RTT p99 this minute", from merged bucket
deltas through ``percentile_from_buckets``) are queryable live:

- one :class:`TimeSeries` per process samples a snapshot source every
  ``step`` seconds and appends one :class:`_Step` of deltas
  (drop-oldest past ``retention`` steps — a ``deque(maxlen=...)``);
- a child restart (cumulative value moving BACKWARD) is treated as a
  fresh incarnation: the delta is the new value, never negative;
- the source is either a :class:`~.metrics.Registry` or any callable
  returning the registry snapshot dict shape — the supervisor feeds
  its merged cross-role view through the same ring type;
- family names are CATALOG-checked at query time (a typo'd family
  fails loudly, the metrics-vocabulary stance).

The JSON form (``/mraft/obs/timeseries``) is what dist_bench merges
across nodes via :func:`windowed_summary`.

Stdlib-only, like the rest of ``obs/``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from . import metrics as _metrics

#: default sampling cadence / ring depth: 1 s steps, 2 min retention
DEFAULT_STEP_S = 1.0
DEFAULT_RETENTION = 120


class _Step:
    """Deltas for one sampling step.  Keys are
    ``(family, ((label, value), ...))`` tuples; gauges store levels
    (last-write-wins has no meaningful delta)."""

    __slots__ = ("t", "dt", "counters", "hists", "gauges")

    def __init__(self, t: float, dt: float):
        self.t = t
        self.dt = dt
        self.counters: dict[tuple, float] = {}
        # (dcount, dsum, dbuckets)
        self.hists: dict[tuple, tuple[int, float, list[int]]] = {}
        self.gauges: dict[tuple, float] = {}


def _labelkey(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class TimeSeries:
    """Bounded ring of windowed deltas over a snapshot source."""

    def __init__(self, source, step: float = DEFAULT_STEP_S,
                 retention: int = DEFAULT_RETENTION,
                 catalog: dict | None = None):
        if isinstance(source, _metrics.Registry):
            # per-second stepping only consumes count/sum/buckets —
            # skip the exact-percentile ring sorts
            self._source = lambda: source.snapshot(light=True)
        elif hasattr(source, "snapshot"):
            self._source = source.snapshot
        else:
            self._source = source
        self.step_s = float(step)
        self.retention = int(retention)
        self._catalog = (catalog if catalog is not None
                         else _metrics.CATALOG)
        self._lock = threading.Lock()
        self._prev: dict[tuple, object] = {}
        self._ring: deque[_Step] = deque(maxlen=self.retention)
        self._last_mono: float | None = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # -- sampling ---------------------------------------------------------

    def step_once(self) -> None:
        """Take one delta step.  Safe from any thread; the snapshot
        read happens OUTSIDE the ring lock (registry child locks are
        leaves — never nested under ours)."""
        snap = self._source()
        now_mono = time.monotonic()
        now_wall = time.time()
        with self._lock:
            dt = (self.step_s if self._last_mono is None
                  else max(1e-9, now_mono - self._last_mono))
            self._last_mono = now_mono
            st = _Step(now_wall, dt)
            for family, fam in snap.items():
                kind = fam.get("kind")
                for s in fam.get("samples", ()):
                    key = (family, _labelkey(s.get("labels", {})))
                    if kind == "counter":
                        v = float(s.get("value", 0.0))
                        p = self._prev.get(key)
                        d = v - p if isinstance(p, float) \
                            and v >= p else v
                        self._prev[key] = v
                        if d:
                            st.counters[key] = d
                    elif kind == "histogram":
                        c = int(s.get("count", 0))
                        tot = float(s.get("sum", 0.0))
                        bk = list(s.get("buckets", ()))
                        p = self._prev.get(key)
                        if isinstance(p, tuple) and c >= p[0]:
                            dc = c - p[0]
                            ds = tot - p[1]
                            db = [a - b for a, b in zip(bk, p[2])]
                        else:  # fresh child / restarted incarnation
                            dc, ds, db = c, tot, bk
                        self._prev[key] = (c, tot, bk)
                        if dc:
                            st.hists[key] = (dc, ds, db)
                    elif kind == "gauge":
                        st.gauges[key] = float(s.get("value", 0.0))
            self._ring.append(st)

    def start(self) -> "TimeSeries":
        """Arm the background sampler (idempotent)."""
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="obs-timeseries")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        while not self._stop.wait(self.step_s):
            try:
                self.step_once()
            except Exception:  # pragma: no cover - source died
                pass

    # -- queries ----------------------------------------------------------

    def _check(self, family: str) -> None:
        if family not in self._catalog:
            raise KeyError(
                f"metric {family!r} is not in the catalog "
                f"(register it in obs/metrics.py CATALOG)")

    def _window(self, window_s: float) -> list[_Step]:
        steps: list[_Step] = []
        span = 0.0
        with self._lock:
            ring = list(self._ring)
        for st in reversed(ring):
            if span >= window_s:
                break
            steps.append(st)
            span += st.dt
        return steps

    @staticmethod
    def _match(key: tuple, family: str, flt: dict) -> bool:
        if key[0] != family:
            return False
        if flt:
            labels = dict(key[1])
            return all(labels.get(k) == v for k, v in flt.items())
        return True

    def rate(self, family: str, window_s: float = 10.0,
             **label_filter) -> float:
        """Per-second rate of a counter family (or a histogram
        family's observation count) over the last ``window_s``."""
        self._check(family)
        steps = self._window(window_s)
        span = sum(st.dt for st in steps)
        if span <= 0:
            return 0.0
        total = 0.0
        for st in steps:
            for key, d in st.counters.items():
                if self._match(key, family, label_filter):
                    total += d
            for key, (dc, _ds, _db) in st.hists.items():
                if self._match(key, family, label_filter):
                    total += dc
        return total / span

    def windowed_hist(self, family: str, window_s: float = 60.0,
                      **label_filter) -> dict | None:
        """Merged bucket deltas of a histogram family over the
        window — the ``merge_histograms`` shape, or None when no
        sample landed."""
        self._check(family)
        d = self._catalog[family]
        bounds = list(d.buckets)
        buckets = [0] * (len(bounds) + 1)
        count = 0
        total = 0.0
        for st in self._window(window_s):
            for key, (dc, ds, db) in st.hists.items():
                if self._match(key, family, label_filter):
                    count += dc
                    total += ds
                    for i, c in enumerate(db):
                        buckets[i] += c
        if not count:
            return None
        return {"bounds": bounds, "buckets": buckets,
                "count": count, "sum": total}

    def percentile(self, family: str, q: float,
                   window_s: float = 60.0,
                   **label_filter) -> float:
        """Windowed upper-bound percentile from merged bucket
        deltas (the cross-process estimator)."""
        h = self.windowed_hist(family, window_s, **label_filter)
        if h is None:
            return 0.0
        return _metrics.percentile_from_buckets(
            h["bounds"], h["buckets"], q)

    # -- serialization ----------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-ready ring dump (the ``/mraft/obs/timeseries``
        body): every step's non-zero deltas with labels expanded."""
        with self._lock:
            ring = list(self._ring)
        steps = []
        for st in ring:
            steps.append({
                "t": st.t, "dt": st.dt,
                "counters": [[k[0], dict(k[1]), d]
                             for k, d in sorted(st.counters.items())],
                "hists": [[k[0], dict(k[1]), dc, ds, db]
                          for k, (dc, ds, db)
                          in sorted(st.hists.items())],
                "gauges": [[k[0], dict(k[1]), v]
                           for k, v in sorted(st.gauges.items())],
            })
        return {"step_s": self.step_s, "retention": self.retention,
                "now": time.time(), "steps": steps}

    def snapshot_json(self) -> bytes:
        return (json.dumps(self.snapshot(), sort_keys=True)
                + "\n").encode()


# -- cross-node merge helpers (pure functions over snapshot dicts) ----------


def _snap_window(snap: dict, window_s: float) -> list[dict]:
    steps = snap.get("steps", [])
    out: list[dict] = []
    span = 0.0
    for st in reversed(steps):
        if span >= window_s:
            break
        out.append(st)
        span += float(st.get("dt", 0.0))
    return out


def snap_rate(snaps: list[dict], family: str,
              window_s: float = 10.0,
              label_filter: dict | None = None) -> float:
    """Summed per-second rate of ``family`` across harvested ring
    snapshots (one per node/role) over the trailing window."""
    flt = label_filter or {}
    total = 0.0
    span = 0.0
    for snap in snaps:
        steps = _snap_window(snap, window_s)
        span = max(span, sum(float(st.get("dt", 0.0))
                             for st in steps))
        for st in steps:
            for fam, labels, d in st.get("counters", ()):
                if fam == family and all(
                        labels.get(k) == v for k, v in flt.items()):
                    total += d
            for fam, labels, dc, _ds, _db in st.get("hists", ()):
                if fam == family and all(
                        labels.get(k) == v for k, v in flt.items()):
                    total += dc
    return total / span if span > 0 else 0.0


def snap_percentile(snaps: list[dict], family: str, q: float,
                    window_s: float = 60.0) -> float:
    """Windowed percentile from bucket deltas merged across
    harvested ring snapshots."""
    d = _metrics.CATALOG.get(family)
    if d is None:
        raise KeyError(family)
    bounds = list(d.buckets)
    buckets = [0] * (len(bounds) + 1)
    count = 0
    for snap in snaps:
        for st in _snap_window(snap, window_s):
            for fam, _labels, dc, _ds, db in st.get("hists", ()):
                if fam == family:
                    count += dc
                    for i, c in enumerate(db):
                        buckets[i] += c
    if not count:
        return 0.0
    return _metrics.percentile_from_buckets(bounds, buckets, q)


def windowed_summary(snaps: list[dict]) -> dict:
    """The standard windowed row embedded in bench results:
    short-window rates + minute-window percentiles, merged across
    every harvested ring."""
    admit = snap_rate(snaps, "etcd_admission_total", 60.0,
                      {"outcome": "admit"})
    total = snap_rate(snaps, "etcd_admission_total", 60.0)
    return {
        "acked_per_s_10s": round(
            snap_rate(snaps, "etcd_ack_rtt_seconds", 10.0), 1),
        "reads_per_s_10s": round(
            snap_rate(snaps, "etcd_read_rtt_seconds", 10.0), 1),
        "ack_rtt_p99_ms_60s": round(snap_percentile(
            snaps, "etcd_ack_rtt_seconds", 0.99) * 1e3, 3),
        "read_rtt_p99_ms_60s": round(snap_percentile(
            snaps, "etcd_read_rtt_seconds", 0.99) * 1e3, 3),
        "shed_rate_60s": round(
            (total - admit) / total if total > 0 else 0.0, 6),
        "estimator": "bucket-le-upper-bound",
    }


# -- process-wide default ring ----------------------------------------------

_default: TimeSeries | None = None
_default_lock = threading.Lock()


def start_default() -> TimeSeries:
    """The process-wide ring over the default registry, armed on
    first use (every role calls this at start; the stats endpoints
    call it on first query).  Step/retention come from
    ``ETCD_TS_STEP_S`` / ``ETCD_TS_RETENTION``."""
    global _default
    with _default_lock:
        if _default is None:
            step = float(os.environ.get("ETCD_TS_STEP_S")
                         or DEFAULT_STEP_S)
            keep = int(os.environ.get("ETCD_TS_RETENTION")
                       or DEFAULT_RETENTION)
            _default = TimeSeries(_metrics.registry, step=step,
                                  retention=keep).start()
        return _default


__all__ = [
    "DEFAULT_RETENTION", "DEFAULT_STEP_S", "TimeSeries",
    "snap_percentile", "snap_rate", "start_default",
    "windowed_summary",
]
