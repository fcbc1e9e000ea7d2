"""Declared service-level objectives over the time-series rings (the
port's copy of ``etcd_tpu/obs/slo.py``).

Each :class:`Objective` declares what "bad" means over a window:

- **latency** objectives bound a quantile ("write-ack p99 <= 500 ms
  over the last minute"): bad = the fraction of windowed
  observations ABOVE the target boundary (from merged bucket deltas,
  so the math is exact at bucket granularity); the allowed bad
  fraction is ``1 - q``.
- **ratio** objectives bound a bad-outcome share ("shed rate
  <= 5%", "read availability >= 99.9%"): good = samples whose
  ``good_label`` matches, bad = everything else.

The **burn rate** is the Monarch/SRE-workbook form: observed bad
fraction divided by the allowed bad fraction — 1.0 consumes the
error budget exactly at the sustainable pace, >1 is burning, 0 with
no traffic (an idle objective is vacuously met).  Every evaluation
exports ``etcd_slo_burn_rate{objective}`` and
``etcd_slo_ok{objective}`` gauges (CATALOG families) and the typed
``GET /v2/stats/slo`` verdict served by both stats endpoints and the
role supervisor's merged plane.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass

from . import metrics as _metrics
from . import timeseries as _timeseries


@dataclass(frozen=True)
class Objective:
    """One declared objective.

    ``target`` is the latency bound in seconds (latency kind) or the
    allowed bad fraction (ratio kind).  ``good_label`` is the
    (label key, good value) pair splitting a ratio family's samples
    into good/bad."""

    name: str
    kind: str                    # "latency" | "ratio"
    family: str
    target: float
    q: float = 0.99
    window_s: float = 60.0
    good_label: tuple[str, str] = ("outcome", "ok")
    doc: str = ""


#: The cluster's declared objectives (targets overridable by env in
#: deployments that need it; these defaults fit the loopback bench).
DEFAULT_OBJECTIVES: tuple[Objective, ...] = (
    Objective(
        "write_ack_p99", "latency", "etcd_ack_rtt_seconds",
        target=0.5, q=0.99,
        doc="consensus write-ack p99 <= 500 ms over the last "
            "minute"),
    Objective(
        "read_p99", "latency", "etcd_read_rtt_seconds",
        target=0.25, q=0.99,
        doc="linearizable read p99 <= 250 ms over the last minute"),
    Objective(
        "shed_rate", "ratio", "etcd_admission_total",
        target=0.05, good_label=("outcome", "admit"),
        doc="front-door shed rate <= 5% of admission decisions"),
    Objective(
        "availability", "ratio", "etcd_read_serve_total",
        target=0.001, good_label=("outcome", "ok"),
        doc="read serves succeed >= 99.9% (bad fraction <= 0.1%)"),
)


def _window_counts(snaps: list[dict], obj: Objective
                   ) -> tuple[float, float, float]:
    """(bad, total, value) over the objective's window, merged
    across ring snapshots.  ``value`` is the windowed pXX for
    latency objectives, the bad fraction for ratio ones."""
    if obj.kind == "latency":
        d = _metrics.CATALOG[obj.family]
        bounds = list(d.buckets)
        buckets = [0] * (len(bounds) + 1)
        total = 0
        for snap in snaps:
            for st in _timeseries._snap_window(snap, obj.window_s):
                for fam, _labels, dc, _ds, db in st.get("hists", ()):
                    if fam == obj.family:
                        total += dc
                        for i, c in enumerate(db):
                            buckets[i] += c
        if not total:
            return 0.0, 0.0, 0.0
        good = sum(c for b, c in zip(bounds, buckets)
                   if b <= obj.target)
        value = _metrics.percentile_from_buckets(bounds, buckets,
                                                 obj.q)
        return float(total - good), float(total), value
    # ratio
    k, good_v = obj.good_label
    good = _timeseries.snap_rate(snaps, obj.family, obj.window_s,
                                 {k: good_v})
    total = _timeseries.snap_rate(snaps, obj.family, obj.window_s)
    if total <= 0:
        return 0.0, 0.0, 0.0
    bad = max(0.0, total - good)
    return bad, total, bad / total


def evaluate(snaps: list[dict],
             objectives: tuple[Objective, ...] = DEFAULT_OBJECTIVES,
             registry: _metrics.Registry | None = None) -> dict:
    """Evaluate objectives over harvested ring snapshots into the
    typed verdict dict; when ``registry`` is given, also export the
    burn-rate/ok gauges there."""
    out: dict = {"t": time.time(), "objectives": {}}
    worst_name, worst_burn = None, -1.0
    for obj in objectives:
        bad, total, value = _window_counts(snaps, obj)
        allowed = ((1.0 - obj.q) if obj.kind == "latency"
                   else obj.target)
        bad_frac = bad / total if total > 0 else 0.0
        burn = bad_frac / allowed if allowed > 0 else 0.0
        ok = burn <= 1.0
        out["objectives"][obj.name] = {
            "kind": obj.kind,
            "family": obj.family,
            "target": obj.target,
            "window_s": obj.window_s,
            "samples": total,
            "value": round(value, 6),
            "bad_fraction": round(bad_frac, 6),
            "burn_rate": round(burn, 4),
            "ok": ok,
            "doc": obj.doc,
        }
        if burn > worst_burn:
            worst_name, worst_burn = obj.name, burn
        if registry is not None:
            registry.gauge("etcd_slo_burn_rate",
                           objective=obj.name).set(burn)
            registry.gauge("etcd_slo_ok",
                           objective=obj.name).set(1.0 if ok
                                                   else 0.0)
    sampled = any(o["samples"] > 0
                  for o in out["objectives"].values())
    burning = any(not o["ok"] for o in out["objectives"].values())
    out["verdict"] = ("burning" if burning
                      else "ok" if sampled else "no_data")
    out["worst"] = worst_name
    return out


def merge_verdicts(verdicts: list[dict]) -> dict:
    """Worst-of merge of per-node verdicts (bench rows):
    each objective keeps its highest burn, the cluster verdict is
    the most severe."""
    out: dict = {"t": time.time(), "objectives": {}}
    rank = {"no_data": 0, "ok": 1, "burning": 2}
    verdict = "no_data"
    worst_name, worst_burn = None, -1.0
    for v in verdicts:
        if rank.get(v.get("verdict"), 0) > rank[verdict]:
            verdict = v["verdict"]
        for name, o in v.get("objectives", {}).items():
            cur = out["objectives"].get(name)
            if cur is None or o["burn_rate"] > cur["burn_rate"]:
                out["objectives"][name] = dict(o)
    for name, o in out["objectives"].items():
        if o["burn_rate"] > worst_burn:
            worst_name, worst_burn = name, o["burn_rate"]
    out["verdict"] = verdict
    out["worst"] = worst_name
    return out


class SLOEvaluator:
    """Bound evaluator: one ring + one registry to export into."""

    def __init__(self, ts: _timeseries.TimeSeries,
                 objectives: tuple[Objective, ...]
                 = DEFAULT_OBJECTIVES,
                 registry: _metrics.Registry | None = None):
        self.ts = ts
        self.objectives = objectives
        self._reg = registry

    def evaluate(self) -> dict:
        return evaluate([self.ts.snapshot()], self.objectives,
                        self._reg)

    def verdict_json(self) -> bytes:
        return (json.dumps(self.evaluate(), sort_keys=True)
                + "\n").encode()


_default: SLOEvaluator | None = None
_default_lock = threading.Lock()


def default_evaluator() -> SLOEvaluator:
    """Process-wide evaluator over the default ring, exporting its
    gauges into the default registry (so burn rates ride /metrics
    and the supervisor merge)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = SLOEvaluator(_timeseries.start_default(),
                                    registry=_metrics.registry)
        return _default


def default_verdict_json() -> bytes:
    """The ``GET /v2/stats/slo`` body."""
    return default_evaluator().verdict_json()


__all__ = [
    "DEFAULT_OBJECTIVES", "Objective", "SLOEvaluator",
    "default_evaluator", "default_verdict_json", "evaluate",
    "merge_verdicts",
]
