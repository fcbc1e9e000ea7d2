"""Cross-role metric aggregation for the supervisor plane (the port's
copy of ``etcd_tpu/obs/aggregate.py``).

The role split (``server/roles.py``) leaves every child role with its
own registry behind its own port.  The supervisor scrapes each child's
``/mraft/obs`` snapshot into a :class:`MetricsAggregator`, which
serves ONE merged view with a ``role`` label, under two contracts:

- **Monotone across incarnations.**  A respawned child restarts its
  counters at zero; the aggregator detects the backward step
  (cumulative value or histogram count moving down) and folds the
  previous incarnation's final value into a per-(role, family,
  labels) base, so ``merged = base + current`` never regresses and
  never double-counts.  Increments the dead incarnation made after
  its last scrape are lost — standard scrape-model semantics, same
  as any Prometheus restart.
- **Stale-marked, never a scrape error.**  A child that is down or
  mid-respawn keeps its last-known samples in the merged view;
  ``etcd_role_up{role}`` drops to 0 and the JSON view carries the
  staleness age — the merged endpoints themselves always answer 200.

Merged histogram samples keep the ``merge_histograms`` shape
(bounds/buckets/count/sum) plus bucket-estimated percentiles
(``estimator: bucket-le-upper-bound`` — cross-process rings cannot
be pooled exactly).  Stdlib-only.
"""

from __future__ import annotations

import json
import threading
import time

from . import metrics as _metrics

#: a role whose last good scrape is older than this is stale
STALE_AFTER_S = 5.0


class _RoleState:
    __slots__ = ("snap", "prev", "base", "last_ok", "scrapes",
                 "errors")

    def __init__(self):
        self.snap: dict = {}
        # (family, labelkey) -> last cumulative (float | (count,
        # sum, buckets)); base -> folded dead-incarnation totals
        self.prev: dict[tuple, object] = {}
        self.base: dict[tuple, object] = {}
        self.last_ok = 0.0
        self.scrapes = 0
        self.errors = 0


def _labelkey(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class MetricsAggregator:
    """Merge per-role registry snapshots into one labeled view."""

    def __init__(self, catalog: dict | None = None,
                 stale_after: float = STALE_AFTER_S):
        self._catalog = (catalog if catalog is not None
                         else _metrics.CATALOG)
        self.stale_after = stale_after
        self._lock = threading.Lock()
        self._roles: dict[str, _RoleState] = {}

    # -- ingest -----------------------------------------------------------

    def observe(self, role: str, snap: dict,
                t: float | None = None) -> None:
        """Fold one successful scrape of ``role``; detects a
        restarted incarnation and carries its totals forward."""
        now = time.monotonic() if t is None else t
        with self._lock:
            st = self._roles.setdefault(role, _RoleState())
            st.snap = snap
            st.last_ok = now
            st.scrapes += 1
            for family, fam in snap.items():
                kind = fam.get("kind")
                if kind not in ("counter", "histogram"):
                    continue
                for s in fam.get("samples", ()):
                    key = (family, _labelkey(s.get("labels", {})))
                    if kind == "counter":
                        v = float(s.get("value", 0.0))
                        p = st.prev.get(key)
                        if isinstance(p, float) and v < p:
                            st.base[key] = \
                                float(st.base.get(key, 0.0)) + p
                        st.prev[key] = v
                    else:
                        c = int(s.get("count", 0))
                        tot = float(s.get("sum", 0.0))
                        bk = list(s.get("buckets", ()))
                        p = st.prev.get(key)
                        if isinstance(p, tuple) and c < p[0]:
                            b = st.base.get(key)
                            if b is None:
                                b = (0, 0.0,
                                     [0] * len(p[2]))
                            st.base[key] = (
                                b[0] + p[0], b[1] + p[1],
                                [x + y for x, y
                                 in zip(b[2], p[2])])
                        st.prev[key] = (c, tot, bk)

    def scrape_failed(self, role: str) -> None:
        with self._lock:
            st = self._roles.setdefault(role, _RoleState())
            st.errors += 1

    # -- merged views -----------------------------------------------------

    def roles(self, now: float | None = None) -> dict:
        """{role: {up, stale_s, scrapes, errors}} liveness table."""
        now = time.monotonic() if now is None else now
        out = {}
        with self._lock:
            for role, st in self._roles.items():
                age = now - st.last_ok if st.last_ok else None
                out[role] = {
                    "up": bool(age is not None
                               and age <= self.stale_after),
                    "stale_s": (round(age, 3)
                                if age is not None else None),
                    "scrapes": st.scrapes,
                    "errors": st.errors,
                }
        return out

    def merged_families(self, now: float | None = None) -> dict:
        """Registry-snapshot-shaped merge: every family once, each
        sample carrying its source ``role`` label, counters and
        histograms base-folded monotone.  Also injects the
        ``etcd_role_up`` liveness family."""
        now = time.monotonic() if now is None else now
        out: dict = {}
        with self._lock:
            roles = sorted(self._roles)
            for family in sorted(self._catalog):
                d = self._catalog[family]
                samples = []
                for role in roles:
                    st = self._roles[role]
                    fam = st.snap.get(family)
                    if fam is None:
                        continue
                    for s in fam.get("samples", ()):
                        labels = dict(s.get("labels", {}))
                        key = (family, _labelkey(labels))
                        labels["role"] = role
                        if d.kind == "counter":
                            v = float(s.get("value", 0.0))
                            v += float(st.base.get(key, 0.0))
                            samples.append({"labels": labels,
                                            "value": v})
                        elif d.kind == "gauge":
                            samples.append(
                                {"labels": labels,
                                 "value": float(
                                     s.get("value", 0.0))})
                        else:
                            b = st.base.get(key)
                            c = int(s.get("count", 0))
                            tot = float(s.get("sum", 0.0))
                            bk = list(s.get("buckets", ()))
                            if b is not None:
                                c += b[0]
                                tot += b[1]
                                bk = [x + y for x, y
                                      in zip(bk, b[2])]
                            bounds = list(s.get("bounds",
                                                d.buckets))
                            entry = {
                                "labels": labels, "count": c,
                                "sum": tot, "bounds": bounds,
                                "buckets": bk,
                                "max": float(s.get("max", 0.0)),
                                "estimator":
                                    "bucket-le-upper-bound",
                            }
                            for pk, q in (("p50", 0.5),
                                          ("p90", 0.9),
                                          ("p99", 0.99),
                                          ("p999", 0.999)):
                                entry[pk] = \
                                    _metrics.\
                                    percentile_from_buckets(
                                        bounds, bk, q)
                            samples.append(entry)
                out[family] = {"kind": d.kind, "help": d.help,
                               "samples": samples}
            up_fam = out.get("etcd_role_up")
            if up_fam is not None:
                for role in roles:
                    st = self._roles[role]
                    age = (now - st.last_ok if st.last_ok
                           else None)
                    up = bool(age is not None
                              and age <= self.stale_after)
                    up_fam["samples"].append(
                        {"labels": {"role": role},
                         "value": 1.0 if up else 0.0})
        return out

    def merged(self, now: float | None = None) -> dict:
        """The supervisor's ``/mraft/obs`` body: liveness table +
        merged families."""
        return {"roles": self.roles(now),
                "families": self.merged_families(now)}

    def merged_json(self) -> bytes:
        return (json.dumps(self.merged(), sort_keys=True)
                + "\n").encode()


__all__ = ["STALE_AFTER_S", "MetricsAggregator"]
