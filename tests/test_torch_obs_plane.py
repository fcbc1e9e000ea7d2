"""The port's observability plane (``etcd_tpu_torch.obs``: ``timeseries``,
``slo``, ``aggregate``, ``profiler`` with its ``owners`` table) against
the JAX package's, on the CPU.

- The 17 cases of ``tests/test_obs_plane.py`` run against the port (the
  reference module executed with its imports pointed at
  ``etcd_tpu_torch``); its ownership-vocabulary case reads the port's
  owners table where the reference reads ``analysis/ownership.py``.
- The port's profiler resolves the same (file, function) -> domain roots
  as the reference's, which reads the static checker's registry.
- The same seeded sequence of registry operations, with a respawn (a
  fresh registry: every counter steps back) and the clocks of both
  packages' modules replaced by the same fake, gives byte-equal
  ``TimeSeries.snapshot_json()``, SLO verdicts (and the exported burn
  gauges), ``windowed_summary`` rows and ``MetricsAggregator`` merged
  views (with the families' help texts, which the port's catalog words
  without the reference's PR numbers, and the port's one extra, empty
  family left out).
- ``DistServer.start`` starts the process's profiler and ring, as the
  reference's does, and its peer port serves ``/mraft/obs/timeseries``
  and ``/mraft/obs/slo`` in the reference's shape.

Tolerance: exact.
"""

from __future__ import annotations

import functools
import json
import sys
import types
import urllib.request

import numpy as np
import pytest

from etcd_tpu.obs import aggregate as jagg
from etcd_tpu.obs import metrics as jmetrics
from etcd_tpu.obs import profiler as jprof
from etcd_tpu.obs import slo as jslo
from etcd_tpu.obs import timeseries as jts
from etcd_tpu_torch.obs import aggregate as tagg
from etcd_tpu_torch.obs import metrics as tmetrics
from etcd_tpu_torch.obs import owners
from etcd_tpu_torch.obs import profiler as tprof
from etcd_tpu_torch.obs import slo as tslo
from etcd_tpu_torch.obs import timeseries as tts

from test_torch_raft_core import export, port_module


def stats_shape(path: str, body: bytes) -> dict:
    """The run-independent part of a ``/v2/stats/slo`` or
    ``/v2/stats/timeseries`` body: its keys, every declared objective's
    static fields, the ring's step and retention."""
    doc = json.loads(body)
    if path.endswith("slo"):
        assert doc["verdict"] in ("ok", "burning", "no_data")
        return {"keys": sorted(doc), "objectives": {
            name: {"fields": sorted(o),
                   **{k: o[k] for k in ("kind", "family", "target",
                                        "window_s", "doc")}}
            for name, o in doc["objectives"].items()}}
    assert isinstance(doc["steps"], list)
    return {"keys": sorted(doc), "step_s": doc["step_s"],
            "retention": doc["retention"]}


def _owners_as_analysis(test):
    """The reference case imports the static checker's registry
    (``analysis.ownership``, which the port has no counterpart of): it
    reads the port's owners table under that name."""
    @functools.wraps(test)
    def run():
        names = ("etcd_tpu_torch.analysis",
                 "etcd_tpu_torch.analysis.ownership")
        saved = {n: sys.modules.get(n) for n in names}
        pkg = types.ModuleType(names[0])
        pkg.ownership = owners
        sys.modules[names[0]], sys.modules[names[1]] = pkg, owners
        try:
            return test()
        finally:
            for n, m in saved.items():
                if m is None:
                    sys.modules.pop(n, None)
                else:
                    sys.modules[n] = m
    return run


assert export(port_module("test_obs_plane", {
    "test_profiler_domain_roots_speak_ownership_vocabulary":
        _owners_as_analysis}), "obs", globals()) == 17


def test_profiler_domain_roots_equal_the_reference():
    from etcd_tpu.analysis.ownership import DOMAINS

    roots = tprof._domain_roots()
    assert roots == jprof._domain_roots()
    assert set(owners.DOMAINS) == set(DOMAINS)
    for name, dom in DOMAINS.items():
        assert [s for _, s in owners.DOMAINS[name].owners] \
            == [s for _, s in dom.owners], name


# -- the same registry operations through both packages ----------------------


class _Clock:
    """time.monotonic / time.time of a module, advanced by the test."""

    def __init__(self):
        self.mono, self.wall = 1000.0, 1.7e9

    def monotonic(self):
        return self.mono

    def time(self):
        return self.wall

    def advance(self, dt):
        self.mono += dt
        self.wall += dt


def _ops(rng, n_steps):
    """Per step: (op, family, labels, value) registry operations."""
    out = []
    for _ in range(n_steps):
        step = []
        for _ in range(int(rng.integers(5, 40))):
            k = int(rng.integers(6))
            if k == 0:
                step.append(("obs", "etcd_ack_rtt_seconds", {},
                             float(rng.lognormal(-5, 2))))
            elif k == 1:
                step.append(("obs", "etcd_read_rtt_seconds", {},
                             float(rng.lognormal(-6, 2))))
            elif k == 2:
                step.append(("inc", "etcd_admission_total",
                             {"outcome": str(rng.choice(
                                 ["admit", "admit", "admit", "shed"])),
                              "reason": "ok"}, 1.0))
            elif k == 3:
                step.append(("inc", "etcd_read_serve_total",
                             {"path": "lease", "outcome": str(rng.choice(
                                 ["ok"] * 20 + ["fail"]))}, 1.0))
            elif k == 4:
                step.append(("inc", "etcd_wal_append_entries_total", {},
                             float(rng.integers(1, 300))))
            else:
                step.append(("set", "etcd_tenant_inflight",
                             {"tenant": f"t{int(rng.integers(3))}"},
                             float(rng.integers(50))))
        out.append(step)
    return out


def _apply(reg, step):
    for op, fam, labels, v in step:
        if op == "obs":
            reg.histogram(fam, **labels).observe(v)
        elif op == "inc":
            reg.counter(fam, **labels).inc(v)
        else:
            reg.gauge(fam, **labels).set(v)


def _common(blob: bytes) -> bytes:
    """A registry-shaped JSON body without the families' help texts
    (the port's catalog words them without the reference's PR numbers)
    and without the port's own family, which must be empty here;
    re-serialized as the modules serialize."""
    doc = json.loads(blob)
    fams = doc.get("families", doc)
    for name in set(fams) - set(jmetrics.CATALOG):
        assert not fams.pop(name)["samples"], name
    for fam in fams.values():
        fam.pop("help", None)
    return (json.dumps(doc, sort_keys=True) + "\n").encode()


def _drive(mods, monkeypatch, ops, dts, respawn_at):
    """One package's ring, SLO evaluator and aggregator through ``ops``;
    the registry is replaced by a fresh one (a respawned role) at step
    ``respawn_at``.  Returns every view as bytes."""
    metrics, timeseries, slo, agg = mods
    clock = _Clock()
    for m in (timeseries, slo, agg):
        monkeypatch.setattr(m, "time", clock)
    regs = [metrics.Registry(), metrics.Registry()]
    ts = timeseries.TimeSeries(lambda: regs[0].snapshot(light=True))
    a = agg.MetricsAggregator()
    for i, (step, dt) in enumerate(zip(ops, dts)):
        if i == respawn_at:
            regs[0] = metrics.Registry()
        _apply(regs[0], step)
        _apply(regs[1], step[::2])
        clock.advance(dt)
        ts.step_once()
        a.observe("shard0", regs[0].snapshot(light=True))
        if i % 3 != 2:  # the worker misses scrapes: stale marking
            a.observe("worker", regs[1].snapshot())
        else:
            a.scrape_failed("worker")
    gauges = metrics.Registry()
    snap = ts.snapshot()
    verdict = slo.evaluate([snap], registry=gauges)
    merged_ts = timeseries.TimeSeries(a.merged_families)
    merged_ts.step_once()
    return {
        "ring": ts.snapshot_json(),
        "verdict": json.dumps(verdict, sort_keys=True),
        "evaluator": slo.SLOEvaluator(ts).verdict_json(),
        "merged_verdict": json.dumps(slo.merge_verdicts(
            [verdict, slo.evaluate([merged_ts.snapshot()])]),
            sort_keys=True),
        "gauges": _common(gauges.snapshot_json()),
        "summary": json.dumps(timeseries.windowed_summary(
            [snap, merged_ts.snapshot()]), sort_keys=True),
        "rates": json.dumps([ts.rate("etcd_ack_rtt_seconds", w)
                             for w in (3.0, 10.0, 60.0)]),
        "percentiles": json.dumps(
            [ts.percentile("etcd_ack_rtt_seconds", q, w)
             for q in (0.5, 0.99) for w in (5.0, 60.0)]),
        "merged": _common(a.merged_json()),
        "merged_ring": merged_ts.snapshot_json(),
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ring_slo_and_aggregator_equal_the_reference(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    n = 14
    ops = _ops(rng, n)
    dts = [float(x) for x in rng.uniform(0.5, 6.0, n)]
    respawn_at = int(rng.integers(4, n - 2))
    port = _drive((tmetrics, tts, tslo, tagg), monkeypatch, ops, dts,
                  respawn_at)
    ref = _drive((jmetrics, jts, jslo, jagg), monkeypatch, ops, dts,
                 respawn_at)
    for k in ref:
        assert port[k] == ref[k], k
    # the respawn is in the ring as a fresh incarnation's delta
    ring = json.loads(port["ring"])["steps"]
    assert all(d >= 0 for st in ring for *_, d in st["counters"])


# -- DistServer starts the plane ---------------------------------------------


def test_distserver_start_arms_profiler_and_ring(tmp_path, monkeypatch):
    from etcd_tpu_torch.scripts.dist_bench import make_dist_cluster

    monkeypatch.delenv("ETCD_PROFILE_HZ", raising=False)
    monkeypatch.setattr(tprof, "_default", None)
    monkeypatch.setattr(tts, "_default", None)
    servers, ports = make_dist_cluster(tmp_path, m=3, g=4, device="cpu")
    try:
        assert tprof._default is not None and tts._default is not None
        assert tprof._default._thread.is_alive()
        assert tts._default._thread.is_alive()
        for path in ("/mraft/obs/timeseries", "/mraft/obs/slo"):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{ports[0]}{path}", timeout=10) as r:
                assert r.status == 200
                body = r.read()
            ref = (jts.TimeSeries(jmetrics.Registry()).snapshot_json()
                   if path.endswith("timeseries")
                   else jslo.SLOEvaluator(jts.TimeSeries(
                       jmetrics.Registry())).verdict_json())
            assert stats_shape(path, body) == stats_shape(path, ref)
    finally:
        for s in servers:
            s.stop()
