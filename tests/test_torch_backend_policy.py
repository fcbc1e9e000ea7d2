"""The port's replay router (etcd_tpu_torch.wal.backend_policy) against
the JAX package's on the same injected probes: the same route and the
same reason for every case of the reference's tests, the same probe
caching, and a default device probe that runs on the caller's device
(CUDA unless ``device="cpu"``).  Where the reference routes a failed
device probe to the host, the port raises the probe's error."""

import json
import os
import time

import pytest
import torch

from etcd_tpu.wal import backend_policy as jpolicy

from etcd_tpu_torch.obs.metrics import registry
from etcd_tpu_torch.wal import backend_policy
from etcd_tpu_torch.wal.backend_policy import (
    ENV_KNOB,
    ROUTES,
    BackendPolicy,
    get_policy,
    set_policy,
)


def _fast_device():
    return {"h2d_bps": 1e12, "device_verify_bps": 1e12}


def _slow_device():
    return {"h2d_bps": 1e6, "device_verify_bps": 1e6}


def _broken():
    raise RuntimeError("device unreachable")


def _split_host():
    return {"host_scan_bps": 1e9, "host_frame_bps": 4e9}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    monkeypatch.delenv(ENV_KNOB, raising=False)
    yield
    set_policy(None)
    jpolicy.set_policy(None)


CASES = {
    "fast_device": (_split_host, _fast_device, {}),
    "slow_device": (lambda: 1e9, _slow_device, {}),
    "broken_probe": (lambda: 1e9, _broken, {}),
    "no_accelerator": (lambda: 1e9, lambda: None, {}),
    "small_stream": (_split_host, _fast_device, {"size_bytes": 1 << 20}),
    "large_stream": (_split_host, _fast_device, {"size_bytes": 1 << 30}),
    "large_stream_slow_device": (lambda: 1e9, _slow_device,
                                 {"size_bytes": 1 << 30}),
    "slow_host_frame": ({"host_scan_bps": 3e9, "host_frame_bps": 2e9}
                        .copy, _fast_device, {}),
}


@pytest.mark.parametrize("env", [None, "stream", "host", "device",
                                 "warp-drive"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_route_matches_reference(monkeypatch, case, env):
    if env is not None:
        monkeypatch.setenv(ENV_KNOB, env)
    host, dev, kw = CASES[case]
    mine = BackendPolicy(probe_host=host, probe_device=dev)
    ref = jpolicy.BackendPolicy(probe_host=host, probe_device=dev)
    if dev is _broken:
        # the reference routes to the host; the port raises wherever
        # the decision needs the probe
        assert ref.route("replay", **kw) == "host" or env in ROUTES
        if env in ROUTES:
            assert mine.route("replay", **kw) == env
        with pytest.raises(RuntimeError, match="device unreachable"):
            mine.route("replay", **kw)
            mine.probe()
        return
    assert mine.route("replay", **kw) == ref.route("replay", **kw)
    assert mine.decisions == ref.decisions
    for key in ("host_scan_bps", "host_frame_bps", "h2d_bps",
                "device_verify_bps"):
        assert mine.probe().get(key) == ref.probe().get(key), key


def test_slow_device_selects_host():
    p = BackendPolicy(probe_host=lambda: 1e9, probe_device=_slow_device)
    assert p.route("restart") == "host"
    assert "<= host" in p.decisions["restart"]["why"]


def test_probe_failure_falls_back_to_host():
    """It does not: a device probe that fails raises out of the router,
    every time it is asked, and the host route is never chosen for it."""
    p = BackendPolicy(probe_host=lambda: 1e9, probe_device=_broken)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="device unreachable"):
            p.route("replay")
    assert p.decisions == {}
    assert p.route("replay", size_bytes=1 << 20) == "host"


def test_probe_runs_once_in_process():
    calls = []
    p = BackendPolicy(probe_host=lambda: calls.append(1) or 1e9,
                      probe_device=lambda: None)
    for stage in ("replay", "restart", "e2e"):
        p.route(stage)
    assert calls == [1]


def test_probe_cache_reused_across_restarts(tmp_path):
    cache = str(tmp_path / "probe.json")
    calls = []

    def host():
        calls.append(1)
        return 123456789.0

    BackendPolicy(cache_path=cache, probe_host=host,
                  probe_device=lambda: None).route("restart")
    assert calls == [1] and os.path.exists(cache)
    second = BackendPolicy(cache_path=cache, probe_host=host,
                           probe_device=lambda: None)
    assert second.route("restart") == "host"
    assert calls == [1]
    assert second.probe()["source"] == "cache"
    assert second.probe()["host_scan_bps"] == 123456789.0


def test_corrupt_and_stale_caches_reprobe(tmp_path):
    cache = tmp_path / "probe.json"
    cache.write_text("{not json")
    p = BackendPolicy(cache_path=str(cache), probe_host=lambda: 1e9,
                      probe_device=lambda: None)
    assert p.route("replay") == "host"
    assert p.probe()["source"] == "probe"
    assert json.loads(cache.read_text())["probe"]["host_scan_bps"] == 1e9
    cache.write_text(json.dumps({"version": 1, "probe": {
        "source": "probe", "ts_epoch": time.time() - 48 * 3600,
        "host_scan_bps": 1.0, "host_frame_bps": 1.0,
        "h2d_bps": None, "device_verify_bps": None}}))
    calls = []
    p = BackendPolicy(cache_path=str(cache),
                      probe_host=lambda: calls.append(1) or 1e9,
                      probe_device=lambda: None)
    p.route("replay")
    assert calls == [1] and p.probe()["source"] == "probe"


def test_errored_probe_never_persisted(tmp_path):
    cache = str(tmp_path / "p.json")
    for host, dev in ((lambda: 1e9, _broken), (_broken, _fast_device)):
        p = BackendPolicy(cache_path=cache, probe_host=host,
                          probe_device=dev)
        with pytest.raises(RuntimeError, match="device unreachable"):
            p.route("replay")
        assert not os.path.exists(cache)


def test_decisions_in_the_registry_and_snapshot():
    p = BackendPolicy(probe_host=_split_host, probe_device=_fast_device,
                      chunk_bytes=1 << 20)
    assert p.route("restart", size_bytes=1 << 30) == "stream"
    p.note("restart", "host", "stream lane failed; host repair path")
    assert p.decisions["restart"]["route"] == "host"
    assert p.decisions["restart"]["size_bytes"] == 1 << 30
    gauge = registry.gauge
    assert gauge("etcd_replay_backend_route", stage="restart",
                 route="stream").get() == 0.0
    assert gauge("etcd_replay_backend_route", stage="restart",
                 route="host").get() == 1.0
    assert gauge("etcd_replay_stream_chunk_bytes").get() == 1 << 20
    assert gauge("etcd_replay_probe_bytes_per_sec",
                 leg="device_verify").get() == 1e12
    snap = p.snapshot()
    assert snap["chunk_bytes"] == 1 << 20
    assert snap["probe"]["device_verify_bps"] == 1e12


def test_small_stream_routes_host_without_probing():
    calls = []
    p = BackendPolicy(probe_host=_split_host,
                      probe_device=lambda: calls.append(1) or _fast_device())
    assert p.route("restart", size_bytes=1 << 20) == "host"
    assert calls == [] and "device threshold" in \
        p.decisions["restart"]["why"]
    assert p.route("restart", size_bytes=1 << 30) == "stream"
    assert calls == [1]


def test_get_policy_is_a_singleton():
    set_policy(None)
    assert get_policy() is get_policy()


def test_default_device_probe_needs_cuda_unless_asked_for_the_cpu():
    p = BackendPolicy()
    if torch.cuda.is_available():
        assert p.route("replay", size_bytes=1 << 30) in ("host", "stream")
        assert p.probe()["device_verify_bps"] > 0
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        p.route("replay", size_bytes=1 << 30)
    assert p.decisions == {} and p.snapshot().get("probe") is None
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        backend_policy._probe_device_default()


def test_cpu_device_probe_measures_the_plain_version():
    p = BackendPolicy()
    assert p.route("replay", size_bytes=1 << 30, device="cpu") in (
        "host", "stream")
    probe = p.probe()
    assert probe["host_scan_bps"] > 0 and probe["host_frame_bps"] > 0
    assert probe["device_verify_bps"] > 0
