"""The port under the model-based soak, and the port's soak and device
probe scripts, on the CPU.

- The 5 scenarios of ``tests/test_model_soak.py`` (random op sequences
  against a real server and a flat-dict model, compared after apply and
  after a restart: the classic server under two seeds, the co-hosted
  ``MultiGroupServer``, a 3-host ``DistServer`` cluster, a torn WAL tail
  and an in-process classic cluster of 3) run against the port, every
  server with ``device="cpu"``: the reference module executed with its
  imports pointed at ``etcd_tpu_torch``, the servers and cluster
  helpers it imports inside its tests pointed at the port's.
- ``python -m etcd_tpu_torch.scripts.soak`` at a few seconds, 8 groups
  and a snapshot count of 50 exits 0 with every gate live (the RSS gate
  past a 2 s warm-up, the disk bounds after its snapshots), and its
  gates count: an op error fails it.
- ``python -m etcd_tpu_torch.scripts.device_probe`` on a host without
  CUDA prints ``error`` and exits 1.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import conftest
import etcd_tpu_torch.server.multigroup as tmultigroup
from etcd_tpu_torch.scripts import dist_bench
from etcd_tpu_torch.scripts import soak

from test_torch_raft_core import export, port_module

REPO = Path(__file__).resolve().parents[1]

_cpu = {"new_server": lambda f: functools.partial(f, device="cpu")}
_port_test_server = port_module("test_server", _cpu)

assert export(port_module("test_model_soak", _cpu), "soak", globals()) == 5


class _CpuMultiGroupServer(tmultigroup.MultiGroupServer):
    def __init__(self, *a, **kw):
        kw.setdefault("device", "cpu")
        super().__init__(*a, **kw)


@pytest.fixture(autouse=True)
def _port_servers_on_the_cpu(monkeypatch):
    """What the reference scenarios import inside their bodies — the
    co-hosted server, the dist cluster helpers of ``conftest`` and
    ``test_server``'s classic cluster — is the port's, on the CPU."""
    monkeypatch.setattr(tmultigroup, "MultiGroupServer",
                        _CpuMultiGroupServer)
    monkeypatch.setattr(conftest, "make_dist_cluster", functools.partial(
        dist_bench.make_dist_cluster, device="cpu"))
    monkeypatch.setattr(conftest, "bootstrap_dist_leader",
                        dist_bench.bootstrap_dist_leader)
    monkeypatch.setitem(sys.modules, "test_server", _port_test_server)


def _env() -> dict:
    env = dict(os.environ)
    env.pop("ETCD_TORCH_DEVICE", None)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _summary(stdout: str) -> dict:
    return json.loads([x for x in stdout.splitlines()
                       if x.startswith('{"minutes"')][-1])


def test_soak_script_passes_its_gates_on_the_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "etcd_tpu_torch.scripts.soak", "0.08", "8",
         "50", "--device", "cpu", "--warmup-s", "2", "--report-s", "1"],
        env=_env(), cwd=REPO, capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    s = _summary(r.stdout)
    assert s["clean"] and s["errors"] == 0 and s["device"] == "cpu"
    assert s["rss_gated"] and not s["rss_doubled"]
    assert s["snapshots_taken"] and s["disk_bounded"]
    assert s["watch_fired"] > 0 and s["ops"] > 100


def test_soak_script_fails_on_op_errors(monkeypatch, capsys):
    """An op error is a failed soak, whatever the other gates say."""
    real = tmultigroup.MultiGroupServer.do

    def flaky(self, r, *a, **kw):
        if r.method == "DELETE":
            raise RuntimeError("injected")
        return real(self, r, *a, **kw)

    monkeypatch.setattr(_CpuMultiGroupServer, "do", flaky)
    assert soak.main(["0.02", "4", "50", "--device", "cpu"]) == 1
    s = _summary(capsys.readouterr().out)
    assert s["errors"] > 0 and not s["clean"]


def test_device_probe_without_cuda_fails():
    r = subprocess.run(
        [sys.executable, "-m", "etcd_tpu_torch.scripts.device_probe", "60"],
        env=_env(), cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 1
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["outcome"] == "error" and out["count"] == 0
