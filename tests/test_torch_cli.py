"""``python -m etcd_tpu_torch.cli``, by subprocess: the co-hosted server
on the CPU (``ETCD_TORCH_DEVICE=cpu``) serves a PUT and a GET over HTTP
and restarts from its data dir; three ``--dist-slot`` processes serve a
3-host cluster; without CUDA and without that variable it exits non-zero
naming CUDA; the modes not ported yet exit 2 (the front door by
subprocess, also with a mesh flag beside it, the others, ``--dist-roles``
among them, also beside ``--dist-mesh-devices``, through ``main``).  The
mesh flags themselves are tested in tests/test_torch_mesh_servers.py."""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

from etcd_tpu_torch import cli

REPO = Path(__file__).resolve().parents[1]


def _env(**extra):
    env = dict(os.environ)
    env.pop("ETCD_TORCH_DEVICE", None)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"  # tiny tensors: no thread pool needed
    env.update(extra)
    return env


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _cli(args, env, **kw):
    return subprocess.run([sys.executable, "-m", "etcd_tpu_torch.cli",
                           *args], env=env, capture_output=True, text=True,
                          cwd=REPO, timeout=120, **kw)


def _wait_port(port: int, proc, deadline_s: float = 60.0) -> None:
    t0 = time.time()
    while time.time() - t0 < deadline_s:
        assert proc.poll() is None, proc.communicate()[1][-2000:]
        try:
            socket.create_connection(("127.0.0.1", port), 0.2).close()
            return
        except OSError:
            time.sleep(0.05)
    raise AssertionError("the CLI never listened")


def _serve(tmp_path, port, *extra):
    url = f"http://127.0.0.1:{port}"
    return subprocess.Popen(
        [sys.executable, "-m", "etcd_tpu_torch.cli",
         "--cohosted-groups", "8", "--cohosted-members", "3",
         "--data-dir", str(tmp_path / "data"),
         "--listen-client-urls", url, "--advertise-client-urls", url,
         *extra],
        env=_env(ETCD_TORCH_DEVICE="cpu"), cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)


def _stop(proc) -> None:
    proc.kill()
    proc.wait(timeout=30)


def test_cli_serves_put_and_get_on_the_cpu(tmp_path):
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    proc = _serve(tmp_path, port, "--frontdoor", "off")
    try:
        _wait_port(port, proc)
        req = urllib.request.Request(f"{base}/v2/keys/app/k",
                                     data=b"value=hello", method="PUT")
        req.add_header("Content-Type", "application/x-www-form-urlencoded")
        with urllib.request.urlopen(req, timeout=60) as r:
            assert json.loads(r.read())["action"] == "set"
        with urllib.request.urlopen(f"{base}/v2/keys/app/k",
                                    timeout=60) as r:
            assert json.loads(r.read())["node"]["value"] == "hello"
        with urllib.request.urlopen(f"{base}/v2/machines", timeout=60) as r:
            assert base in r.read().decode()
    finally:
        _stop(proc)
    # restart on the same dir with the tpu backend: the key reads back
    proc = _serve(tmp_path, port, "--storage-backend", "tpu")
    try:
        _wait_port(port, proc)
        with urllib.request.urlopen(f"{base}/v2/keys/app/k",
                                    timeout=60) as r:
            assert json.loads(r.read())["node"]["value"] == "hello"
    finally:
        _stop(proc)


def test_cli_without_cuda_exits_naming_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    r = _cli(["--cohosted-groups", "4", "--data-dir",
              str(tmp_path / "d")], _env())
    assert r.returncode != 0
    assert "CUDA" in r.stderr


@pytest.mark.parametrize("args", [
    ["--cohosted-groups", "4", "--frontdoor", "on"],
    ["--cohosted-groups", "4", "--cohosted-mesh-devices", "2",
     "--frontdoor", "on"],
])
def test_cli_front_door_and_mesh_exit_2(tmp_path, args):
    r = _cli([*args, "--data-dir", str(tmp_path / "d")],
             _env(ETCD_TORCH_DEVICE="cpu"))
    assert r.returncode == 2, r.stderr
    assert "not ported yet" in r.stderr


@pytest.mark.parametrize("args", [
    ["--cohosted-groups", "4", "--dist-slot", "0", "--dist-roles", "2",
     "--dist-peers", "http://127.0.0.1:1,http://127.0.0.1:2"],
    ["--proxy", "on"],
    [],
    ["--cohosted-groups", "4", "--dist-slot", "0", "--dist-roles", "2",
     "--dist-mesh-devices", "2",
     "--dist-peers", "http://127.0.0.1:1,http://127.0.0.1:2"],
])
def test_cli_other_modes_not_ported_exit_2(tmp_path, args, capsys,
                                           monkeypatch):
    monkeypatch.setenv("ETCD_TORCH_DEVICE", "cpu")
    assert cli.main([*args, "--data-dir", str(tmp_path / "d")]) == 2
    assert "not ported yet" in capsys.readouterr().err
    assert not (tmp_path / "d").exists()


def test_cli_dist_slot_serves_a_three_host_cluster(tmp_path):
    """Three ``--dist-slot`` processes: a PUT through slot 0's client
    URL (slot 0 bootstraps leadership of a fresh cluster) reads back
    through every host's."""
    peers = [f"http://127.0.0.1:{_free_port()}" for _ in range(3)]
    clients = [_free_port() for _ in range(3)]
    procs = []
    try:
        for s in range(3):
            url = f"http://127.0.0.1:{clients[s]}"
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "etcd_tpu_torch.cli",
                 "--dist-slot", str(s), "--dist-peers", ",".join(peers),
                 "--cohosted-groups", "4",
                 "--data-dir", str(tmp_path / f"d{s}"),
                 "--listen-client-urls", url,
                 "--advertise-client-urls", url],
                env=_env(ETCD_TORCH_DEVICE="cpu"), cwd=REPO,
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                text=True))
        for s in range(3):
            _wait_port(clients[s], procs[s])
        base = f"http://127.0.0.1:{clients[0]}"
        deadline = time.time() + 60
        while True:  # slot 0's bootstrap campaign may still be running
            req = urllib.request.Request(f"{base}/v2/keys/app/k",
                                         data=b"value=dist", method="PUT")
            req.add_header("Content-Type",
                           "application/x-www-form-urlencoded")
            try:
                with urllib.request.urlopen(req, timeout=30) as r:
                    assert json.loads(r.read())["action"] == "set"
                break
            except urllib.error.HTTPError:
                assert time.time() < deadline, "no leader took the PUT"
                time.sleep(0.5)
        for s in range(3):
            url = (f"http://127.0.0.1:{clients[s]}/v2/keys/app/k"
                   "?serializable=true")
            while True:
                try:
                    with urllib.request.urlopen(url, timeout=30) as r:
                        assert json.loads(r.read())["node"]["value"] \
                            == "dist"
                    break
                except urllib.error.HTTPError:
                    assert time.time() < deadline, f"slot {s} never read"
                    time.sleep(0.2)
    finally:
        for p in procs:
            _stop(p)
