"""The port's servers and CLI on a device mesh (the CPU's 8 virtual
devices, ``parallel.mesh.VIRTUAL_CPU_DEVICES``).

The three mesh tests of the reference (tests/test_multigroup.py
``test_mesh_sharded_multigroup_serves_and_restarts`` and
``test_membership_change_preserves_mesh_sharding``, tests/test_distserver.py
``test_mesh_sharded_dist_cluster``) on the port's servers, with the
engine's blocks on the mesh's devices after serving, restart and conf
changes.  ``--cohosted-mesh-devices`` and ``--dist-mesh-devices`` by
subprocess (``ETCD_TORCH_DEVICE=cpu``): a valid mesh serves, and an
oversized, negative or non-dividing count exits 1 with the reference's
message (taken from ``etcd_tpu.cli._local_mesh``).  Last, the config-5
phases ``chip_smoke.py`` drives (``scripts/config5_bench.py``) at a small
size.  Tolerance: exact.
"""

import json
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from etcd_tpu import cli as jcli

from etcd_tpu_torch.parallel import group_mesh, local_devices
from etcd_tpu_torch.scripts import cohosted_bench as cb
from etcd_tpu_torch.scripts import config5_bench as c5
from etcd_tpu_torch.scripts import dist_bench
from etcd_tpu_torch.server.multigroup import MultiGroupServer
from etcd_tpu_torch.utils.errors import EtcdError
from etcd_tpu_torch.wire.requests import Request

import test_torch_cli as cli_cases

G, M, CAP = 8, 3, 64
MESH = group_mesh(devices=local_devices("cpu"))  # (4, 2), as group_mesh()


def _mk(tmp_path, **kw):
    kw.setdefault("g", G)
    kw.setdefault("m", M)
    kw.setdefault("cap", CAP)
    kw.setdefault("tick_interval", 0.02)
    return MultiGroupServer(str(tmp_path / "data"), device="cpu", **kw)


def _put(s, path, val, timeout=60):
    return s.do(Request(id=np.random.randint(1, 2**62), method="PUT",
                        path=path, val=val), timeout=timeout)


def _get(s, path, **kw):
    return s.do(Request(id=np.random.randint(1, 2**62), method="GET",
                        path=path, **kw))


def _assert_on_mesh(engine, mesh, g=G) -> None:
    """The engine's state is split into the mesh's g-blocks, block i on
    ``mesh.devices[i][0]``."""
    devs = [row[0] for row in mesh.devices]
    assert list(engine._lay.devices) == devs
    blocks = engine._blocks
    assert len(blocks) == mesh.shape["g"]
    for blk, dev in zip(blocks, devs):
        for st in (blk if isinstance(blk, list) else [blk]):
            assert st.term.shape == (g // mesh.shape["g"],)
            assert st.term.device == dev and st.members.device == dev


def test_mesh_sharded_multigroup_serves_and_restarts(tmp_path):
    s = _mk(tmp_path, mesh=MESH)
    s.start()
    try:
        assert _put(s, "/ns1/k", "v1").event.node.value == "v1"
        _assert_on_mesh(s.mr, MESH)
    finally:
        s.stop()
    s2 = _mk(tmp_path, mesh=MESH)
    s2.start()
    try:
        assert _get(s2, "/ns1/k").event.node.value == "v1"
        _assert_on_mesh(s2.mr, MESH)
        assert _put(s2, "/ns1/k2", "v2").event.node.value == "v2"
    finally:
        s2.stop()


def test_multigroup_mesh_guard_before_disk(tmp_path):
    with pytest.raises(ValueError, match="g=6 not divisible by mesh "
                       "g-axis 4"):
        _mk(tmp_path, g=6, mesh=MESH)
    assert not (tmp_path / "data").exists()


def test_membership_change_preserves_mesh_sharding(tmp_path):
    s = _mk(tmp_path, spare_member_slots=1, mesh=MESH)
    s.start()
    try:
        _put(s, "/mm/a", "1")
        assert all(s.members_of(gi).sum() == 3 for gi in range(G))
        s.add_member(3)
        assert all(s.members_of(gi).sum() == 4 for gi in range(G))
        _put(s, "/mm/b", "2")  # serving continues at 4 members
        _assert_on_mesh(s.mr, MESH)
        s.remove_member(3)
        assert all(s.members_of(gi).sum() == 3 for gi in range(G))
        _put(s, "/mm/c", "3")
        _assert_on_mesh(s.mr, MESH)
    finally:
        s.stop()


def _wait_for(pred, timeout=30.0, msg="condition"):
    t0 = time.time()
    while time.time() - t0 < timeout:
        try:
            if pred():
                return
        except (EtcdError, TimeoutError):
            pass
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


def test_mesh_sharded_dist_cluster(tmp_path):
    servers, _ = dist_bench.make_dist_cluster(tmp_path, m=3, g=G,
                                              mesh=MESH, device="cpu")
    try:
        dist_bench.bootstrap_dist_leader(servers)
        _assert_on_mesh(servers[0].mr, MESH)
        ev = servers[0].do(Request(method="PUT", id=1 << 40, path="/m",
                                   val="sharded"), timeout=15.0)
        assert ev.event.node.value == "sharded"
        _wait_for(lambda: all(
            _get(s, "/m", serializable=True).event.node.value == "sharded"
            for s in servers[1:]), msg="replication with sharded state")
        for s in servers:
            _assert_on_mesh(s.mr, MESH)
    finally:
        for s in servers:
            try:
                s.stop()
            except Exception:
                pass


# -- the CLI flags ------------------------------------------------------------

def _ref_message(n: int, groups: int) -> str:
    with pytest.raises(ValueError) as e:
        jcli._local_mesh(n, groups)
    return str(e.value)


@pytest.mark.parametrize("flag,n,groups", [
    ("--cohosted-mesh-devices", 9, 8),
    ("--cohosted-mesh-devices", -1, 8),
    ("--cohosted-mesh-devices", 8, 6),
    ("--dist-mesh-devices", 9, 8),
    ("--dist-mesh-devices", -2, 8),
    ("--dist-mesh-devices", 4, 5),
])
def test_cli_mesh_flag_errors_exit_1(tmp_path, flag, n, groups):
    args = ["--cohosted-groups", str(groups), flag, str(n),
            "--data-dir", str(tmp_path / "d")]
    if flag == "--dist-mesh-devices":
        args += ["--dist-slot", "0", "--dist-peers",
                 "http://127.0.0.1:1,http://127.0.0.1:2"]
    r = cli_cases._cli(args, cli_cases._env(ETCD_TORCH_DEVICE="cpu"))
    assert r.returncode == 1, r.stderr
    assert f"{flag}: {_ref_message(n, groups)}" in r.stderr


def test_cli_cohosted_mesh_serves(tmp_path):
    port = cli_cases._free_port()
    base = f"http://127.0.0.1:{port}"
    proc = cli_cases._serve(tmp_path, port, "--cohosted-mesh-devices", "8")
    try:
        cli_cases._wait_port(port, proc)
        req = urllib.request.Request(f"{base}/v2/keys/app/k",
                                     data=b"value=mesh", method="PUT")
        req.add_header("Content-Type", "application/x-www-form-urlencoded")
        with urllib.request.urlopen(req, timeout=60) as r:
            assert json.loads(r.read())["action"] == "set"
        with urllib.request.urlopen(f"{base}/v2/keys/app/k",
                                    timeout=60) as r:
            assert json.loads(r.read())["node"]["value"] == "mesh"
    finally:
        cli_cases._stop(proc)


def test_cli_dist_mesh_serves(tmp_path):
    """Three ``--dist-slot`` processes, each with its 8 groups split over
    2 virtual devices: a PUT through slot 0 reads back through slot 2."""
    peers = [f"http://127.0.0.1:{cli_cases._free_port()}" for _ in range(3)]
    clients = [cli_cases._free_port() for _ in range(3)]
    procs = []
    try:
        for s in range(3):
            url = f"http://127.0.0.1:{clients[s]}"
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "etcd_tpu_torch.cli",
                 "--dist-slot", str(s), "--dist-peers", ",".join(peers),
                 "--cohosted-groups", "8", "--dist-mesh-devices", "2",
                 "--data-dir", str(tmp_path / f"d{s}"),
                 "--listen-client-urls", url,
                 "--advertise-client-urls", url],
                env=cli_cases._env(ETCD_TORCH_DEVICE="cpu"),
                cwd=cli_cases.REPO, stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE, text=True))
        for s in range(3):
            cli_cases._wait_port(clients[s], procs[s])
        base = f"http://127.0.0.1:{clients[0]}"
        deadline = time.time() + 60
        while True:  # slot 0's bootstrap campaign may still be running
            req = urllib.request.Request(f"{base}/v2/keys/app/k",
                                         data=b"value=dm", method="PUT")
            req.add_header("Content-Type",
                           "application/x-www-form-urlencoded")
            try:
                with urllib.request.urlopen(req, timeout=30) as r:
                    assert json.loads(r.read())["action"] == "set"
                break
            except urllib.error.HTTPError:
                assert time.time() < deadline, "no leader took the PUT"
                time.sleep(0.5)
        url = (f"http://127.0.0.1:{clients[2]}/v2/keys/app/k"
               "?serializable=true")
        deadline = time.time() + 30
        while True:
            try:
                with urllib.request.urlopen(url, timeout=30) as r:
                    if json.loads(r.read())["node"]["value"] == "dm":
                        break
            except urllib.error.HTTPError:
                pass
            assert time.time() < deadline, "slot 2 never read the key"
            time.sleep(0.2)
    finally:
        for p in procs:
            cli_cases._stop(p)


# -- the config-5 phases of chip_smoke.py, small ---------------------------

def test_config5_main_keys_and_serving_equal_unsharded():
    out = c5.main(groups=64, iters=2, n_devices=8, device="cpu")
    sv = out.pop("serving")
    for k in ("groups", "members", "mesh", "backend", "step_ms",
              "group_commits_per_sec", "serving_sharded_round_ms",
              "serving_sharded_commits_per_sec"):
        assert k in out, k
    assert out["groups"] == 64 and out["backend"] == "virtual-cpu-mesh/1"
    assert out["mesh"].startswith("4x2 (8 virtual shards")
    assert sv["blocks"] == 4 and sv["profile"] is None
    one = c5.serving(64, None, trains=2, device="cpu")
    assert cb.same_states(sv, one) == []
    assert sv["reads_per_round"] == one["reads_per_round"] == 0.75


def test_config5_served_restarts_sharded():
    got = c5.served(16, c5.virtual_mesh(2, "cpu"), puts=24, threads=4)
    assert got["blocks"] == 2 and got["read_back"] == 24
    assert got["restart_launches"] == 0  # the CPU runs the plain version


def test_config5_dist_engine_equal():
    got = c5.dist_engine(16, c5.virtual_mesh(2, "cpu"), rounds=3)
    assert got["blocks"] == 2 and got["calls"] > 40
    assert got["reads"]["sharded"] == got["reads"]["unsharded"] > 0
