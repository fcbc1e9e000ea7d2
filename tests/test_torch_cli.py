"""``python -m etcd_tpu_torch.cli``, by subprocess, on the CPU
(``ETCD_TORCH_DEVICE=cpu``): the co-hosted server serves a PUT and a GET
over HTTP and restarts from its data dir; three ``--dist-slot``
processes serve a 3-host cluster; both answer through the front door by
default (``/v2/stats/frontdoor``), also with a mesh flag beside
``--frontdoor on``; three classic single-group processes started with
the reference's defaults (no mode flag) replicate a PUT to every member;
a classic cluster of two JAX-package processes and one port process
replicates over /raft; ``--proxy on`` and ``--proxy readonly`` pass or
refuse writes; ``--discovery`` bootstraps a classic member from a
registry served by a port server, and a proxy finds its endpoints
there; with default flags the CLI's client listener is the front door,
not the threaded server.  Without CUDA and without that variable it
exits non-zero naming CUDA; ``--dist-roles 2`` serves a 2-host
role-split cluster (a PUT through one host's ingest reads back through
both, the stats routes answer), also beside ``--dist-mesh-devices``,
which the role mode ignores as the reference's does.  The mesh flags
themselves are tested in tests/test_torch_mesh_servers.py."""

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
        _assert_front_door(base)  # the default listener
    finally:
        _stop(proc)


def test_cli_without_cuda_exits_naming_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    r = _cli(["--cohosted-groups", "4", "--data-dir",
              str(tmp_path / "d")], _env())
    assert r.returncode != 0
    assert "CUDA" in r.stderr


def _get(url: str, timeout: float = 60):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, dict(r.headers), r.read()


def _put(base: str, key: str, value: str, timeout: float = 60):
    req = urllib.request.Request(f"{base}/v2/keys/{key}",
                                 data=f"value={value}".encode(),
                                 method="PUT")
    req.add_header("Content-Type", "application/x-www-form-urlencoded")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _assert_front_door(base: str) -> None:
    """The listener is the front door: only it serves
    /v2/stats/frontdoor."""
    st, _, body = _get(f"{base}/v2/stats/frontdoor")
    assert st == 200 and "admission" in json.loads(body)


@pytest.mark.parametrize("args", [
    ["--cohosted-groups", "4", "--frontdoor", "on"],
    ["--cohosted-groups", "4", "--cohosted-mesh-devices", "2",
     "--frontdoor", "on"],
])
def test_cli_front_door_and_mesh_exit_2(tmp_path, args):
    """``--frontdoor on`` (once not ported, exiting 2) now serves the
    co-hosted tier through the front door, also beside a mesh flag."""
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    proc = subprocess.Popen(
        [sys.executable, "-m", "etcd_tpu_torch.cli", *args,
         "--data-dir", str(tmp_path / "d"),
         "--listen-client-urls", base, "--advertise-client-urls", base],
        env=_env(ETCD_TORCH_DEVICE="cpu"), cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        _wait_port(port, proc)
        assert _put(base, "app/k", "fd")[0] == 201
        assert json.loads(_get(f"{base}/v2/keys/app/k")[2])["node"][
            "value"] == "fd"
        _assert_front_door(base)
    finally:
        _stop(proc)


def _classic(tmp_path, names, idx: int, peer_ports, client_ports, *extra,
             module="etcd_tpu_torch.cli", env=None):
    """One classic member process of ``names`` with the reference's
    defaults: only the name, the cluster, the URLs and the data dir."""
    ic = ",".join(f"{n}=http://127.0.0.1:{p}"
                  for n, p in zip(names, peer_ports))
    peer = f"http://127.0.0.1:{peer_ports[idx]}"
    client = f"http://127.0.0.1:{client_ports[idx]}"
    return subprocess.Popen(
        [sys.executable, "-m", module, "--name", names[idx],
         "--initial-cluster", ic, "--data-dir",
         str(tmp_path / names[idx]),
         "--listen-peer-urls", peer, "--advertise-peer-urls", peer,
         "--listen-client-urls", client, "--advertise-client-urls", client,
         *extra],
        env=env or _env(ETCD_TORCH_DEVICE="cpu"), cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)


def _put_until_acked(base: str, key: str, value: str,
                     deadline_s: float = 60.0) -> None:
    deadline = time.time() + deadline_s
    while True:  # the first election may still be running
        try:
            if _put(base, key, value, timeout=10)[0] in (200, 201):
                return
        except (OSError, urllib.error.URLError):
            pass
        assert time.time() < deadline, f"{key} never acked"
        time.sleep(0.3)


def _read_until(base: str, key: str, value: str,
                deadline_s: float = 60.0) -> None:
    deadline = time.time() + deadline_s
    while True:
        try:
            st, _, body = _get(f"{base}/v2/keys/{key}", timeout=10)
            if json.loads(body)["node"]["value"] == value:
                return
        except urllib.error.HTTPError:
            pass
        assert time.time() < deadline, f"{base} never read {key}"
        time.sleep(0.2)


def _roles_serve(tmp_path, args) -> None:
    from etcd_tpu_torch.scripts.dist_bench import free_port_block

    peer_base, client_base = free_port_block(4), free_port_block(6)
    peers = ",".join(f"http://127.0.0.1:{peer_base + i}" for i in (0, 1))
    procs = []
    try:
        for slot in (0, 1):
            argv = list(args)
            argv[argv.index("--dist-slot") + 1] = str(slot)
            argv[argv.index("--dist-peers") + 1] = peers
            url = f"http://127.0.0.1:{client_base + slot}"
            # the role family logs to a file: a pipe nobody reads would
            # fill and stall every role that writes to it
            with open(tmp_path / f"host{slot}.log", "wb") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "etcd_tpu_torch.cli", *argv,
                     "--data-dir", str(tmp_path / f"d{slot}"),
                     "--listen-client-urls", url,
                     "--advertise-client-urls", url],
                    env=_env(ETCD_TORCH_DEVICE="cpu"), cwd=REPO,
                    stdout=subprocess.DEVNULL, stderr=log))
        for slot, proc in enumerate(procs):  # each host's ingest
            deadline = time.time() + 180.0
            while True:
                assert proc.poll() is None, \
                    (tmp_path / f"host{slot}.log").read_text()[-2000:]
                try:
                    socket.create_connection(
                        ("127.0.0.1", client_base + slot), 0.2).close()
                    break
                except OSError:
                    assert time.time() < deadline, "no ingest listened"
                    time.sleep(0.1)
        bases = [f"http://127.0.0.1:{client_base + i}" for i in (0, 1)]
        _put_until_acked(bases[0], "app/k", "roles")
        for b in bases:
            _read_until(b, "app/k", "roles")
            for route in ("slo", "timeseries"):
                st, _, body = _get(f"{b}/v2/stats/{route}", timeout=10)
                assert st == 200 and json.loads(body)
        roles = json.loads((tmp_path / "d0" / "roles.json").read_text())
        assert set(roles) == {"ingest", "worker", "shard0", "shard1",
                              "supervisor"}
    finally:
        for p in procs:
            p.terminate()  # the supervisor stops its roles, frees rings
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=30)


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
    """Every mode once exiting 2 here now serves: ``--dist-roles 2``
    (on two hosts: the peer URLs of ``args`` swapped for free ones) takes
    a PUT through host 0's ingest that reads back through both hosts'
    ingests; a proxy over a classic member passes a PUT; and the classic
    member started with only ``--data-dir`` beside its URLs answers
    through the front door."""
    monkeypatch.setenv("ETCD_TORCH_DEVICE", "cpu")
    if "--dist-roles" in args:
        _roles_serve(tmp_path, args)
        return
    peer, client, proxy_port = _free_port(), _free_port(), _free_port()
    member = _classic(tmp_path, ["d"], 0, [peer], [client])
    procs = [member]
    try:
        _wait_port(client, member)
        base = f"http://127.0.0.1:{client}"
        if args:  # the proxy, over the member's client URL
            url = f"http://127.0.0.1:{proxy_port}"
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "etcd_tpu_torch.cli", *args,
                 "--initial-cluster", f"d={base}",
                 "--listen-client-urls", url],
                env=_env(), cwd=REPO, stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE, text=True))
            _wait_port(proxy_port, procs[-1])
            base = url
        _put_until_acked(base, "app/k", "classic")
        _read_until(base, "app/k", "classic")
        if not args:
            _assert_front_door(base)
    finally:
        for p in procs:
            _stop(p)


def test_cli_classic_three_members_with_default_flags(tmp_path):
    """The reference's default process, three times: no mode flag, no
    --frontdoor, no --storage-backend.  A PUT through one member reads
    back from all three, each answering through the front door; a
    member killed and restarted with ``--storage-backend tpu`` replays
    its WAL and reads the key back."""
    names = ["n0", "n1", "n2"]
    peers = [_free_port() for _ in names]
    clients = [_free_port() for _ in names]
    procs = [_classic(tmp_path, names, i, peers, clients)
             for i in range(3)]
    try:
        for i in range(3):
            _wait_port(clients[i], procs[i])
        bases = [f"http://127.0.0.1:{c}" for c in clients]
        _put_until_acked(bases[1], "app/k", "three")
        for b in bases:
            _read_until(b, "app/k", "three")
            _assert_front_door(b)
        _stop(procs[2])
        _put_until_acked(bases[0], "app/k2", "after")
        procs[2] = _classic(tmp_path, names, 2, peers, clients,
                            "--storage-backend", "tpu")
        _wait_port(clients[2], procs[2])
        _read_until(bases[2], "app/k", "three")
        _read_until(bases[2], "app/k2", "after")
    finally:
        for p in procs:
            _stop(p)


def test_cli_mixed_classic_cluster_over_raft(tmp_path):
    """Two JAX-package members (``python -m etcd_tpu.cli``) and one port
    member form one classic cluster over /raft: writes through either
    package replicate to both."""
    names = ["j0", "j1", "t2"]
    peers = [_free_port() for _ in names]
    clients = [_free_port() for _ in names]
    jenv = _env(JAX_PLATFORMS="cpu")
    procs = [_classic(tmp_path, names, i, peers, clients,
                      module="etcd_tpu.cli", env=jenv) for i in range(2)]
    procs.append(_classic(tmp_path, names, 2, peers, clients))
    try:
        for i in range(3):
            _wait_port(clients[i], procs[i], deadline_s=120)
        bases = [f"http://127.0.0.1:{c}" for c in clients]
        _put_until_acked(bases[2], "mix/a", "from-port", 120)
        _put_until_acked(bases[0], "mix/b", "from-jax", 120)
        for b in bases:
            _read_until(b, "mix/a", "from-port", 120)
            _read_until(b, "mix/b", "from-jax", 120)
    finally:
        for p in procs:
            _stop(p)


def test_cli_discovery_and_proxy_against_a_port_server(tmp_path):
    """A port classic member serves as the discovery registry: a member
    started with ``--discovery`` (size 1) bootstraps from it and serves;
    a ``--proxy on --discovery`` process reads its endpoints from the
    registry and passes writes; ``--proxy readonly`` answers a PUT with
    501."""
    rp, rc = _free_port(), _free_port()
    registry = _classic(tmp_path, ["reg"], 0, [rp], [rc])
    procs = [registry]
    try:
        _wait_port(rc, registry)
        reg = f"http://127.0.0.1:{rc}"
        _put_until_acked(reg, "disc/_config/size", "1")
        mp, mc = _free_port(), _free_port()
        murl, mpeer = f"http://127.0.0.1:{mc}", f"http://127.0.0.1:{mp}"
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "etcd_tpu_torch.cli", "--name", "m",
             "--discovery", f"{reg}/disc",
             "--data-dir", str(tmp_path / "m"),
             "--listen-peer-urls", mpeer, "--advertise-peer-urls", mpeer,
             "--listen-client-urls", murl,
             "--advertise-client-urls", murl],
            env=_env(ETCD_TORCH_DEVICE="cpu"), cwd=REPO,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
        _wait_port(mc, procs[-1])
        _put_until_acked(murl, "app/d", "discovered")
        _read_until(murl, "app/d", "discovered")
        # the member registered itself; a proxy registry lists the
        # member's client URL for the proxy to find
        _put_until_acked(reg, "pxy/1", f"m={murl}")
        for mode, want in (("on", 201), ("readonly", 501)):
            pp = _free_port()
            url = f"http://127.0.0.1:{pp}"
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "etcd_tpu_torch.cli", "--proxy",
                 mode, "--discovery", f"{reg}/pxy",
                 "--listen-client-urls", url],
                env=_env(), cwd=REPO, stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE, text=True))
            _wait_port(pp, procs[-1])
            assert _put(url, f"app/p{mode}", "x")[0] == want
            st, _, body = _get(f"{url}/v2/keys/app/d")
            assert json.loads(body)["node"]["value"] == "discovered"
    finally:
        for p in procs:
            _stop(p)


def test_cli_default_flags_serve_through_the_front_door(tmp_path):
    """With default flags the CLI's client listener is a ``FrontDoor``,
    not the threaded ``_Server``; ``--frontdoor off`` gives the
    threaded server."""
    from etcd_tpu_torch.api.http import _Server
    from etcd_tpu_torch.server import Cluster, ServerConfig, new_server
    from etcd_tpu_torch.server.frontdoor import FrontDoor

    c = Cluster()
    c.set_from_string("solo=http://127.0.0.1:1")
    s = new_server(ServerConfig(name="solo", data_dir=str(tmp_path),
                                cluster=c), device="cpu")
    args = cli.build_parser().parse_args([])
    assert args.frontdoor == "on"
    lis = cli._serve_client(args, s, None, "127.0.0.1", 0, None)
    try:
        assert isinstance(lis, FrontDoor) and not isinstance(lis, _Server)
    finally:
        lis.shutdown()
    off = cli.build_parser().parse_args(["--frontdoor", "off"])
    lis = cli._serve_client(off, s, None, "127.0.0.1", 0, None)
    try:
        assert isinstance(lis, _Server)
    finally:
        lis.shutdown()
        s.storage.wal.close()
        s.store.fanout.close()


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
            _assert_front_door(f"http://127.0.0.1:{clients[s]}")
    finally:
        for p in procs:
            _stop(p)
