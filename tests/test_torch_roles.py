"""The port's role-split topology (``etcd_tpu_torch.server.roles``, its
shared-memory ring ``server/shmring.py``, ``dist_node --roles`` and the
CLI's ``--dist-roles``) against the JAX package's, on the CPU
(``ETCD_TORCH_DEVICE=cpu``).

- The cases of ``tests/test_roles.py`` (the DRH1 frame round trips, the
  mutation totality over 12 seeds, the ring, the 3-host x 2-shard
  cluster and the worker's crash respawn) run against the port: the
  reference module executed with its imports pointed at
  ``etcd_tpu_torch``, its hosts started as ``python -m
  etcd_tpu_torch.scripts.dist_node --roles`` with 8 groups.
- The port's role frames are byte-equal to the reference's for the same
  inputs, and each package unpacks the other's.
- The same pushes and pops leave byte-equal ring segments in both
  packages; either package's endpoint consumes the other's ring; and a
  port worker process mirrors the commit frames the reference's
  ``CommitSink`` pushed, and, killed and respawned, resumes at the
  ring's tail.
- A write the ingest's handoff sent again after a timeout is refused and
  committed twice, the same in both packages.
- The supervisor spawns ``etcd_tpu_torch.server.roles`` (the child
  module is a string, which the package's import check cannot see),
  with the reference's arguments otherwise; a shard without CUDA and
  without a CPU request exits naming CUDA before touching its data dir.
- The role phase of ``chip_smoke.py`` (``scripts/roles_bench.run``) at
  8 groups: three hosts started through the CLI (``--dist-roles 2``),
  the load through host 0's ingest, a shard SIGKILLed and respawned onto
  the stream lane, then the worker SIGKILLed and its replacement's watch
  stream (every key once), every write acked, every acked key read back
  through every ingest, the merged observability plane; and the rows of
  ``dist_bench --roles`` and ``--profile-overhead``.  The cluster cases
  share this file so that their process trees run one after another.

Tolerance: exact.
"""

from __future__ import annotations

import json
import os
import random
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from etcd_tpu.server import roles as jroles
from etcd_tpu.server import shmring as jshm
from etcd_tpu.store.event import Event as JEvent
from etcd_tpu.store.event import NodeExtern as JNode
from etcd_tpu.wire import rolemsg as jrole
from etcd_tpu.wire.requests import Request as JRequest
from etcd_tpu_torch.scripts import dist_bench, roles_bench
from etcd_tpu_torch.scripts.dist_bench import free_port_block
from etcd_tpu_torch.server import roles as troles
from etcd_tpu_torch.server import shmring as tshm
from etcd_tpu_torch.store.event import Event as TEvent
from etcd_tpu_torch.store.event import NodeExtern as TNode
from etcd_tpu_torch.wire import rolemsg as trole

from test_torch_raft_core import export, port_module

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env() -> dict:
    env = dict(os.environ)
    env["ETCD_TORCH_DEVICE"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _port_spawn(_ref_spawn):
    def spawn(tmp, slot, urls, client_port, shards, bootstrap=False):
        cmd = [sys.executable, "-m", "etcd_tpu_torch.scripts.dist_node",
               "--data-dir", os.path.join(tmp, f"d{slot}"),
               "--slot", str(slot), "--peers", ",".join(urls),
               "--groups", "8", "--roles", str(shards),
               "--client-port", str(client_port)]
        if bootstrap:
            cmd.append("--bootstrap")
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL, env=_env(),
                                cwd=REPO, text=True)
    return spawn


assert export(port_module("test_roles", {"_spawn": _port_spawn}), "roles",
              globals()) == 13


# -- role frames -------------------------------------------------------------


def _event(mod_event, mod_node, rng, kind: float):
    """The three shapes of the reference's round-trip case: a flat row,
    a TTL'd node and a listing (the per-op JSON fallback)."""
    if kind < 0.6:
        node = mod_node(key="/k", value="v" * rng.randrange(9),
                        modified_index=rng.randrange(100),
                        created_index=rng.randrange(100))
    elif kind < 0.8:
        node = mod_node(key="/t", value="x", ttl=rng.randrange(1, 99),
                        expiration=123.5, modified_index=5,
                        created_index=5)
    else:
        node = mod_node(key="/d", dir=True, modified_index=4,
                        created_index=4,
                        nodes=[mod_node(key="/d/x", value="1",
                                        modified_index=4,
                                        created_index=4)])
    return mod_event(action=rng.choice(("get", "set", "delete")),
                     node=node, etcd_index=rng.randrange(100))


class _Err(Exception):
    def __init__(self, code, cause, index):
        super().__init__(cause)
        self.error_code, self.cause, self.index = code, cause, index


@pytest.mark.parametrize("seed", range(6))
def test_role_frames_byte_equal_the_reference(seed):
    rng = random.Random(seed)
    n = rng.randrange(1, 9)
    blobs = [rng.randbytes(rng.randrange(60)) for _ in range(n)]
    flags = [rng.randrange(2) for _ in range(n)]
    reply = rng.choice([jrole.REPLY_EVENTS, jrole.REPLY_ACKS,
                        jrole.REPLY_VALS])
    errs = {i: (rng.randrange(600), "m" * rng.randrange(5))
            for i in range(n) if rng.random() < 0.5}
    vals = [rng.choice([None, b"", rng.randbytes(8), "s"])
            for _ in range(n)]
    rows = [(rng.randrange(8), rng.randrange(1000),
             rng.randbytes(rng.randrange(30))) for _ in range(n)]
    seq = rng.randrange(1 << 31)
    kinds = [rng.random() for _ in range(n)]
    results = {}
    for pkg, ev, nd in (("j", JEvent, JNode), ("t", TEvent, TNode)):
        r2 = random.Random(seed + 100)
        results[pkg] = [
            _Err(r2.randrange(600), "boom", r2.randrange(100)) if k < 0.3
            else _event(ev, nd, r2, (k - 0.3) / 0.7) for k in kinds]
    frames = {}
    for pkg, mod in (("j", jrole), ("t", trole)):
        frames[pkg] = [
            bytes(mod.pack_fwd_request(blobs, flags, reply)),
            bytes(mod.pack_fwd_acks(n, errs)),
            bytes(mod.pack_fwd_vals(vals, errs)),
            bytes(mod.pack_fwd_response(results[pkg])),
            bytes(mod.pack_commit(seq, rows))]
    assert frames["t"] == frames["j"]
    # each package unpacks the other's frames alike
    for src, dst in (("j", trole), ("t", jrole)):
        req, acks, vs, resp, commit = frames[src]
        out, fl, rep = dst.unpack_fwd_request(req)
        assert (out, list(fl), rep) == (blobs, flags, reply)
        assert dst.unpack_fwd_acks(acks) == (n, errs)
        assert dst.unpack_fwd_vals(vs) == (
            [None if v is None else v.encode() if isinstance(v, str)
             else v for v in vals], errs)
        got = dst.unpack_fwd_response(resp)
        for g, want in zip(got, results[src]):
            if isinstance(want, _Err):
                assert g == (want.error_code, want.cause, want.index)
            else:
                assert g.to_dict() == want.to_dict()
                assert g.etcd_index == want.etcd_index
        s2, groups, gidx, bl = dst.unpack_commit(commit)
        assert (s2, groups.tolist(), gidx.tolist(), bl) == (
            seq, [r[0] for r in rows], [r[1] for r in rows],
            [r[2] for r in rows])


# -- the shared-memory ring --------------------------------------------------


_N = [0]


def _name(tag: str) -> str:
    _N[0] += 1
    return f"etcdtpu_torch_test_{os.getpid()}_{tag}{_N[0]}"


def _drive_ring(ring, rng_seed: int) -> list:
    """Seeded pushes and pops (wraps, drops, oversized records);
    returns every push verdict and popped record."""
    rng = random.Random(rng_seed)
    out = []
    for _ in range(400):
        if rng.random() < 0.55:
            n = rng.choice([rng.randrange(1, 40), rng.randrange(200),
                            rng.randrange(1500)])
            out.append(ring.push(rng.randbytes(n)))
        else:
            out.append(ring.pop())
    return out + [ring.dropped, ring.head, ring.tail]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ring_segment_bytes_equal_the_reference(seed):
    rings = [jshm.ShmRing(_name("j"), capacity=1 << 12, create=True),
             tshm.ShmRing(_name("t"), capacity=1 << 12, create=True)]
    try:
        jrun, trun = (_drive_ring(r, seed) for r in rings)
        assert trun == jrun
        assert bytes(rings[1]._shm.buf) == bytes(rings[0]._shm.buf)
    finally:
        for r in rings:
            r.close()
            r.unlink()


def test_ring_crosses_between_the_packages():
    for make, attach in ((jshm.ShmRing, tshm.ShmRing),
                         (tshm.ShmRing, jshm.ShmRing)):
        owner = make(_name("x"), capacity=1 << 10, create=True)
        try:
            recs = [bytes([i]) * (1 + i % 29) for i in range(80)]
            other = attach(owner.name)
            got = []
            for r in recs:  # interleaved: the span wraps many times
                assert owner.push(r)
                got.append(other.pop())
            assert got == recs and other.pop() is None
            other.close()
        finally:
            owner.close()
            owner.unlink()


def _worker(tmp, client_port: int, peer_port: int) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "etcd_tpu_torch.server.roles",
         "--role", "worker", "--data-dir", str(tmp), "--slot", "0",
         "--peers", f"http://127.0.0.1:{peer_port}",
         "--client-port", str(client_port), "--shards", "1",
         "--groups", "1", "--flight-dir", str(tmp / "flight")],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=_env(),
        cwd=REPO, text=True)


def _ready(proc, deadline_s: float = 60.0) -> None:
    t0 = time.time()
    for line in proc.stdout:
        if line.strip() == "ROLE-READY worker":
            return
        assert time.time() - t0 < deadline_s, "worker never ready"
    raise AssertionError(f"worker exited rc={proc.wait()}")


def _mirror(port: int, key: str, deadline_s: float = 30.0):
    """The worker's value of ``key`` once it has it (None: a 404 after
    the deadline)."""
    t0 = time.time()
    while True:
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/v2/keys{key}",
                    timeout=5) as r:
                return json.loads(r.read())["node"]["value"]
        except urllib.error.HTTPError as e:
            assert e.code == 404
            if time.time() - t0 > deadline_s:
                return None
        time.sleep(0.1)


def _commit(sink, keys):
    sink.push([(0, i + 1, JRequest(id=1000 + i, method="PUT", path=k,
                                   val=k).marshal())
               for i, k in enumerate(keys)])


def test_port_worker_consumes_the_references_ring(tmp_path):
    """The reference's CommitSink produces; the port's worker process
    mirrors what it pushed, and a respawned worker resumes at the
    ring's tail: commits pushed before its crash are not replayed."""
    client, peer = free_port_block(2), free_port_block(1)
    ring = jshm.ShmRing(jroles.ring_name(client, 0),
                        capacity=jroles.RING_BYTES, create=True)
    sink = jroles.CommitSink(ring)
    procs = []
    try:
        procs.append(_worker(tmp_path, client, peer))
        _ready(procs[-1])
        _commit(sink, ["/a/k0", "/a/k1"])
        assert _mirror(client + 1, "/a/k1") == "/a/k1"
        assert _mirror(client + 1, "/a/k0") == "/a/k0"
        procs[-1].send_signal(signal.SIGKILL)
        procs[-1].wait(timeout=30)
        _commit(sink, ["/b/k2"])  # lands while no worker runs
        procs.append(_worker(tmp_path, client, peer))
        _ready(procs[-1])
        assert _mirror(client + 1, "/b/k2") == "/b/k2"
        # behind the persisted tail: never redelivered
        assert _mirror(client + 1, "/a/k0", deadline_s=1.0) is None
        assert ring.tail == ring.head
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
                p.wait(timeout=30)
        ring.close()
        ring.unlink()


# -- the supervisor's wiring -------------------------------------------------


ARGV = ["--role", "supervise", "--data-dir", "/tmp/x", "--slot", "1",
        "--peers", "http://127.0.0.1:7700,http://127.0.0.1:7701",
        "--client-port", "9000", "--shards", "2", "--groups", "8",
        "--snap-count", "500", "--bootstrap"]


def test_child_argv_names_the_ports_module():
    t = troles.Supervisor(troles.make_parser().parse_args(ARGV))
    j = jroles.Supervisor(jroles.make_parser().parse_args(ARGV))
    assert t.role_names() == j.role_names()
    for role in t.role_names():
        ta, ja = t._child_argv(role), j._child_argv(role)
        assert ta[:3] == [sys.executable, "-m",
                          "etcd_tpu_torch.server.roles"]
        assert ja[2] == "etcd_tpu.server.roles"
        assert ta[3:] == ja[3:], role
        assert t._port_of(role) == j._port_of(role)
    assert troles.make_parser().prog == "etcd_tpu_torch.server.roles"


def test_shard_without_cuda_raises(tmp_path):
    env = _env()
    env.pop("ETCD_TORCH_DEVICE")
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run(
        [sys.executable, "-m", "etcd_tpu_torch.server.roles",
         "--role", "shard", "--data-dir", str(tmp_path), "--slot", "0",
         "--peers", "http://127.0.0.1:1,http://127.0.0.1:2",
         "--client-port", "3", "--shards", "1", "--groups", "4",
         "--flight-dir", str(tmp_path / "flight")],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr
    assert "ROLE-READY" not in r.stdout
    assert not (tmp_path / "shard0").exists()


# -- a refused handoff that commits twice, in both packages -----------------


@pytest.mark.parametrize("package", ["etcd_tpu", "etcd_tpu_torch"])
def test_ingest_resend_after_a_timeout_commits_a_refused_write_twice(
        package, tmp_path):
    """The ingest's handoff pool (``peerlink.KeepAlivePool.post``) sends
    a batch again after any failure, a read timeout after the shard took
    it included: when both sends time out, the client is refused
    ("shard 0 unreachable") while the shard commits the write twice.
    One in-order create (POST) through ``RemoteEtcd`` to a one-host
    ``DistServer`` whose peer handler holds each of the first two
    requests 1 s (``http.peer=delay``) past the pool's 0.3 s timeout
    leaves two children in both packages: kept from the reference."""
    mod = __import__(package + ".server.distserver", fromlist=["x"])
    roles = __import__(package + ".server.roles", fromlist=["x"])
    faults = __import__(package + ".utils.faults", fromlist=["x"])
    req = __import__(package + ".wire.requests", fromlist=["x"])
    errors = __import__(package + ".utils.errors", fromlist=["x"])
    url = f"http://127.0.0.1:{dist_bench.free_ports(1)[0]}"
    kw = {"device": "cpu"} if package == "etcd_tpu_torch" else {}
    srv = mod.DistServer(str(tmp_path / "d0"), slot=0, peer_urls=[url],
                         g=2, cap=64, tick_interval=0.05, post_timeout=2.0,
                         election=60, **kw)
    srv.start()
    ing = roles.RemoteEtcd("127.0.0.1", 1, [url], 0, 1, timeout=0.3)
    try:
        deadline = time.monotonic() + 30
        while not srv.mr.is_leader().all():
            assert time.monotonic() < deadline, "no leader"
            srv._campaign(~srv.mr.is_leader())
            time.sleep(0.2)
        faults.FAULTS.configure("http.peer=delay(1s,times=2)", seed=1)
        try:
            with pytest.raises(errors.EtcdError,
                               match="shard 0 unreachable"):
                ing.do(req.Request(method="POST", path="/q", val="x",
                                   id=random.getrandbits(62) + 1),
                       timeout=10)
        finally:
            faults.FAULTS.configure("")

        def children() -> list:
            try:
                ev = srv.store.get("/q", True, True)
            except Exception:
                return []
            return [(n.key, n.value) for n in ev.node.nodes or []]

        deadline = time.monotonic() + 20
        while len(children()) < 2 and time.monotonic() < deadline:
            time.sleep(0.1)
        assert [v for _, v in children()] == ["x", "x"], children()
    finally:
        ing.stop()
        srv.stop()


# -- the role phase of chip_smoke.py, at a small size -----------------------

_CPU = {"ETCD_TORCH_DEVICE": "cpu", "OMP_NUM_THREADS": "1"}


def test_roles_phase_at_small_size(tmp_path):
    r = roles_bench.run(groups=8, shards=2, total=300, extra=60, conns=4,
                        window=32, snap_count=40, watch_keys=20,
                        env_extra=_CPU, tmp=str(tmp_path))
    assert r["device"] == "cpu" and r["cap"] == 1024
    assert r["load"]["acked"] == 300 and r["load_one_down"]["acked"] == 60
    assert r["read_back"] == 401
    # every shard snapshotted under the load (snap count 40)
    assert min(r["snapshots"].values()) > 0
    rs = r["shard_restart"]
    assert rs["lane"] == "stream" and rs["seconds"] > 0
    assert rs["catch_up_s"] >= 0
    w = r["worker_respawn"]
    # every write acked, each directory's 20 on one group
    assert w["written_down"] == w["written_up"] == 20
    assert w["events"] >= 40
    assert w["duplicates"] == w["missing"] == w["repeated_events"] == 0
    assert r["merged_acked_per_s_120s"] > 0
    assert all(v == 1.0 for h in r["role_up"].values()
               for v in h.values())
    assert [d for d in r["profile_domains"] if d != "-"]
    assert len(r["shard_pids"]) == 6 and len(r["other_pids"]) == 9
    assert r["handoff_cpu_s"] > 0 and r["per_role_cpu_s"]["ingest"] > 0


def test_roles_once_and_profile_overhead_rows(monkeypatch):
    row = dist_bench.run_roles_once(120, 2, 16, 1, groups=2, cap=64,
                                    env_extra=_CPU)
    assert row["acked"] == 120 and row["serving_shards"] == 1
    assert row["windowed"] is not None and row["slo"] is not None
    load = dist_bench.run_load_once(4, 64, 120, 2, 16, 8, 32,
                                    env_extra=_CPU)
    assert load["acked"] == 120 and load["acked_writes_per_s"] > 0
    calls = []

    def fake(**kw):
        calls.append(kw["env_extra"])
        return {"acked_writes_per_s": 100.0 if kw["env_extra"] else 99.5}

    monkeypatch.setattr(dist_bench, "run_load_once", fake)
    o = dist_bench.run_profile_overhead(10, 1, 1, groups=4, cap=64,
                                        depth=8, max_batch_ents=32)
    assert calls[:2] == [None, {"ETCD_PROFILE_HZ": "0"}]
    assert o["runs_per_arm"] == 2 and o["profile_overhead_pct"] == 0.5
