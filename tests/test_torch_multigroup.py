"""The port's co-hosted multi-group server (etcd_tpu_torch, on the CPU).

Every scenario of tests/test_multigroup.py except the two mesh tests
runs on the port's server (``device="cpu"``).  Then, against the JAX
package's server: a data dir written by either package restarts in the
other with equal store bytes, ``raft_index``, frontier, terms and
restart-seeded engine states; the same serial request sequence through
each package's HTTP handler gives equal status codes, X-Etcd-Index
headers and JSON bodies; and ``_replay_wal_raw`` names the same lane as
the reference for every backend below and above the device threshold,
heals a torn tail under ``tpu``, and raises where a lane fails for any
other reason.  Tolerance: exact.
"""

import json
import os
import shutil
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from etcd_tpu.api.http import make_client_handler as jmake_handler
from etcd_tpu.server import server as jserver
from etcd_tpu.server.multigroup import MultiGroupServer as JServer
from etcd_tpu.wal import WAL as JWAL
from etcd_tpu.wal import backend_policy as jpolicy
from etcd_tpu.wire import Entry as JEntry
from etcd_tpu.wire import HardState as JHardState

from etcd_tpu_torch.api.http import make_client_handler, serve
from etcd_tpu_torch.server import server as tserver
from etcd_tpu_torch.server.multigroup import MultiGroupServer, group_of
from etcd_tpu_torch.server.server import ServerStoppedError
from etcd_tpu_torch.utils.errors import EtcdError
from etcd_tpu_torch.wal import backend_policy as tpolicy
from etcd_tpu_torch.wal.replay_device import EntryBlock
from etcd_tpu_torch.wire.requests import Request

G, M, CAP = 8, 3, 64


def _mk(tmp_path, **kw):
    kw.setdefault("g", G)
    kw.setdefault("m", M)
    kw.setdefault("cap", CAP)
    kw.setdefault("tick_interval", 0.02)
    return MultiGroupServer(str(tmp_path / "data"), device="cpu", **kw)


def _put(s, path, val, timeout=60):
    return s.do(Request(id=np.random.randint(1, 2**62), method="PUT",
                        path=path, val=val), timeout=timeout)


def _get(s, path):
    return s.do(Request(id=np.random.randint(1, 2**62), method="GET",
                        path=path))


# -- the scenarios of tests/test_multigroup.py (mesh tests excluded) --------

def test_group_routing_spreads():
    seen = {group_of(f"/ns{i}/k", G) for i in range(64)}
    assert len(seen) > 2
    assert group_of("/apps/web", G) == group_of("/apps/other", G)


def test_put_get_across_groups(tmp_path):
    s = _mk(tmp_path)
    s.start()
    try:
        for i in range(12):
            resp = _put(s, f"/svc{i}/endpoint", f"10.0.0.{i}:4001")
            assert resp.err is None and resp.event.action == "set"
        for i in range(12):
            ev = _get(s, f"/svc{i}/endpoint").event
            assert ev.node.value == f"10.0.0.{i}:4001"
        assert s.index() >= 12
    finally:
        s.stop()


def test_cas_and_delete_through_consensus(tmp_path):
    s = _mk(tmp_path)
    s.start()
    try:
        _put(s, "/cfg/flag", "on")
        resp = s.do(Request(id=7001, method="PUT", path="/cfg/flag",
                            val="off", prev_value="on"), timeout=60)
        assert resp.event.action == "compareAndSwap"
        with pytest.raises(EtcdError):
            s.do(Request(id=7002, method="PUT", path="/cfg/flag",
                         val="x", prev_value="WRONG"), timeout=60)
        resp = s.do(Request(id=7003, method="DELETE", path="/cfg/flag"),
                    timeout=60)
        assert resp.event.action == "delete"
    finally:
        s.stop()


def test_watch_fires_on_commit(tmp_path):
    s = _mk(tmp_path)
    s.start()
    try:
        wc = s.do(Request(id=7101, method="GET", path="/jobs/j1",
                          wait=True)).watcher
        got = []
        t = threading.Thread(
            target=lambda: got.append(wc.next_event(timeout=60)))
        t.start()
        _put(s, "/jobs/j1", "queued")
        t.join(timeout=60)
        assert got and got[0].action == "set"
        assert got[0].node.value == "queued"
    finally:
        s.stop()


def test_restart_replays_all_groups(tmp_path):
    s = _mk(tmp_path)
    s.start()
    try:
        for i in range(10):
            _put(s, f"/db{i}/row", f"v{i}")
    finally:
        s.stop()
    s2 = _mk(tmp_path)
    assert s2.index() >= 10
    try:
        for i in range(10):
            assert s2.store.get(f"/db{i}/row", False, False).node.value \
                == f"v{i}"
        s2.start()
        _put(s2, "/db0/row", "v0b")
        assert _get(s2, "/db0/row").event.node.value == "v0b"
    finally:
        s2.stop()


def test_snapshot_then_restart(tmp_path):
    s = _mk(tmp_path, snap_count=5)
    s.start()
    try:
        for i in range(12):
            _put(s, f"/snapns{i % 3}/k{i}", f"x{i}")
    finally:
        s.stop()
    assert os.listdir(tmp_path / "data" / "snap")
    s2 = _mk(tmp_path, snap_count=5)
    try:
        for i in range(12):
            ev = s2.store.get(f"/snapns{i % 3}/k{i}", False, False)
            assert ev.node.value == f"x{i}"
    finally:
        s2.stop()


def test_ttl_expires_in_cohosted_mode(tmp_path):
    s = _mk(tmp_path, sync_interval=0.05)
    s.start()
    try:
        s.do(Request(id=8101, method="PUT", path="/lease/a", val="v",
                     expiration=int((time.time() + 0.3) * 1e9)),
             timeout=60)
        assert _get(s, "/lease/a").event.node.value == "v"
        deadline = time.time() + 30
        while time.time() < deadline:
            time.sleep(0.05)
            try:
                _get(s, "/lease/a")
            except EtcdError:
                break
        else:
            raise AssertionError("TTL key never expired")
    finally:
        s.stop()


def test_stop_releases_waiters_promptly(tmp_path):
    s = _mk(tmp_path)
    s.start()
    _put(s, "/warm/k", "v")
    results = []

    def client():
        try:
            _put(s, "/late/k", "v", timeout=60)
            results.append("ok")
        except ServerStoppedError:
            results.append("stopped")
        except TimeoutError:
            results.append("timeout")

    ts = [threading.Thread(target=client) for _ in range(4)]
    t0 = time.time()
    for t in ts:
        t.start()
    s.stop()
    for t in ts:
        t.join(timeout=30)
    assert len(results) == 4
    assert time.time() - t0 < 20
    assert set(results) <= {"ok", "stopped"}


def test_restart_wrong_group_count_rejected(tmp_path):
    s = _mk(tmp_path)
    s.start()
    try:
        _put(s, "/x/k", "v")
    finally:
        s.stop()
    with pytest.raises(RuntimeError, match="cohosted-groups"):
        MultiGroupServer(str(tmp_path / "data"), g=G * 2, m=M, cap=CAP,
                         device="cpu")


def test_machines_endpoint_lists_self(tmp_path):
    s = _mk(tmp_path, client_urls=["http://127.0.0.1:9999"])
    s.start()
    try:
        assert "http://127.0.0.1:9999" in \
            s.cluster_store.get().client_urls_all()
    finally:
        s.stop()


def test_double_restart_preserves_sequence(tmp_path):
    s = _mk(tmp_path, snap_count=3)
    s.start()
    try:
        for i in range(8):
            _put(s, f"/et{i}/k", f"v{i}")
    finally:
        s.stop()
    s2 = _mk(tmp_path, snap_count=3)
    seq_after_replay = s2.seq
    s2.stop()
    assert seq_after_replay > 0
    s3 = _mk(tmp_path, snap_count=3)
    assert s3.seq >= seq_after_replay
    s3.start()
    try:
        _put(s3, "/et0/k", "v0b")
    finally:
        s3.stop()
    s4 = _mk(tmp_path, snap_count=3)
    try:
        assert s4.store.get("/et0/k", False, False).node.value == "v0b"
        assert s4.store.get("/et7/k", False, False).node.value == "v7"
        assert s4.index() >= 9
    finally:
        s4.stop()


def test_http_puts_across_cohosted_groups(tmp_path):
    s = _mk(tmp_path)
    s.start()
    httpd = None
    try:
        httpd = serve(make_client_handler(s), "127.0.0.1", 0)
        port = httpd.server_address[1]
        for i in range(6):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v2/keys/web{i}/cfg",
                data=f"value=V{i}".encode(), method="PUT")
            req.add_header("Content-Type",
                           "application/x-www-form-urlencoded")
            with urllib.request.urlopen(req, timeout=60) as resp:
                assert json.loads(resp.read())["action"] == "set"
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/v2/keys/web3/cfg",
                timeout=30) as resp:
            assert json.loads(resp.read())["node"]["value"] == "V3"
    finally:
        if httpd is not None:
            httpd.shutdown()
        s.stop()
    s2 = _mk(tmp_path)
    try:
        assert s2.store.get("/web5/cfg", False, False).node.value == "V5"
    finally:
        s2.stop()


def test_runtime_membership_grow_and_shrink(tmp_path):
    s = _mk(tmp_path, spare_member_slots=1)
    s.start()
    try:
        _put(s, "/mem/a", "1")
        assert s.members_of(0).sum() == 3
        s.add_member(3)
        assert all(s.members_of(gi).sum() == 4 for gi in range(G))
        _put(s, "/mem/b", "2")
    finally:
        s.stop()
    mr = s.mr
    ones = np.ones(G, bool)
    drop = {}
    for dead in (2, 3):
        for other in range(s.m):
            if other != dead:
                drop[(dead, other)] = ones
                drop[(other, dead)] = ones
    before = mr.commit_index().copy()
    mr.propose(np.ones(G, np.int32), drop=drop)
    mr.replicate(drop=drop)
    assert (mr.commit_index() == before).all(), "2-of-4 must NOT commit"
    mr.replicate()
    assert (mr.commit_index() > before).all()

    s2 = _mk(tmp_path, spare_member_slots=1)
    s2.start()
    try:
        assert all(s2.members_of(gi).sum() == 4 for gi in range(G))
        s2.remove_member(3)
        assert all(s2.members_of(gi).sum() == 3 for gi in range(G))
        _put(s2, "/mem/c", "3")
    finally:
        s2.stop()
    mr = s2.mr
    before = mr.commit_index().copy()
    drop2 = {}
    for other in range(s2.m):
        if other != 2:
            drop2[(2, other)] = ones
            drop2[(other, 2)] = ones
    mr.propose(np.ones(G, np.int32), drop=drop2)
    mr.replicate(drop=drop2)
    assert (mr.commit_index() > before).all(), "2-of-3 must commit"


def test_membership_survives_restart(tmp_path):
    s = _mk(tmp_path, spare_member_slots=1)
    s.start()
    try:
        _put(s, "/m/a", "1")
        s.add_member(3)
        _put(s, "/m/b", "2")
    finally:
        s.stop()
    s2 = _mk(tmp_path, spare_member_slots=1)
    try:
        assert all(s2.members_of(gi).sum() == 4 for gi in range(G))
        assert s2.store.get("/m/b", False, False).node.value == "2"
        s2.start()
        s2.snapshot()
    finally:
        s2.stop()
    s3 = _mk(tmp_path, spare_member_slots=1)
    try:
        assert all(s3.members_of(gi).sum() == 4 for gi in range(G))
    finally:
        s3.stop()


def test_conf_change_rejects_out_of_range_slot(tmp_path):
    s = _mk(tmp_path)
    s.start()
    try:
        with pytest.raises(ValueError):
            s.add_member(99)
    finally:
        s.stop()


def test_members_mask_migrates_across_spare_slot_change(tmp_path):
    s = _mk(tmp_path, spare_member_slots=1)
    s.start()
    try:
        _put(s, "/mm/a", "1")
        s.add_member(3)
        s.snapshot()
    finally:
        s.stop()
    s2 = _mk(tmp_path, spare_member_slots=2)
    s2.start()
    try:
        assert s2.members_of(0).size == 5
        assert s2.members_of(0).sum() == 4
        _put(s2, "/mm/b", "2")
    finally:
        s2.stop()
    with pytest.raises(RuntimeError, match="spare_member_slots"):
        _mk(tmp_path, spare_member_slots=0)


def test_multigroup_restart_heals_torn_wal_tail(tmp_path):
    s = _mk(tmp_path)
    s.start()
    try:
        for i in range(6):
            _put(s, f"/tt{i % 3}/k", f"v{i}")
    finally:
        s.stop()
    waldir = tmp_path / "data" / "wal"
    f = waldir / sorted(os.listdir(waldir))[-1]
    os.truncate(f, os.path.getsize(f) - 11)
    s2 = _mk(tmp_path)
    s2.start()
    try:
        assert _put(s2, "/tt0/after", "crash").event.node.value == "crash"
        got = sum(1 for i in range(3)
                  if _get(s2, f"/tt{i}/k").event is not None)
        assert got >= 2
    finally:
        s2.stop()


def test_server_raises_without_cuda_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiGroupServer(str(tmp_path / "data"), g=2, m=3, cap=8)
    assert not (tmp_path / "data").exists()


# -- a data dir crosses between the two packages ----------------------------

def _write_dir(cls, d, **kw):
    """Serve a few writes (a snapshot among them, and a committed conf
    change after it) with ``cls``, then stop."""
    s = cls(str(d), g=G, m=M, cap=CAP, tick_interval=0.02, snap_count=6,
            **kw)
    s.start()
    try:
        for i in range(10):
            r = s.do(Request(id=5000 + i, method="PUT",
                             path=f"/x{i % 4}/k{i}", val=f"v{i}"),
                     timeout=60)
            assert r.err is None
        s.add_member(3)
        r = s.do(Request(id=5100, method="DELETE", path="/x0/k0"),
                 timeout=60)
        assert r.err is None
    finally:
        s.stop()


def _restart_view(s) -> dict:
    states = []
    for st in s.mr.states:
        states.append({f: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                           else np.asarray(v))
                       for f, v in st._asdict().items()})
    return {"store": s.store.save(), "raft_index": s.raft_index,
            "raft_term": s.raft_term, "applied": s.applied.copy(),
            "seq": s.seq, "states": states, "leader": s.mr.leader.copy()}


def _assert_views_equal(a: dict, b: dict) -> None:
    assert a["store"] == b["store"]
    for k in ("raft_index", "raft_term", "seq"):
        assert a[k] == b[k], k
    np.testing.assert_array_equal(a["applied"], b["applied"])
    np.testing.assert_array_equal(a["leader"], b["leader"])
    for s, (x, y) in enumerate(zip(a["states"], b["states"])):
        for f in x:
            np.testing.assert_array_equal(x[f], y[f],
                                          err_msg=f"slot {s} field {f}")
            assert x[f].dtype == y[f].dtype, (s, f)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_data_dir_restarts_in_the_other_package(tmp_path, writer):
    src = tmp_path / "src"
    if writer == "jax":
        _write_dir(JServer, src)
    else:
        _write_dir(MultiGroupServer, src, device="cpu")
    shutil.copytree(src, tmp_path / "a")
    shutil.copytree(src, tmp_path / "b")
    js = JServer(str(tmp_path / "a"), g=G, m=M, cap=CAP, snap_count=6)
    ts = MultiGroupServer(str(tmp_path / "b"), g=G, m=M, cap=CAP,
                          snap_count=6, device="cpu")
    try:
        assert ts.raft_index > 10
        _assert_views_equal(_restart_view(ts), _restart_view(js))
        assert all(ts.members_of(gi).sum() == 4 for gi in range(G))
    finally:
        js.stop()
        ts.stop()


# -- the same requests through both HTTP handlers ---------------------------

_SEQUENCE = [
    ("PUT", "/v2/keys/a/x", "value=1"),
    ("GET", "/v2/keys/a/x", None),
    ("PUT", "/v2/keys/a/x", "value=2&prevValue=1"),
    ("PUT", "/v2/keys/a/x", "value=3&prevValue=WRONG"),
    ("PUT", "/v2/keys/b/y", "value=new&prevExist=false"),
    ("PUT", "/v2/keys/b/y", "value=again&prevExist=false"),
    ("POST", "/v2/keys/q", "value=job1"),
    ("POST", "/v2/keys/q", "value=job2"),
    ("GET", "/v2/keys/q?recursive=true&sorted=true", None),
    ("PUT", "/v2/keys/d?dir=true", ""),
    ("DELETE", "/v2/keys/a/x?prevValue=2", None),
    ("GET", "/v2/keys/a/x", None),
    ("GET", "/v2/keys/a/x?waitIndex=1&wait=true", None),
    ("GET", "/v2/keys/?recursive=true&sorted=true", None),
    ("PUT", "/v2/keys/a/x", "ttl=bad"),
    ("GET", "/v2/keys/q?quorum=true", None),
    ("GET", "/v2/machines", None),
    ("GET", "/v2/stats/store", None),
]


def _drive_http(s) -> list:
    make = make_client_handler if isinstance(s, MultiGroupServer) \
        else jmake_handler
    httpd = serve(make(s, server_timeout=60.0), "127.0.0.1", 0)
    port = httpd.server_address[1]
    out = []
    try:
        for method, path, body in _SEQUENCE:
            data = None if body is None else body.encode()
            req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                         data=data, method=method)
            if data is not None:
                req.add_header("Content-Type",
                               "application/x-www-form-urlencoded")
            try:
                with urllib.request.urlopen(req, timeout=60) as resp:
                    status, hdr, raw = resp.status, resp.headers, \
                        resp.read()
            except urllib.error.HTTPError as e:
                status, hdr, raw = e.code, e.headers, e.read()
            out.append((method, path, status,
                        hdr.get("X-Etcd-Index"), raw))
    finally:
        httpd.shutdown()
    return out


def test_http_bodies_equal_across_packages(tmp_path):
    urls = ["http://127.0.0.1:4001"]
    js = JServer(str(tmp_path / "j"), g=G, m=M, cap=CAP,
                 tick_interval=0.02, client_urls=urls)
    ts = MultiGroupServer(str(tmp_path / "t"), g=G, m=M, cap=CAP,
                          tick_interval=0.02, client_urls=urls,
                          device="cpu")
    js.start()
    ts.start()
    try:
        got_j = _drive_http(js)
        got_t = _drive_http(ts)
    finally:
        js.stop()
        ts.stop()
    assert len(got_t) == len(got_j) == len(_SEQUENCE)
    for a, b in zip(got_t, got_j):
        assert a == b
    assert json.loads(got_t[1][4])["node"]["value"] == "1"
    assert any(st == 412 for _, _, st, _, _ in got_t)
    assert any(st == 201 for _, _, st, _, _ in got_t)


# -- _replay_wal_raw's lane against the reference's -------------------------

def _write_wal(d, n=60, payload=200):
    w = JWAL.create(str(d), b"\x08\x01")
    ents = [JEntry(index=i, term=1, data=bytes([i % 251]) * payload)
            for i in range(n)]
    w.save(JHardState(term=1, vote=0, commit=n - 1), ents)
    w.close()


@pytest.fixture
def policies(monkeypatch):
    """Fresh routers on both sides, with injected probes; the device
    threshold is lowered on both sides for the "above" cases."""
    monkeypatch.delenv("ETCD_REPLAY_BACKEND", raising=False)
    made = {}

    def make(min_bytes: int, device_fast: bool):
        bps = 4e9 if device_fast else 1e6
        probes = dict(
            probe_host=lambda: {"host_scan_bps": 1e8,
                                "host_frame_bps": 1e10},
            probe_device=lambda: {"h2d_bps": bps,
                                  "device_verify_bps": bps})
        jp = jpolicy.BackendPolicy(device_min_bytes=min_bytes, **probes)
        tp = tpolicy.BackendPolicy(device_min_bytes=min_bytes, **probes)
        jpolicy.set_policy(jp)
        tpolicy.set_policy(tp)
        monkeypatch.setattr(jserver, "_DEVICE_REPLAY_MIN_BYTES", min_bytes)
        monkeypatch.setattr(tserver, "DEVICE_MIN_BYTES", min_bytes)
        made["pols"] = (jp, tp)
        return jp, tp

    yield make
    jpolicy.set_policy(None)
    tpolicy.set_policy(None)


def _entries(out):
    if isinstance(out, list):
        return [(e.index, e.term, e.data) for e in out]
    return [(e.index, e.term, e.data) for e in out.entries()]


@pytest.mark.parametrize("backend", ["host", "tpu", "auto"])
@pytest.mark.parametrize("size", ["below", "above_device_wins",
                                  "above_host_wins"])
def test_replay_lane_equals_the_reference(tmp_path, policies, backend,
                                          size):
    _write_wal(tmp_path / "w")
    wal_bytes = sum(os.path.getsize(tmp_path / "w" / f)
                    for f in os.listdir(tmp_path / "w"))
    min_bytes = 8 << 20 if size == "below" else wal_bytes // 2
    jp, tp = policies(min_bytes, device_fast=size != "above_host_wins")
    shutil.copytree(tmp_path / "w", tmp_path / "j")
    shutil.copytree(tmp_path / "w", tmp_path / "t")
    wj, _, hj, oj = jserver._replay_wal_raw(str(tmp_path / "j"), 0,
                                            backend)
    wt, _, ht, ot = tserver._replay_wal_raw(str(tmp_path / "t"), 0,
                                            backend, device="cpu")
    wj.close()
    wt.close()
    assert jp.decisions.get("restart") == tp.decisions.get("restart")
    if backend == "host":
        assert "restart" not in tp.decisions
    assert type(ot).__name__ == type(oj).__name__
    assert isinstance(ot, EntryBlock) == (backend != "host")
    assert (ht.term, ht.commit) == (hj.term, hj.commit)
    assert _entries(ot) == _entries(oj)


def test_torn_tail_heals_under_tpu(tmp_path, policies):
    _write_wal(tmp_path / "w")
    seg = tmp_path / "w" / sorted(os.listdir(tmp_path / "w"))[-1]
    os.truncate(seg, os.path.getsize(seg) - 11)
    jp, tp = policies(8 << 20, device_fast=True)
    shutil.copytree(tmp_path / "w", tmp_path / "j")
    shutil.copytree(tmp_path / "w", tmp_path / "t")
    wj, _, _, oj = jserver._replay_wal_raw(str(tmp_path / "j"), 0, "tpu")
    wt, _, _, ot = tserver._replay_wal_raw(str(tmp_path / "t"), 0, "tpu",
                                           device="cpu")
    wj.close()
    wt.close()
    assert isinstance(ot, list) and isinstance(oj, list)
    assert _entries(ot) == _entries(oj)
    assert tp.decisions["restart"]["route"] == "host"
    assert "TornTailError" in tp.decisions["restart"]["why"]
    assert tp.decisions["restart"] == jp.decisions["restart"]


@pytest.mark.parametrize("backend", ["tpu", "auto"])
def test_failed_lane_raises_instead_of_falling_back(tmp_path, policies,
                                                    monkeypatch, backend):
    from etcd_tpu_torch.wal import replay_device

    _write_wal(tmp_path / "w")
    wal_bytes = sum(os.path.getsize(tmp_path / "w" / f)
                    for f in os.listdir(tmp_path / "w"))
    policies(wal_bytes // 2, device_fast=True)

    def broken(*a, **k):
        raise RuntimeError("raw_crc kernel failed")

    monkeypatch.setattr(replay_device, "open_replay_device", broken)
    with pytest.raises(RuntimeError, match="raw_crc kernel failed"):
        tserver._replay_wal_raw(str(tmp_path / "w"), 0, backend,
                                device="cpu")
