"""The port's distributed multi-group server (etcd_tpu_torch, engines on
the CPU): 3 hosts on localhost HTTP, real frames over real sockets.

Scenarios of tests/test_distserver.py on port clusters: a write commits
and replicates, a follower forwards, the cluster survives one host down,
a restarted host catches up from its WAL, a host past the leader's
compaction pulls a snapshot (and keeps it across its next restart), a
leader failover elects, a ballot survives
a crash image (no double vote), and a partition cannot ack a write and
heals.  A snapshot taken while a follower holds appended but unapplied
entries keeps them across its restart.  Across the packages: the /v2 HTTP
bodies of a port cluster equal a reference cluster's for the same
request sequence; a mixed cluster (two JAX-package hosts, one port host,
in one process) commits under a leader from either package; a data dir
crosses between the packages both ways.  Last, three
``etcd_tpu_torch.scripts.dist_node`` processes: SIGKILL one, the rest
commit, the restarted one catches up from its own WAL.

Every wait has its own deadline.
"""

import json
import os
import shutil
import signal
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from etcd_tpu.utils.errors import EtcdError as JEtcdError

from etcd_tpu_torch.scripts import dist_bench
from etcd_tpu_torch.server.distserver import DistServer
from etcd_tpu_torch.utils.errors import EtcdError
from etcd_tpu_torch.wire.requests import Request

G = 8
_NEXT_ID = [1 << 30]
_DEAD_URL = "http://127.0.0.1:1"  # nothing listens: instant refusal


def rid() -> int:
    _NEXT_ID[0] += 1
    return _NEXT_ID[0]


def make_cluster(tmp_path, m=3, g=G, **kw):
    kw.setdefault("device", "cpu")
    return dist_bench.make_dist_cluster(tmp_path, m=m, g=g, **kw)


def put(srv, key, val, timeout=15.0):
    return srv.do(Request(method="PUT", id=rid(), path=key, val=val),
                  timeout=timeout)


def get(srv, key):
    # serializable: what THIS host's replica holds
    return srv.do(Request(method="GET", id=rid(), path=key,
                          serializable=True))


def wait_for(pred, timeout=30.0, msg="condition"):
    t0 = time.time()
    while time.time() - t0 < timeout:
        try:
            if pred():
                return
        except (EtcdError, JEtcdError, TimeoutError):
            pass  # not replicated / no leader yet
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


def stop_all(servers):
    for s in servers:
        try:
            s.stop()
        except Exception:
            pass


@pytest.fixture
def cluster(tmp_path):
    servers, ports = make_cluster(tmp_path)
    dist_bench.bootstrap_dist_leader(servers)
    yield servers, ports, tmp_path
    stop_all(servers)


def _urls(ports):
    return [f"http://127.0.0.1:{p}" for p in ports]


def _restart(tmp_path, slot, ports, **kw):
    return DistServer(str(tmp_path / f"d{slot}"), slot=slot,
                      peer_urls=_urls(ports), g=G, cap=64,
                      tick_interval=0.05, post_timeout=2.0,
                      election=60, device="cpu", **kw)


def test_write_commits_and_replicates(cluster):
    servers, _, _ = cluster
    assert put(servers[0], "/foo", "bar").event.node.value == "bar"
    wait_for(lambda: all(get(s, "/foo").event.node.value == "bar"
                         for s in servers[1:]), msg="replication")


def test_follower_forwards_writes(cluster):
    servers, _, _ = cluster
    wait_for(lambda: (servers[1].mr.leader_hint() == 0).all(),
             msg="leader hint propagation")
    assert put(servers[1], "/fwd", "v1").event.node.value == "v1"
    wait_for(lambda: get(servers[0], "/fwd").event.node.value == "v1",
             msg="forwarded write on the leader")


def test_survives_one_host_down(cluster):
    servers, _, _ = cluster
    put(servers[0], "/a", "1")
    servers[2].stop()
    assert put(servers[0], "/a", "2", timeout=15.0).event.node.value == "2"
    wait_for(lambda: get(servers[1], "/a").event.node.value == "2",
             msg="replication with one host down")


def test_restart_catches_up_from_wal(cluster):
    servers, ports, tmp_path = cluster
    for i in range(5):
        put(servers[0], f"/k{i}", f"v{i}")
    wait_for(lambda: get(servers[1], "/k4").event.node.value == "v4",
             msg="pre-stop replication")
    servers[1].stop()
    for i in range(5, 10):
        put(servers[0], f"/k{i}", f"v{i}", timeout=15.0)
    s1 = _restart(tmp_path, 1, ports, storage_backend="tpu")
    assert get(s1, "/k0").event.node.value == "v0"
    s1.start()
    servers[1] = s1
    wait_for(lambda: all(get(s1, f"/k{i}").event.node.value == f"v{i}"
                         for i in range(10)), msg="restarted catch-up")


def test_snapshot_pull_past_compaction(cluster):
    servers, ports, tmp_path = cluster
    put(servers[0], "/base", "x")
    servers[2].stop()
    for i in range(30):
        put(servers[0], f"/s{i}", f"v{i}", timeout=15.0)
    servers[0].snapshot()
    s2 = _restart(tmp_path, 2, ports)
    s2.start()
    servers[2] = s2
    wait_for(lambda: all(get(s2, f"/s{i}").event.node.value == f"v{i}"
                         for i in range(30)), timeout=40.0,
             msg="snapshot pull catch-up")
    # the installed snapshot is this host's own now: a second restart
    # reads every key back before any peer speaks to it
    s2.stop()
    s2 = _restart(tmp_path, 2, ports)
    servers[2] = s2
    assert [get(s2, f"/s{i}").event.node.value for i in range(30)] == \
        [f"v{i}" for i in range(30)]


def test_leader_failover_elects_new_leader(cluster):
    servers, _, _ = cluster
    put(servers[0], "/f", "1")
    wait_for(lambda: all(get(s, "/f").event.node.value == "1"
                         for s in servers), msg="initial replication")
    servers[0].stop()
    wait_for(lambda: (servers[1].mr.is_leader()
                      | servers[2].mr.is_leader()).all(),
             timeout=40.0, msg="failover election")
    new_lead = servers[1] if servers[1].mr.is_leader().any() \
        else servers[2]
    assert put(new_lead, "/f", "2", timeout=20.0).event.node.value == "2"


def test_ballot_survives_restart_no_double_vote(tmp_path):
    from etcd_tpu_torch.wire.distmsg import VoteReq, unmarshal_any

    urls = _urls(dist_bench.free_ports(3))
    s = DistServer(str(tmp_path / "d0"), slot=0, peer_urls=urls, g=4,
                   cap=64, election=60, device="cpu")
    term5 = np.full(4, 5, np.int32)
    req_a = VoteReq(sender=1, term=term5, last=np.zeros(4, np.int32),
                    lterm=np.zeros(4, np.int32), active=np.ones(4, bool))
    assert unmarshal_any(s.handle_frame(req_a.marshal())).granted.all()
    shutil.copytree(str(tmp_path / "d0"), str(tmp_path / "crash"))
    s.stop()
    s2 = DistServer(str(tmp_path / "crash"), slot=0, peer_urls=urls,
                    g=4, cap=64, election=60, device="cpu")
    assert (s2.mr.terms() == 5).all()
    assert (s2.mr.state.vote.numpy() == 1).all()
    req_b = VoteReq(sender=2, term=term5,
                    last=np.full(4, 9, np.int32),
                    lterm=np.full(4, 9, np.int32), active=np.ones(4, bool))
    assert not unmarshal_any(s2.handle_frame(req_b.marshal())).granted.any()
    assert unmarshal_any(s2.handle_frame(req_a.marshal())).granted.all()
    s2.stop()


def _cut(servers, isolated):
    originals = [list(s.peer_urls) for s in servers]
    for i, s in enumerate(servers):
        for j in range(len(s.peer_urls)):
            if i != j and (i == isolated or j == isolated):
                s.peer_urls[j] = _DEAD_URL
    return originals


def test_partition_no_split_brain_then_heal_converges(cluster):
    servers, _, _ = cluster
    put(servers[0], "/p", "committed")
    wait_for(lambda: all(get(s, "/p").event.node.value == "committed"
                         for s in servers[1:]), msg="pre-partition")
    originals = _cut(servers, isolated=0)
    try:
        with pytest.raises((TimeoutError, EtcdError)):
            put(servers[0], "/p", "stale", timeout=3.0)
        assert get(servers[1], "/p").event.node.value == "committed"
        wait_for(lambda: (servers[1].mr.is_leader()
                          | servers[2].mr.is_leader()).all(),
                 timeout=40.0, msg="majority election")
        new_lead = servers[1] if servers[1].mr.is_leader().any() \
            else servers[2]
        wait_for(lambda: put(new_lead, "/maj", "2", timeout=5.0)
                 .event.node.value == "2", timeout=30.0,
                 msg="majority-side write")
    finally:
        for s, urls in zip(servers, originals):
            s.peer_urls[:] = urls
    wait_for(lambda: put(new_lead, "/p", "new", timeout=5.0)
             .event.node.value == "new", timeout=30.0,
             msg="post-heal write")
    wait_for(lambda: all(get(s, "/p").event.node.value == "new"
                         and get(s, "/maj").event.node.value == "2"
                         for s in servers), timeout=30.0,
             msg="post-heal convergence")


def test_snapshot_with_unapplied_tail_keeps_it_across_restart(cluster):
    """A follower snapshots while it holds an appended entry its
    commit has not reached; after the entry commits and the follower
    restarts, the entry reads back (its WAL replay starts before the
    entry's record, not at the snapshot's own seq)."""
    servers, ports, tmp_path = cluster
    fol = servers[1]
    put(servers[0], "/t0", "a")
    wait_for(lambda: get(fol, "/t0").event.node.value == "a",
             msg="replication")
    with fol.lock:
        # hold the follower's apply: its frames still append + ack
        real_apply = fol._apply_committed
        fol._apply_committed = lambda assigned=None: None
    try:
        put(servers[0], "/t1", "b")
        gi = fol._group_of_request(Request(method="PUT", path="/t1"))
        wait_for(lambda: len(fol._tail_seqs[gi]) > 0,
                 msg="the follower appends the entry")
        fol.snapshot()
    finally:
        fol._apply_committed = real_apply
    wait_for(lambda: get(fol, "/t1").event.node.value == "b",
             msg="follower applies the tail")
    fol.stop()
    s1 = _restart(tmp_path, 1, ports)
    assert get(s1, "/t1").event.node.value == "b"
    assert get(s1, "/t0").event.node.value == "a"
    s1.start()
    servers[1] = s1


# -- across the packages ------------------------------------------------------


def _jax_cluster(tmp_path, m=3, g=G, ports=None, slots=None,
                 election=60):
    from etcd_tpu.server.distserver import DistServer as JDistServer

    ports = ports or dist_bench.free_ports(m)
    out = []
    for s in (range(m) if slots is None else slots):
        srv = JDistServer(str(tmp_path / f"d{s}"), slot=s,
                          peer_urls=_urls(ports), g=g, cap=64,
                          tick_interval=0.05, post_timeout=2.0,
                          election=election)
        srv.start()
        out.append(srv)
    return out, ports


def _http(port, method, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body, method=method,
        headers={"Content-Type": "application/x-www-form-urlencoded"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


SEQUENCE = [
    ("PUT", "/v2/keys/app/a", b"value=1"),
    ("GET", "/v2/keys/app/a", None),
    ("PUT", "/v2/keys/app/a?prevValue=1", b"value=2"),
    ("PUT", "/v2/keys/app/a?prevValue=9", b"value=3"),
    ("PUT", "/v2/keys/app/b?prevExist=false", b"value=x"),
    ("PUT", "/v2/keys/app/b?prevExist=false", b"value=y"),
    ("GET", "/v2/keys/app?recursive=true&sorted=true", None),
    ("DELETE", "/v2/keys/app/a", None),
    ("GET", "/v2/keys/app/a", None),
    ("PUT", "/v2/keys/dir?dir=true", b""),
    ("GET", "/v2/keys/dir", None),
]


def _run_sequence(servers, make_handler, serve):
    """The request sequence against host 0, which leads every group
    throughout (a forwarded write's error body is the leader's
    re-read, a different body)."""
    dist_bench.bootstrap_dist_leader(servers)
    wait_for(lambda: all(len(s.cluster_store.get()) == 3
                         for s in servers), timeout=40.0,
             msg="registry publish")
    dist_bench.bootstrap_dist_leader(servers)
    terms = servers[0].mr.terms().copy()
    # store indices relative to the sequence's start: how many
    # registry writes the publish loop retried is timing, not
    # semantics; start once the index has held still for 2 s
    seen = [servers[0].store.index(), time.time()]

    def settled():
        now = servers[0].store.index()
        if now != seen[0]:
            seen[:] = [now, time.time()]
        return time.time() - seen[1] > 2.0

    wait_for(settled, timeout=40.0, msg="the registry writes settle")
    base = servers[0].store.index()
    h = serve(make_handler(servers[0], server_timeout=30.0),
              "127.0.0.1", 0)
    try:
        out = [_http(h.server_address[1], m, p, b)
               for m, p, b in SEQUENCE]
    finally:
        h.shutdown()
    assert servers[0].mr.is_leader().all()
    assert (servers[0].mr.terms() == terms).all()

    def rebase(x):
        if isinstance(x, dict):
            return {k: (v - base if k in ("modifiedIndex", "createdIndex",
                                          "index") and isinstance(v, int)
                        else rebase(v)) for k, v in x.items()}
        if isinstance(x, list):
            return [rebase(v) for v in x]
        return x

    return [(code, rebase(body)) for code, body in out]


def test_v2_http_bodies_equal_to_reference_cluster(tmp_path):
    from etcd_tpu.api.http import make_client_handler as jhandler
    from etcd_tpu.api.http import serve as jserve

    from etcd_tpu_torch.api.http import make_client_handler, serve

    # elections only where the test asks for them (bootstrap)
    jservers, _ = _jax_cluster(tmp_path / "ref", election=400)
    try:
        want = _run_sequence(jservers, jhandler, jserve)
    finally:
        stop_all(jservers)
    servers, _ = make_cluster(tmp_path / "port", election=400)
    try:
        got = _run_sequence(servers, make_client_handler, serve)
    finally:
        stop_all(servers)
    for g_, w_ in zip(got, want):
        for body in (g_[1], w_[1]):
            for node in [body.get("node") or {}, body.get("prevNode") or {}]:
                node.pop("expiration", None)
    assert [g[0] for g in got] == [w[0] for w in want]
    assert got == want


def test_mixed_cluster_commits_under_either_leader(tmp_path):
    """Slots 0 and 1 are JAX-package hosts, slot 2 a port host: writes
    commit under the JAX leader, then under the port leader, and every
    host reads every key back."""
    ports = dist_bench.free_ports(3)
    jservers, _ = _jax_cluster(tmp_path, ports=ports, slots=(0, 1))
    port_srv = DistServer(str(tmp_path / "d2"), slot=2,
                          peer_urls=_urls(ports), g=G, cap=64,
                          tick_interval=0.05, post_timeout=2.0,
                          election=60, device="cpu")
    port_srv.start()
    servers = [*jservers, port_srv]
    try:
        dist_bench.bootstrap_dist_leader(servers)
        for i in range(4):
            put(servers[0], f"/jax{i}", f"j{i}")
        dist_bench.bootstrap_dist_leader([port_srv], timeout=40.0)
        for i in range(4):
            wait_for(lambda: put(port_srv, f"/port{i}", f"p{i}",
                                 timeout=5.0).event.node.value == f"p{i}",
                     timeout=30.0, msg="write under the port leader")
        keys = {**{f"/jax{i}": f"j{i}" for i in range(4)},
                **{f"/port{i}": f"p{i}" for i in range(4)}}
        wait_for(lambda: all(get(s, k).event.node.value == v
                             for s in servers for k, v in keys.items()),
                 msg="every key on every host")
    finally:
        stop_all(servers)


def test_data_dir_crosses_between_packages(tmp_path):
    """Port hosts write; the same dirs restart as JAX-package hosts,
    which elect, read everything and write more; they restart as port
    hosts, which read every key.  (A restarted host applies its WAL's
    tail once a leader of the new term commits: every phase writes one
    key before it reads.)"""
    def phase(servers, writes, keys):
        dist_bench.bootstrap_dist_leader(servers, timeout=40.0)
        for k in writes:
            wait_for(lambda: put(servers[0], k, k, timeout=5.0)
                     .event.node.value == k, timeout=30.0,
                     msg=f"write {k}")
        wait_for(lambda: all(get(s, k).event.node.value == k
                             for s in servers for k in keys),
                 timeout=30.0, msg="every key on every host")

    servers, ports = make_cluster(tmp_path)
    port_keys = [f"/a{i}" for i in range(4)]
    jax_keys = [f"/b{i}" for i in range(4)]
    try:
        phase(servers, port_keys, port_keys)
    finally:
        stop_all(servers)
    jservers, _ = _jax_cluster(tmp_path, ports=ports)
    try:
        phase(jservers, jax_keys, port_keys + jax_keys)
    finally:
        stop_all(jservers)
    servers = [_restart(tmp_path, s, ports, storage_backend="tpu")
               for s in range(3)]
    for s in servers:
        s.start()
    try:
        phase(servers, ["/c0"], port_keys + jax_keys + ["/c0"])
    finally:
        stop_all(servers)


# -- three node processes -----------------------------------------------------


def _propose(url, key, val, timeout=20.0):
    r = Request(method="PUT", id=rid(), path=key, val=val)
    req = urllib.request.Request(url + "/mraft/propose", data=r.marshal(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        d = json.loads(resp.read().decode())
    assert d.get("ok"), d
    return d


def test_kill9_and_restart_catchup(tmp_path):
    tmp = str(tmp_path)
    urls = _urls(dist_bench.free_ports(3))
    env = {"ETCD_TORCH_DEVICE": "cpu", "OMP_NUM_THREADS": "1"}
    procs = [dist_bench.spawn_node(tmp, s, urls, groups=4,
                                   bootstrap=(s == 0), env_extra=env)
             for s in range(3)]
    try:
        infos = [dist_bench.wait_ready(procs[s], timeout=120.0)
                 for s in (1, 2, 0)]
        assert all(i["fresh"] and i["device"] == "cpu" for i in infos)
        for i in range(3):
            _propose(urls[0], f"/pre{i}", f"v{i}")
        procs[2].send_signal(signal.SIGKILL)
        procs[2].wait(timeout=30)
        for i in range(3):
            _propose(urls[0], f"/during{i}", f"v{i}")
        procs[2] = dist_bench.spawn_node(tmp, 2, urls, groups=4,
                                         backend="tpu", env_extra=env)
        info = dist_bench.wait_ready(procs[2], timeout=120.0)
        assert not info["fresh"] and info["lane"] == "stream"
        assert info["raw_crc_launches"] == 0  # the CPU: plain version
        want = [f"/pre{i}" for i in range(3)] + \
            [f"/during{i}" for i in range(3)]
        def caught_up():
            vals = dist_bench.store_values(urls[2])
            return [vals.get(k) for k in want] == ["v0", "v1", "v2"] * 2

        wait_for(caught_up, timeout=60.0, msg="restarted node catch-up")
        _propose(urls[0], "/post", "x")
    finally:
        dist_bench.stop_nodes(procs)
    assert os.path.exists(os.path.join(tmp, "node2.log"))
