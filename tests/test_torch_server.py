"""The port's classic single-group server (``etcd_tpu_torch.server``:
``EtcdServer``, ``new_server``, ``WalSnapStorage``, the sender, the
cluster) and its HTTP API (``etcd_tpu_torch.api.http``: client and peer
handlers, /metrics) against the JAX package's, on the CPU.

- Every scenario of ``tests/test_server.py`` (14),
  ``test_server_recorders.py`` (6), ``test_cluster_unit.py`` (7) and
  ``test_http.py`` (40) runs against the port (reference modules
  executed with their imports pointed at ``etcd_tpu_torch``;
  ``new_server`` is passed ``device="cpu"``).
- A classic data dir written by either package (a snapshot, entries
  after it, a conf change) restarts in both with equal store bytes, hard
  state, log and snapshot; the port restarts it under every backend with
  ``device="cpu"``, naming the reference's lane, the ``tpu`` and ``auto``
  restarts running the raw CRC (its plain torch version on the CPU)
  and ``host`` never; a torn tail heals under ``tpu``; a failed lane
  raises; without CUDA and without ``device="cpu"`` ``new_server``
  raises before touching the disk.
- The same request sequence through each package's client handler
  gives equal status codes, headers and bodies; /raft takes the other
  package's message bytes; ``/metrics`` renders the same text for the
  same registry operations.

Tolerance: exact.
"""

from __future__ import annotations

import functools
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

from etcd_tpu.api.http import make_client_handler as jmake_client
from etcd_tpu.obs import exporter as jexporter
from etcd_tpu.obs import metrics as jmetrics
from etcd_tpu.server import server as jserver
from etcd_tpu.server.cluster import Cluster as JCluster
from etcd_tpu.server.config import ServerConfig as JConfig
from etcd_tpu.wal import backend_policy as jpolicy
from etcd_tpu.wire.requests import Request as JRequest

from etcd_tpu_torch.api.http import (
    make_client_handler,
    make_peer_handler,
    serve,
)
from etcd_tpu_torch.obs import exporter as texporter
from etcd_tpu_torch.obs import metrics as tmetrics
from etcd_tpu_torch.server import server as tserver
from etcd_tpu_torch.server.cluster import Cluster
from etcd_tpu_torch.server.config import ServerConfig
from etcd_tpu_torch.wal import backend_policy as tpolicy
from etcd_tpu_torch.wal import replay_device
from etcd_tpu_torch.wire import MSG_APP as TMSG_APP
from etcd_tpu_torch.wire.requests import Request

from test_torch_obs_plane import stats_shape
from test_torch_raft_core import export, port_module

_cpu = {"new_server": lambda f: functools.partial(f, device="cpu")}

# -- every reference scenario, on the port ------------------------------------

assert export(port_module("test_server", _cpu), "server", globals()) == 14
assert export(port_module("test_server_recorders"), "recorders",
              globals()) == 6
assert export(port_module("test_cluster_unit"), "cluster", globals()) == 7
assert export(port_module("test_http"), "http", globals()) == 40


# -- classic data dirs cross between the packages -----------------------------

SOLO = "solo=http://127.0.0.1:7001"


def _cfg(cls_cfg, cls_cluster, d, backend="auto"):
    c = cls_cluster()
    c.set_from_string(SOLO)
    return cls_cfg(name="solo", data_dir=str(d), cluster=c,
                   client_urls=["http://127.0.0.1:4001"], snap_count=8,
                   storage_backend=backend)


def _wait_leader(s, timeout=10.0):
    deadline = time.time() + timeout
    while s.node.r.state != 2:
        assert time.time() < deadline, "no leader"
        time.sleep(0.01)


def _write_dir(pkg: str, d) -> None:
    """Serve 20 writes (snapshots at snap_count 8 among them) and a
    DELETE through ``pkg``'s classic server, then stop."""
    if pkg == "jax":
        s = jserver.new_server(_cfg(JConfig, JCluster, d, "host"))
        req = JRequest
    else:
        s = tserver.new_server(_cfg(ServerConfig, Cluster, d, "host"),
                               device="cpu")
        req = Request
    s.tick_interval = 0.01
    s._start()
    try:
        _wait_leader(s)
        for i in range(20):
            s.do(req(id=9000 + i, method="PUT", path=f"/d{i % 3}/k{i}",
                     val=f"v{i}" * 30), timeout=10)
        s.do(req(id=9100, method="DELETE", path="/d0/k0"), timeout=10)
    finally:
        s.stop()
        s.storage.wal.close()


def _view(s) -> dict:
    lg = s.node.r.raft_log
    return {"store": s.store.save(), "hard": s.node.r.hard_state().marshal(),
            "last": (lg.last_index(), lg.term(lg.last_index())),
            "ents": [e.marshal() for e in lg.ents],
            "snap": lg.snapshot.marshal(), "committed": lg.committed,
            "id": s.id}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_data_dir_restarts_in_the_other_package(tmp_path, writer):
    _write_dir(writer, tmp_path / "src")
    assert os.listdir(tmp_path / "src" / "snap")
    shutil.copytree(tmp_path / "src", tmp_path / "j")
    views = {}
    js = jserver.new_server(_cfg(JConfig, JCluster, tmp_path / "j"))
    views["jax"] = _view(js)
    js.storage.wal.close()
    for b in ("host", "tpu", "auto"):
        shutil.copytree(tmp_path / "src", tmp_path / b)
        ts = tserver.new_server(_cfg(ServerConfig, Cluster, tmp_path / b, b),
                                device="cpu")
        views[b] = _view(ts)
        ts.storage.wal.close()
        ts.store.fanout.close()
    js.store.fanout.close()
    assert views["jax"]["last"][0] > 20
    for b in ("host", "tpu", "auto"):
        assert views[b] == views["jax"], b
    # the replayed store holds every write but the deleted one
    st = json.loads(views["jax"]["store"])
    assert st


@pytest.fixture
def policies(monkeypatch):
    """Fresh routers on both sides with injected probes; ``min_bytes``
    is the device threshold on both sides."""
    monkeypatch.delenv("ETCD_REPLAY_BACKEND", raising=False)

    def make(min_bytes: int, device_fast: bool = True):
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
        return jp, tp

    yield make
    jpolicy.set_policy(None)
    tpolicy.set_policy(None)


@pytest.fixture
def crc_calls(monkeypatch):
    """Count the replay lanes' raw-CRC calls (on the CPU: the plain
    torch version; on a card the kernel)."""
    calls = []
    real = replay_device.raw_crc_batch

    def counted(buf):
        calls.append(tuple(buf.shape))
        return real(buf)

    monkeypatch.setattr(replay_device, "raw_crc_batch", counted)
    return calls


@pytest.mark.parametrize("backend", ["host", "tpu", "auto"])
@pytest.mark.parametrize("size", ["below", "above"])
def test_restart_lane_and_raw_crc_per_backend(tmp_path, policies, crc_calls,
                                              backend, size):
    _write_dir("jax", tmp_path / "src")
    wal = tmp_path / "src" / "wal"
    wal_bytes = sum(os.path.getsize(wal / f) for f in os.listdir(wal))
    jp, tp = policies(8 << 20 if size == "below" else wal_bytes // 2)
    shutil.copytree(tmp_path / "src", tmp_path / "j")
    shutil.copytree(tmp_path / "src", tmp_path / "t")
    js = jserver.new_server(_cfg(JConfig, JCluster, tmp_path / "j", backend))
    ts = tserver.new_server(_cfg(ServerConfig, Cluster, tmp_path / "t",
                                 backend), device="cpu")
    try:
        assert _view(ts) == _view(js)
        assert tp.decisions.get("restart") == jp.decisions.get("restart")
        route = (tp.decisions.get("restart") or {}).get("route", "host")
        if backend == "host":
            assert "restart" not in tp.decisions and not crc_calls
        elif backend == "tpu":
            assert route == "stream" and crc_calls
        else:
            assert bool(crc_calls) == (route in ("device", "stream"))
    finally:
        for s in (js, ts):
            s.storage.wal.close()
            s.store.fanout.close()


def test_torn_tail_heals_under_tpu(tmp_path, policies):
    _write_dir("port", tmp_path / "src")
    wal = tmp_path / "src" / "wal"
    seg = wal / sorted(os.listdir(wal))[-1]
    os.truncate(seg, os.path.getsize(seg) - 7)
    jp, tp = policies(8 << 20)
    shutil.copytree(tmp_path / "src", tmp_path / "j")
    shutil.copytree(tmp_path / "src", tmp_path / "t")
    js = jserver.new_server(_cfg(JConfig, JCluster, tmp_path / "j", "tpu"))
    ts = tserver.new_server(_cfg(ServerConfig, Cluster, tmp_path / "t",
                                 "tpu"), device="cpu")
    try:
        assert _view(ts) == _view(js)
        assert tp.decisions["restart"]["route"] == "host"
        assert "TornTailError" in tp.decisions["restart"]["why"]
        assert tp.decisions["restart"] == jp.decisions["restart"]
    finally:
        for s in (js, ts):
            s.storage.wal.close()
            s.store.fanout.close()


@pytest.mark.parametrize("backend", ["tpu", "auto"])
def test_failed_lane_raises_instead_of_falling_back(tmp_path, policies,
                                                    monkeypatch, backend):
    _write_dir("port", tmp_path / "d")
    wal = tmp_path / "d" / "wal"
    policies(sum(os.path.getsize(wal / f) for f in os.listdir(wal)) // 2)

    def broken(*a, **k):
        raise RuntimeError("raw_crc kernel failed")

    monkeypatch.setattr(replay_device, "open_replay_device", broken)
    with pytest.raises(RuntimeError, match="raw_crc kernel failed"):
        tserver.new_server(_cfg(ServerConfig, Cluster, tmp_path / "d",
                                backend), device="cpu")


def test_new_server_raises_without_cuda_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserver.new_server(_cfg(ServerConfig, Cluster, tmp_path / "d"))
    assert not (tmp_path / "d").exists()


def test_snapshot_hash_runs_on_the_named_device(tmp_path, monkeypatch):
    """The snapshotter's ``crc_fn`` is ``auto_crc32c`` on the server's
    device for every backend but ``host``."""
    from etcd_tpu_torch.ops import crc_kernel

    for b, want in (("host", None), ("tpu", "cpu"), ("auto", "cpu")):
        s = tserver.new_server(_cfg(ServerConfig, Cluster, tmp_path / b, b),
                               device="cpu")
        fn = s.storage.snapshotter.crc_fn
        if want is None:
            assert not isinstance(fn, functools.partial)
        else:
            assert fn.func is crc_kernel.auto_crc32c
            assert str(fn.keywords["device"]) == want
        s.storage.wal.close()
        s.store.fanout.close()


def test_new_server_makes_the_devices_first_use_at_start(tmp_path,
                                                         monkeypatch):
    """Every backend but ``host`` warms the server's device in
    ``new_server`` (not under the apply loop at the first snapshot),
    before touching the disk: a device that fails there raises and
    leaves no data dir."""
    from etcd_tpu_torch.ops import crc_kernel

    warmed = []
    monkeypatch.setattr(crc_kernel, "warm_device",
                        lambda device=None: warmed.append(str(device)))
    for b in ("host", "tpu", "auto"):
        s = tserver.new_server(_cfg(ServerConfig, Cluster, tmp_path / b, b),
                               device="cpu")
        s.storage.wal.close()
        s.store.fanout.close()
    assert warmed == ["cpu", "cpu"]

    def fail(device=None):
        raise RuntimeError("device lost")

    monkeypatch.setattr(crc_kernel, "warm_device", fail)
    with pytest.raises(RuntimeError, match="device lost"):
        tserver.new_server(_cfg(ServerConfig, Cluster, tmp_path / "x"),
                           device="cpu")
    assert not (tmp_path / "x").exists()


def test_warm_device_hashes_one_chunk_on_the_named_device(monkeypatch):
    from etcd_tpu_torch.ops import crc_kernel

    seen = []
    real = crc_kernel.device_crc32c

    def spy(data, chunk=crc_kernel.CHUNK, device=None):
        seen.append((len(data), str(device)))
        return real(data, chunk=chunk, device=device)

    monkeypatch.setattr(crc_kernel, "device_crc32c", spy)
    crc_kernel.warm_device("cpu")
    assert seen == [(crc_kernel.CHUNK, "cpu")]


# -- the same requests through both packages' handlers ------------------------

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
    ("GET", "/v2/stats/spans", None),
    ("GET", "/v2/stats/slo", None),
    ("GET", "/v2/stats/nope", None),
    ("PATCH", "/v2/keys/a/x", None),
]


def _drive(s, make) -> list:
    httpd = serve(make(s, server_timeout=10.0), "127.0.0.1", 0)
    out = []
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        for method, path, body in _SEQUENCE:
            data = None if body is None else body.encode()
            req = urllib.request.Request(base + path, data=data,
                                         method=method)
            if data is not None:
                req.add_header("Content-Type",
                               "application/x-www-form-urlencoded")
            try:
                with urllib.request.urlopen(req, timeout=10) as resp:
                    status, hdr, raw = resp.status, resp.headers, resp.read()
            except urllib.error.HTTPError as e:
                status, hdr, raw = e.code, e.headers, e.read()
            keep = {k: v for k, v in hdr.items()
                    if k not in ("Date", "Server")}
            out.append((method, path, status, keep, raw))
    finally:
        httpd.shutdown()
    return out


def test_http_answers_equal_across_packages(tmp_path):
    got = {}
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        if pkg == "jax":
            s = jserver.new_server(_cfg(JConfig, JCluster, d))
            make = jmake_client
        else:
            s = tserver.new_server(_cfg(ServerConfig, Cluster, d),
                                   device="cpu")
            make = make_client_handler
        s.tick_interval = 0.01
        s.start()
        try:
            _wait_leader(s)
            # publish's attributes write lands first on both sides
            deadline = time.time() + 10
            while not s.cluster_store.get().client_urls_all():
                assert time.time() < deadline
                time.sleep(0.01)
            got[pkg] = _drive(s, make)
        finally:
            s.stop()
            s.storage.wal.close()
    assert len(got["port"]) == len(_SEQUENCE)
    for a, b in zip(got["port"], got["jax"]):
        assert a[:3] == b[:3], a[:3]
        if a[1] == "/v2/stats/slo":
            # the verdict's time and the ring's content differ run to
            # run; its shape and every declared objective agree
            drop = ("Content-Length",)
            assert {k: v for k, v in a[3].items() if k not in drop} \
                == {k: v for k, v in b[3].items() if k not in drop}
            assert stats_shape(a[1], a[4]) == stats_shape(b[1], b[4])
            continue
        if a[1] in ("/v2/stats/store", "/v2/stats/spans"):
            # counters and span times differ run to run; the names agree
            assert set(json.loads(a[4])) == set(json.loads(b[4])), a[1]
            continue
        assert a == b


def test_peer_handler_takes_the_other_packages_message_bytes():
    """/raft: a message marshaled by the JAX package steps the port's
    node; garbage answers 400 and GET 405, as in the reference."""
    from etcd_tpu.wire import Message as JMessage

    got = []

    class Sink:
        def process(self, m):
            got.append(m)

    httpd = serve(make_peer_handler(Sink()), "127.0.0.1", 0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}/raft"
    try:
        raw = JMessage(type=3, to=2, from_=1, term=4, log_term=3, index=9,
                       commit=8).marshal()
        req = urllib.request.Request(base, data=raw, method="POST")
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 204
        assert len(got) == 1 and got[0].type == TMSG_APP
        assert got[0].marshal() == raw
        for method, data, code in (("POST", b"\x00\x01", 400),
                                   ("GET", None, 405)):
            req = urllib.request.Request(base, data=data, method=method)
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=10)
            assert e.value.code == code
    finally:
        httpd.shutdown()


# -- /metrics -----------------------------------------------------------------


#: the port's own family: device->host reads of the card's state
PORT_ONLY = {"etcd_devledger_fetches_total"}


def test_catalog_equals_the_reference():
    """Every family, kind, label set, bucket boundary and window equals
    the reference's (the help texts are each package's own words), and
    the port adds one family of its own."""
    assert set(tmetrics.CATALOG) == set(jmetrics.CATALOG) | PORT_ONLY
    for name, d in jmetrics.CATALOG.items():
        t = tmetrics.CATALOG[name]
        assert (t.kind, t.labels, t.buckets, t.window) == \
            (d.kind, d.labels, d.buckets, d.window), name


def _ops(reg, rng_seed: int) -> None:
    rng = np.random.default_rng(rng_seed)
    reg.counter("etcd_wal_cuts_total").inc()
    reg.counter("etcd_admission_total", outcome="shed_write",
                reason="tenant_rate").inc(3)
    reg.gauge("etcd_tenant_inflight", tenant='a"b\\c\nd').set(2.5)
    reg.gauge("etcd_conns_open").set(7)
    reg.counter("etcd_devledger_fetches_total", stage="s").inc(4)
    for v in rng.exponential(0.01, 500):
        reg.histogram("etcd_wal_fsync_seconds").observe(float(v))
    for v in rng.integers(1, 5000, 300):
        reg.histogram("etcd_apply_batch_entries").observe(int(v))
    reg.histogram("etcd_peer_send_seconds", path="classic").observe(1e-9)
    reg.histogram("etcd_peer_send_seconds", path="classic").observe(99.0)
    reg.histogram("etcd_span_seconds", span="x").observe(float("inf"))


def test_metrics_text_equals_the_reference_byte_for_byte():
    """The same registry operations render the same /metrics text.  The
    reference registry is built over the port's help texts, so every
    byte of the exposition is compared."""
    import dataclasses

    cat = {n: dataclasses.replace(d, help=tmetrics.CATALOG[n].help)
           for n, d in jmetrics.CATALOG.items()}
    for n in PORT_ONLY:
        d = tmetrics.CATALOG[n]
        cat[n] = jmetrics.MetricDef(d.name, d.kind, d.help, d.labels,
                                    d.buckets, d.window)
    jreg, treg = jmetrics.Registry(cat), tmetrics.Registry()
    assert texporter.render_prometheus(treg) == \
        jexporter.render_prometheus(jreg)
    _ops(jreg, 3)
    _ops(treg, 3)
    text = texporter.render_prometheus(treg)
    assert text == jexporter.render_prometheus(jreg)
    assert b'etcd_admission_total{outcome="shed_write",reason="tenant_rate"} 3' \
        in text
    assert treg.snapshot() == jreg.snapshot()
    snap = json.loads(treg.snapshot_json())
    assert texporter.render_prometheus_snapshot(snap) == \
        jexporter.render_prometheus_snapshot(snap)
    h = treg.histogram("etcd_wal_fsync_seconds")
    assert h.percentile(0.99) == jreg.histogram(
        "etcd_wal_fsync_seconds").percentile(0.99)
    samples = [s for s in snap["etcd_peer_send_seconds"]["samples"]]
    assert tmetrics.merge_histograms(samples) == \
        jmetrics.merge_histograms(samples)
    m = tmetrics.merge_histograms(samples)
    for q in (0.0, 0.5, 0.99, 1.0):
        assert tmetrics.percentile_from_buckets(m["bounds"], m["buckets"], q) \
            == jmetrics.percentile_from_buckets(m["bounds"], m["buckets"], q)
    treg.reset()
    jreg.reset()
    assert texporter.render_prometheus(treg) == \
        jexporter.render_prometheus(jreg)
    assert [f.d.name for f in treg.families()] == sorted(tmetrics.CATALOG)


def test_metrics_endpoint_serves_the_registry(tmp_path):
    s = tserver.new_server(_cfg(ServerConfig, Cluster, tmp_path / "m"),
                           device="cpu")
    httpd = serve(make_client_handler(s), "127.0.0.1", 0)
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/metrics"
        with urllib.request.urlopen(url, timeout=10) as r:
            body = r.read()
            assert r.headers["Content-Type"] == texporter.CONTENT_TYPE
        for name in tmetrics.CATALOG:
            assert f"# TYPE {name} ".encode() in body
        req = urllib.request.Request(url, data=b"", method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 405
    finally:
        httpd.shutdown()
        s.storage.wal.close()
        s.store.fanout.close()


def test_sender_posts_to_the_peer_handler_over_one_socket():
    """``new_sender`` with the pooled keep-alive post reaches a peer's
    /raft and counts its frames."""
    from etcd_tpu_torch.server.cluster import ClusterStore, Member
    from etcd_tpu_torch.server.sender import new_sender
    from etcd_tpu_torch.store import Store
    from etcd_tpu_torch.wire import Message

    got = []
    done = threading.Event()

    class Sink:
        def process(self, m):
            got.append(m.marshal())
            if len(got) == 5:
                done.set()

    httpd = serve(make_peer_handler(Sink()), "127.0.0.1", 0)
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        cls = ClusterStore(Store())
        cls.add(Member(id=2, name="b", peer_urls=[url]))
        frames = tmetrics.registry.counter("etcd_peer_send_frames_total",
                                           path="classic")
        before = frames.get()
        send = new_sender(cls)
        msgs = [Message(type=3, to=2, from_=1, index=i) for i in range(5)]
        send(msgs)
        assert done.wait(10)
        assert sorted(got) == sorted(m.marshal() for m in msgs)
        assert frames.get() - before == 5
        send.close()
    finally:
        httpd.shutdown()
