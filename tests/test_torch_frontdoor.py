"""The port's event-driven front door (``etcd_tpu_torch.server.frontdoor``)
against the JAX package's, on the CPU.

- The 28 cases of ``tests/test_frontdoor.py`` run against the port
  (the reference module executed with its imports pointed at
  ``etcd_tpu_torch``).  Its live cases run in front of each tier: the
  classic single-group server (the reference's own fixture), the
  co-hosted ``MultiGroupServer`` (8 groups, ``device="cpu"``) and a
  3-host ``DistServer`` cluster (8 groups, ``device="cpu"``).
- The same requests through each package's front door, each in front
  of its own one-member classic server with the same admission
  configuration, give equal status codes, headers (``Date`` and
  ``X-Raft-Index``, which counts timed SYNC entries, aside) and bodies, the 429 sheds (tenant rate, tenant inflight, global
  inflight) among them; ``/v2/stats/slo`` and
  ``/v2/stats/timeseries`` answer 200 with the reference's body shape
  (their times and the ring's content are not a function of the
  requests).

Tolerance: exact.
"""

from __future__ import annotations

import http.client
import json
import shutil
import tempfile
import threading

import pytest

from etcd_tpu.server import frontdoor as jfd
from etcd_tpu_torch.server import frontdoor as tfd

from test_torch_obs_plane import stats_shape
from test_torch_raft_core import export, port_module

_ref = port_module("test_frontdoor")
assert export(_ref, "frontdoor", globals()) == 28


def _start_tier(tier: str, tmp: str):
    """A started server of ``tier`` and its teardown."""
    if tier == "classic":
        servers = _ref.make_cluster(1)
        return _ref.wait_for_leader(servers), \
            lambda: _ref.stop_cluster(servers)
    if tier == "cohosted":
        from etcd_tpu_torch.server.multigroup import MultiGroupServer

        s = MultiGroupServer(tmp, g=8, m=3, cap=64, tick_interval=0.02,
                             device="cpu")
        s.start()
        return s, s.stop
    from pathlib import Path

    from etcd_tpu_torch.scripts.dist_bench import (
        bootstrap_dist_leader, make_dist_cluster)

    servers, _ = make_dist_cluster(Path(tmp), m=3, g=8, device="cpu")
    bootstrap_dist_leader(servers)

    def stop():
        for s in servers:
            s.stop()

    return servers[0], stop


@pytest.fixture(scope="module", params=["classic", "cohosted", "dist"])
def live(request):
    """The reference's live fixture, in front of each tier."""
    tmp = tempfile.mkdtemp(prefix="fd_tier_")
    s, stop = _start_tier(request.param, tmp)
    fd = tfd.FrontDoor(s, "127.0.0.1", 0, server_timeout=5.0,
                       watch_timeout=5.0, watch_keepalive=1.0,
                       config=tfd.FrontDoorConfig()).start()
    yield {"server": s, "fd": fd,
           "base": f"http://127.0.0.1:{fd.server_address[1]}"}
    fd.shutdown()
    stop()
    shutil.rmtree(tmp, ignore_errors=True)


# -- the same requests through both packages' front doors ---------------------


def _raw(port: int, method: str, path: str, body: bytes = b"",
         headers: dict | None = None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    h = {"Content-Type": "application/x-www-form-urlencoded"}
    h.update(headers or {})
    c.request(method, path, body=body or None, headers=h)
    r = c.getresponse()
    # X-Raft-Index counts the leader's timed SYNC entries too, so it
    # is not a function of the requests alone
    out = (r.status, {k: v for k, v in r.getheaders()
                      if k not in ("Date", "X-Raft-Index")}, r.read())
    c.close()
    return out


_SEQ = [
    ("PUT", "/v2/keys/t1/a", b"value=1", {"X-Etcd-Tenant": "t1"}),
    ("PUT", "/v2/keys/t1/b", b"value=2", {"X-Etcd-Tenant": "t1"}),
    ("GET", "/v2/keys/t1/a", b"", {"X-Etcd-Tenant": "t1"}),
    ("PUT", "/v2/keys/t1/c", b"value=3", {"X-Etcd-Tenant": "t1"}),
    ("PUT", "/v2/keys/t2/a", b"value=9", {}),
    ("GET", "/v2/keys/t2/a", b"", {}),
    ("GET", "/v2/keys/t2/missing", b"", {}),
    ("PUT", "/v2/keys/t2/a", b"ttl=bad", {}),
    ("GET", "/v2/stats/slo", b"", {}),
    ("GET", "/v2/stats/timeseries", b"", {}),
    ("GET", "/v2/stats/nope", b"", {}),
    ("POST", "/metrics", b"", {}),
    ("GET", "/v2/machines", b"", {}),
    ("DELETE", "/v2/keys/t2/a", b"", {}),
]


def _one_member(pkg: str):
    """A one-member in-process classic cluster of ``pkg`` (the
    reference's ``make_cluster`` fixture), its leader and front-door
    module."""
    import test_server as jts

    mod, fd_mod = (_ref, tfd) if pkg == "port" else (jts, jfd)
    servers = mod.make_cluster(1)
    return servers, mod.wait_for_leader(servers), fd_mod


def _drive(pkg: str, cfg_kw: dict) -> list:
    servers, s, fd_mod = _one_member(pkg)
    fd = fd_mod.FrontDoor(s, "127.0.0.1", 0, server_timeout=5.0,
                          config=fd_mod.FrontDoorConfig(**cfg_kw)).start()
    try:
        port = fd.server_address[1]
        return [_raw(port, m, p, b, h) for m, p, b, h in _SEQ]
    finally:
        fd.shutdown()
        for x in servers.values():
            x.stop()


@pytest.mark.parametrize("cfg_kw", [
    {},
    {"tenant_rate": 0.0, "tenant_burst": 2.0},
    {"tenant_rate": 0.0, "tenant_burst": 1.0, "write_cost": 1.0},
], ids=["admit", "shed_tenant_rate", "shed_one_token"])
def test_answers_equal_the_reference(cfg_kw):
    port, ref = _drive("port", cfg_kw), _drive("jax", cfg_kw)
    assert len(port) == len(ref) == len(_SEQ)
    for (m, p, _, _), a, b in zip(_SEQ, port, ref):
        if p in ("/v2/stats/slo", "/v2/stats/timeseries"):
            # the verdict's and the ring's times and the ring's content
            # differ run to run; status, headers and shape agree
            drop = ("Content-Length",)
            assert a[0] == b[0] == 200, (p, a)
            assert {k: v for k, v in a[1].items() if k not in drop} \
                == {k: v for k, v in b[1].items() if k not in drop}
            assert stats_shape(p, a[2]) == stats_shape(p, b[2]), p
            continue
        assert a == b, (m, p)
    if cfg_kw:
        sheds = [a for a in port if a[0] == 429]
        assert sheds
        for st, h, body in sheds:
            doc = json.loads(body)
            assert doc["errorCode"] == 406 and int(h["Retry-After"]) >= 1


def test_global_inflight_shed_equals_the_reference():
    """A request past the global inflight ceiling: the same 429 from
    both packages (the ceiling at 0 sheds every data-path request)."""
    out = {}
    for pkg in ("port", "jax"):
        servers, s, fd_mod = _one_member(pkg)
        fd = fd_mod.FrontDoor(
            s, "127.0.0.1", 0, server_timeout=5.0,
            config=fd_mod.FrontDoorConfig(max_inflight=0)).start()
        try:
            out[pkg] = [_raw(fd.server_address[1], "PUT", "/v2/keys/g/x",
                             b"value=1"),
                        _raw(fd.server_address[1], "GET", "/v2/keys/g/x")]
        finally:
            fd.shutdown()
            for x in servers.values():
                x.stop()
    assert out["port"] == out["jax"]
    assert out["port"][0][0] == 429


def test_listen_backlog_is_the_front_doors():
    from etcd_tpu_torch.api import http as thttp
    from etcd_tpu_torch.server import distserver

    assert thttp._Server.request_queue_size == tfd.LISTEN_BACKLOG
    assert distserver.LISTEN_BACKLOG is tfd.LISTEN_BACKLOG
    assert thttp.LISTEN_BACKLOG is tfd.LISTEN_BACKLOG
    assert tfd.LISTEN_BACKLOG == jfd.LISTEN_BACKLOG


def test_tls_listener_falls_back_to_the_threaded_server(tmp_path):
    """``serve_frontdoor`` with an SSL context hands the listener to the
    threaded server, as the reference does."""
    import ssl

    from etcd_tpu_torch.api import http as thttp

    servers = _ref.make_cluster(1)
    s = _ref.wait_for_leader(servers)
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    srv = tfd.serve_frontdoor(s, "127.0.0.1", 0, ssl_context=ctx)
    try:
        assert isinstance(srv, thttp._Server)
    finally:
        srv.shutdown()
        _ref.stop_cluster(servers)
    fd = tfd.serve_frontdoor(s, "127.0.0.1", 0)
    try:
        assert isinstance(fd, tfd.FrontDoor)
    finally:
        fd.shutdown()


def test_from_env_equals_the_reference():
    env = {"ETCD_FRONTDOOR_TENANTS": "hot=50,50,8;cold=1,2,3",
           "ETCD_FRONTDOOR_RATE": "7.5",
           "ETCD_FRONTDOOR_MAX_INFLIGHT": "33"}
    a = tfd.FrontDoorConfig.from_env(env)
    b = jfd.FrontDoorConfig.from_env(env)
    for k in b.__slots__:
        assert getattr(a, k) == getattr(b, k), k


def test_concurrent_burst_sheds_alike_on_a_hot_tenant():
    """A burst of writes on one tenant from 8 threads sheds with 429
    406 + Retry-After while another tenant's writes are all acked."""
    servers = _ref.make_cluster(1)
    s = _ref.wait_for_leader(servers)
    fd = tfd.FrontDoor(s, "127.0.0.1", 0, server_timeout=5.0,
                       config=tfd.FrontDoorConfig.from_env(
                           {"ETCD_FRONTDOOR_TENANTS": "hot=5,5,8"})).start()
    port = fd.server_address[1]
    codes, other = [], []
    lock = threading.Lock()

    def hot(i):
        for j in range(10):
            st, h, b = _raw(port, "PUT", f"/v2/keys/hot/{i}-{j}", b"value=x")
            with lock:
                codes.append((st, h.get("Retry-After"), b))

    try:
        ts = [threading.Thread(target=hot, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        for j in range(20):
            other.append(_raw(port, "PUT", f"/v2/keys/cold/{j}",
                              b"value=y")[0])
        for t in ts:
            t.join()
    finally:
        fd.shutdown()
        _ref.stop_cluster(servers)
    shed = [c for c in codes if c[0] == 429]
    assert shed and all(json.loads(b)["errorCode"] == 406 and ra
                        for _, ra, b in shed)
    assert set(other) == {201}
