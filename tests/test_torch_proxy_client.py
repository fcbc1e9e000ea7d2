"""The port's proxy (``etcd_tpu_torch.api.proxy``), client library
(``etcd_tpu_torch.api.client``), discovery (``etcd_tpu_torch.discovery``)
and CLI flag surface against the JAX package's, on the CPU.

- Every case of ``tests/test_proxy_depth.py`` (6), ``test_client.py``
  (5), ``test_client_actions.py`` (5) and ``test_cli_discovery.py``
  (19, with their parametrised cases) runs against the port (reference
  modules executed with their imports pointed at ``etcd_tpu_torch``;
  the classic server they start is given ``device="cpu"``).
- The same scripted discovery registry gives both packages' discoverers
  the same initial-cluster string and both ``proxy_endpoints`` the same
  list; both parsers give the same defaults for every flag of the
  reference's; the same requests through both packages' proxies, in
  front of one server, give equal answers, readonly ones included.

Tolerance: exact.
"""

from __future__ import annotations

import functools
import json
import urllib.error
import urllib.request

import pytest

from etcd_tpu import cli as jcli
from etcd_tpu.api.proxy import NewProxyHandler as JProxy
from etcd_tpu.discovery import discovery as jdisc
from etcd_tpu_torch import cli as tcli
from etcd_tpu_torch.api.http import make_client_handler, serve
from etcd_tpu_torch.api.proxy import NewProxyHandler as TProxy
from etcd_tpu_torch.discovery import discovery as tdisc
from etcd_tpu_torch.server import server as tserver

from test_torch_raft_core import export, port_module

_cpu = {"new_server": lambda f: functools.partial(f, device="cpu")}

assert export(port_module("test_proxy_depth"), "proxy", globals()) == 6
assert export(port_module("test_client", _cpu), "client", globals()) == 5
assert export(port_module("test_client_actions"), "client_actions",
              globals()) == 5
assert export(port_module("test_cli_discovery"), "discovery",
              globals()) == 19


@pytest.fixture(autouse=True)
def _classic_server_on_the_cpu(monkeypatch):
    """Reference cases that import ``new_server`` inside the test get
    the CPU too."""
    monkeypatch.setattr(tserver, "new_server",
                        functools.partial(tserver.new_server, device="cpu"))


def test_parsers_give_the_same_defaults():
    a = vars(tcli.build_parser().parse_args([]))
    b = vars(jcli.build_parser().parse_args([]))
    assert set(b) <= set(a)
    for k, v in b.items():
        assert a[k] == v, k
    assert a["frontdoor"] == "on" and a["cohosted_groups"] == 0


@pytest.mark.parametrize("size,registered,events", [
    (3, 3, 0), (2, 1, 2), (2, 3, 0)])
def test_discovery_equals_the_reference(size, registered, events):
    """The reference's scripted registry (``FakeClient``) gives both
    packages' discoverers the same initial-cluster string and the same
    registrations, and both ``proxy_endpoints`` the same list."""
    import test_cli_discovery as ref

    def make():
        nodes = [{"key": f"/c/{i}", "value": f"n{i}=http://h{i}:7001",
                  "createdIndex": 10 - i} for i in range(1, registered + 1)]
        evs = [{"key": "/c/_ignoreme", "value": "", "modifiedIndex": 21},
               {"key": "/c/9", "value": "n9=http://h9:7001",
                "modifiedIndex": 22}][:events]
        return ref.FakeClient(size, nodes, evs)

    out = {}
    for name, mod in (("port", tdisc), ("jax", jdisc)):
        c = make()
        d = mod.Discoverer("http://disc.example.com/c", 1,
                           "n1=http://h1:7001", client=c)
        try:
            got = d.discover()
        except Exception as e:  # the same refusal on both sides
            got = type(e).__name__
        ends = mod.proxy_endpoints("http://disc.example.com/c",
                                   client=make())
        out[name] = (got, c.created, ends)
    assert out["port"] == out["jax"]


def test_nodes_to_cluster_equal_the_reference():
    nodes = [{"key": f"/t/{i:x}", "value": f"n{i}=http://10.0.0.{i}:2380",
              "createdIndex": 30 - i} for i in range(5)]
    assert tdisc.nodes_to_cluster(nodes) == jdisc.nodes_to_cluster(nodes)
    assert tdisc.nodes_to_cluster([]) == jdisc.nodes_to_cluster([])


def _backend(d):
    """A one-member port classic server (leader) and its client
    listener."""
    import time

    from etcd_tpu_torch.server.cluster import Cluster
    from etcd_tpu_torch.server.config import ServerConfig

    c = Cluster()
    c.set_from_string("p=http://127.0.0.1:1")
    s = tserver.new_server(ServerConfig(name="p", data_dir=str(d),
                                        cluster=c), device="cpu")
    s.tick_interval = 0.01
    s._start()
    deadline = time.time() + 10
    while s.node.r.state != 2:
        assert time.time() < deadline
        time.sleep(0.01)
    return s, serve(make_client_handler(s), "127.0.0.1", 0)


_PROXY_SEQ = [("PUT", "/v2/keys/px/a", b"value=1"),
              ("GET", "/v2/keys/px/a", None),
              ("GET", "/v2/keys/px/missing", None),
              ("PUT", "/v2/keys/px/a", b"value=2&prevValue=nope"),
              ("DELETE", "/v2/keys/px/a", None),
              ("GET", "/v2/machines", None)]


@pytest.mark.parametrize("readonly", [False, True])
def test_proxy_answers_equal_across_packages(tmp_path, readonly):
    """Each package's proxy, in front of its own fresh port server,
    answers the same request sequence with equal status codes and
    bodies (a readonly proxy: 501 for every write)."""
    got = {}
    for name, P in (("port", TProxy), ("jax", JProxy)):
        s, back = _backend(tmp_path / name)
        proxy = serve(P([f"127.0.0.1:{back.server_address[1]}"],
                        readonly=readonly), "127.0.0.1", 0)
        out = []
        try:
            base = f"http://127.0.0.1:{proxy.server_address[1]}"
            for method, path, body in _PROXY_SEQ:
                req = urllib.request.Request(base + path, data=body,
                                             method=method)
                if body:
                    req.add_header("Content-Type",
                                   "application/x-www-form-urlencoded")
                try:
                    with urllib.request.urlopen(req, timeout=10) as r:
                        out.append((r.status, r.read()))
                except urllib.error.HTTPError as e:
                    out.append((e.code, e.read()))
        finally:
            proxy.shutdown()
            back.shutdown()
            s.stop()
        got[name] = out
    assert got["port"] == got["jax"]
    codes = [st for st, _ in got["port"]]
    if readonly:
        assert codes[0] == codes[3] == codes[4] == 501
    else:
        assert codes == [201, 200, 404, 412, 200, 200]
        assert json.loads(got["port"][1][1])["node"]["value"] == "1"
