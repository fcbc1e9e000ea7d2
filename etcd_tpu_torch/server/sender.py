"""Peer transport: fire-and-forget message sender
(reference etcdserver/cluster_store.go:106-156; the port's copy of
``etcd_tpu/server/sender.py``).

The reference's entire distributed communication backend: POST the
marshaled raftpb.Message to http://<peer>/raft, one goroutine per
message, three attempts with a fresh address pick each try, drops
allowed by contract (server.go:202-206) — safety rests on raft, not
delivery.  Here: one daemon thread per message batch.  ``post_fn`` is
injectable so in-process cluster tests can short-circuit the network
(the reference does the same by swapping sendFunc,
server_test.go:378-384).
"""

from __future__ import annotations

import logging
import threading
import time
import urllib.error
import urllib.request
from typing import Callable

from ..obs import metrics as _obs
from ..wire import MSG_APP, Message
from .cluster import RAFT_PREFIX, ClusterStore

log = logging.getLogger(__name__)

# obs seams: every POST attempt is a frame; RTT on success,
# a failure only after the retry budget is spent.  The
# classic_reconnect row counts: a cached keep-alive socket found stale and
# re-dialed (the cost connection reuse trades three-way handshakes
# for — visible, not silent).
_M_FRAMES = _obs.registry.counter("etcd_peer_send_frames_total",
                                  path="classic")
_M_RTT = _obs.registry.histogram("etcd_peer_send_seconds",
                                 path="classic")
_M_FAILS = _obs.registry.counter("etcd_peer_send_failures_total",
                                 path="classic")
_M_RECONNECTS = _obs.registry.counter(
    "etcd_peer_send_failures_total", path="classic_reconnect")


def default_post(url: str, data: bytes, timeout: float = 1.0,
                 ssl_context=None) -> bool:
    req = urllib.request.Request(
        url, data=data, method="POST",
        headers={"Content-Type": "application/protobuf"})
    try:
        with urllib.request.urlopen(req, timeout=timeout,
                                    context=ssl_context) as resp:
            return resp.status == 204
    except (urllib.error.URLError, OSError):
        return False


def pooled_post(pool, url: str, data: bytes) -> bool:
    """POST over the shared keep-alive cache (peerlink.KeepAlivePool)
    instead of a fresh connection per message — the reference opens a
    transport per attempt (cluster_store.go:118-144), which at
    intra-DC latencies costs more than the frame itself (the dist
    tier measured this; the classic tier goes through the same
    pool)."""
    from urllib.parse import urlsplit, urlunsplit

    u = urlsplit(url)
    base = urlunsplit((u.scheme, u.netloc, "", "", ""))
    path = u.path or "/"
    out = pool.post(base, base, path, data)
    return out is not None and out[0] == 204


def new_sender(cluster_store: ClusterStore,
               post_fn: Callable[[str, bytes], bool] | None = None,
               leader_stats=None, tls_info=None):
    """Returns send(msgs) that MUST NOT block (server.go:202-206).

    ``leader_stats`` (server/stats.py LeaderStats) records per-follower
    append round-trip latency and failures when provided.
    ``tls_info`` (utils.transport.TLSInfo): when set and non-empty,
    peer POSTs use its client context — cert/key for client-cert auth
    and CA verification against https peers (the reference hands its
    Sender a TLS-capable transport, pkg/transport/listener.go:32-50).
    """
    post = post_fn
    pool_close = lambda: None  # noqa: E731
    if post is None:
        from .peerlink import KeepAlivePool

        ctx = None
        if tls_info is not None and not tls_info.empty():
            ctx = tls_info.client_context()
        pool = KeepAlivePool(
            timeout=1.0, ssl_context=ctx, keep_statuses=(204,),
            on_reconnect=_M_RECONNECTS.inc)
        pool_close = pool.close

        def post(url, data, _pool=pool):
            return pooled_post(_pool, url, data)

    def send(msgs: list[Message]) -> None:
        for m in msgs:
            t = threading.Thread(target=_send_one,
                                 args=(cluster_store, m, post,
                                       leader_stats),
                                 daemon=True)
            t.start()

    # teardown hook: without it the pool caches one keep-alive
    # socket per peer base URL for the process lifetime (no-op when
    # the caller injected its own post_fn)
    send.close = pool_close
    return send


def _send_one(cls: ClusterStore, m: Message, post, stats=None) -> None:
    """Three attempts, address re-picked per try
    (cluster_store.go:118-144)."""
    data = m.marshal()
    track = stats is not None and m.type == MSG_APP
    for _ in range(3):
        u = cls.get().pick(m.to)
        if not u:
            log.warning("etcdhttp: no addr for %x", m.to)
            if track:  # unreachable == failed, for /v2/stats/leader
                stats.fail(m.to)
            _M_FAILS.inc()
            return
        t0 = time.perf_counter()
        _M_FRAMES.inc()
        if post(u + RAFT_PREFIX, data):
            dt = time.perf_counter() - t0
            _M_RTT.observe(dt)
            if track:
                stats.observe(m.to, dt)
            return
    _M_FAILS.inc()
    if track:
        stats.fail(m.to)
