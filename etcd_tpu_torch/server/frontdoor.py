"""Event-driven multi-tenant front door (the port's copy of
``etcd_tpu/server/frontdoor.py``).

The stdlib threaded HTTP server pins one thread per connection — a
keepalive watch stream holds its thread for minutes, so 50k
watchers would need 50k threads and an overloaded client degrades
every tenant at once.  This module replaces the client-facing serving
loop with a selectors-based event loop that OWNS client connections
and is the single place overload policy lives:

- **Bounded memory at scale**: one loop thread multiplexes every
  connection (watch streams ride :class:`~..store.fanout.WatchMux`
  sinks, not threads); per-connection state is a few KiB of slotted
  buffers.
- **Per-tenant isolation**: requests carry a tenant (header
  ``X-Etcd-Tenant``, else the first ``/v2/keys`` path segment, else
  ``default``); each tenant gets a token bucket (rate/burst, writes
  cost more than reads so writes shed first — the NOSPACE read-only
  shape, per tenant) plus inflight and watch-count quotas.
- **Fail-fast admission**: a request the bucket or a global
  inflight / queue-depth ceiling rejects is answered *immediately*
  with a typed 429 (``errorCode`` 406) + ``Retry-After`` — shedding
  is an answer, never a timeout.  Decision table: admit /
  shed_write / shed_all / close (connection ceiling).

Consensus, the store, and the peer tier are untouched: admitted
requests still flow through the ``api/http.py`` parse seam
(:func:`~..api.http.parse_request`) into ``etcd.do`` on a bounded
worker pool.  The ops plane (``/metrics``, ``/v2/stats``,
``/v2/machines``, CORS preflight) is served inline on the loop and is
exempt from admission — you can always observe an overloaded node.

Threading model (single ownership): ONLY the loop thread touches
connection state.  Workers and fanout delivery threads hand results
back through a completions mailbox + wakeup pipe; watch sinks kick
the loop at most once per drain (``_ConnSink.kicked``), so a burst of
100k events costs one wakeup, not 100k.
"""

from __future__ import annotations

import heapq
import json
import logging
import math
import os
import queue
import re
import selectors
import socket
import threading
import time
import urllib.parse

from ..obs import metrics as _obs
from ..store import clean_path
from ..store.fanout import WatchMux
from ..utils import faults as _faults
from ..utils.errors import (
    ECODE_INVALID_FIELD,
    ECODE_INVALID_FORM,
    ECODE_RAFT_INTERNAL,
    EtcdError,
    EtcdOverCapacity,
)
from .server import gen_id

log = logging.getLogger(__name__)

#: Listen backlog for every client-facing listener (front door AND the
#: threaded fallback in api/http.py).  The stdlib socketserver default
#: is ``request_queue_size = 5``: a connection burst RSTs in the
#: kernel before admission control can even say 429.  Centralized here
#: so the peer/client asymmetry (the peer tier already used 128)
#: cannot reappear.
LISTEN_BACKLOG = 1024

TENANT_HEADER = "x-etcd-tenant"
#: distinct tenants that get their own ``etcd_tenant_inflight`` label
#: before further tenants aggregate under ``_other`` (CATALOG-bounded
#: cardinality — an abusive client minting tenant names must not mint
#: time series)
TENANT_LABEL_MAX = 64
#: distinct tenant *states* (buckets/quotas) tracked before further
#: tenants share one overflow state — bounded memory under a tenant
#: name flood
TENANT_STATE_MAX = 4096

_TENANT_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")

MAX_HEADER_BYTES = 64 * 1024
MAX_BODY_BYTES = 4 * 1024 * 1024
#: per-connection outbound buffer cap; a consumer lagging this far is
#: evicted (slow-consumer policy, same shape as watcher eviction)
MAX_OUT_BYTES = 8 * 1024 * 1024
#: bytes read per readiness callback, so one firehose connection
#: cannot monopolize the loop
READ_QUANTUM = 256 * 1024

_M_CONNS = _obs.registry.gauge("etcd_conns_open")


def _admit_counter(outcome: str, reason: str):
    return _obs.registry.counter("etcd_admission_total",
                                 outcome=outcome, reason=reason)


def parse_tenant(headers: dict, path: str) -> str:
    """Tenant grammar: validated ``X-Etcd-Tenant`` header wins; else
    the first ``/v2/keys`` path segment (a namespace-per-prefix
    convention); else ``default``.  Anything failing the
    ``[A-Za-z0-9._-]{1,64}`` shape falls back — an invalid name must
    not become a distinct bucket."""
    hdr = headers.get(TENANT_HEADER, "")
    if hdr and _TENANT_RE.match(hdr):
        return hdr
    if path.startswith("/v2/keys"):
        seg = path[len("/v2/keys"):].lstrip("/").split("/", 1)[0]
        if seg and _TENANT_RE.match(seg):
            return seg
    return "default"


class TokenBucket:
    """Monotonic-clock token bucket.  ``take`` refills from elapsed
    monotonic time with negative elapsed clamped to zero — a clock
    that jitters backward (VM migration, NTP step on a non-monotonic
    source fed in tests) can pause refill but never mints tokens and
    never goes negative.  A failed take consumes nothing."""

    __slots__ = ("rate", "burst", "tokens", "_last")

    def __init__(self, rate: float, burst: float,
                 now: float | None = None):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._last = time.monotonic() if now is None else now

    def _refill(self, now: float) -> None:
        elapsed = now - self._last
        if elapsed > 0:
            self.tokens = min(self.burst,
                              self.tokens + elapsed * self.rate)
        self._last = now

    def take(self, cost: float, now: float | None = None) -> bool:
        if now is None:
            now = time.monotonic()
        self._refill(now)
        if self.tokens >= cost:
            self.tokens -= cost
            return True
        return False

    def retry_after(self, cost: float,
                    now: float | None = None) -> float:
        """Seconds until ``cost`` tokens will be available (the
        Retry-After hint)."""
        if now is None:
            now = time.monotonic()
        self._refill(now)
        if self.tokens >= cost:
            return 0.0
        if self.rate <= 0:
            return 60.0
        return (cost - self.tokens) / self.rate


class FrontDoorConfig:
    """Admission knobs.  Defaults are generous enough that existing
    tests and chaos drills never shed; benches and the ``overload``
    nemesis tighten them via env (``from_env``) or explicitly."""

    __slots__ = ("max_conns", "max_inflight", "max_queue_depth",
                 "workers", "tenant_rate", "tenant_burst",
                 "tenant_inflight", "tenant_watches", "write_cost",
                 "read_cost", "tenant_overrides")

    def __init__(self, *, max_conns: int = 100_000,
                 max_inflight: int = 4096,
                 max_queue_depth: int = 8192, workers: int = 16,
                 tenant_rate: float = 5000.0,
                 tenant_burst: float = 10_000.0,
                 tenant_inflight: int = 1024,
                 tenant_watches: int = 200_000,
                 write_cost: float = 1.0, read_cost: float = 0.2,
                 tenant_overrides: dict | None = None):
        self.max_conns = max_conns
        self.max_inflight = max_inflight
        self.max_queue_depth = max_queue_depth
        self.workers = workers
        self.tenant_rate = tenant_rate
        self.tenant_burst = tenant_burst
        self.tenant_inflight = tenant_inflight
        self.tenant_watches = tenant_watches
        self.write_cost = write_cost
        self.read_cost = read_cost
        #: tenant -> (rate, burst, inflight, watches)
        self.tenant_overrides = dict(tenant_overrides or {})

    @classmethod
    def from_env(cls, env) -> "FrontDoorConfig":
        def _num(key, default, conv):
            v = env.get(key)
            if v is None or v == "":
                return default
            try:
                return conv(v)
            except ValueError:
                log.warning("frontdoor: ignoring bad %s=%r", key, v)
                return default

        overrides = {}
        spec = env.get("ETCD_FRONTDOOR_TENANTS", "")
        # name=rate,burst,inflight[,watches];name2=...
        for part in filter(None, spec.split(";")):
            try:
                name, vals = part.split("=", 1)
                nums = vals.split(",")
                rate, burst = float(nums[0]), float(nums[1])
                infl = int(nums[2])
                watches = int(nums[3]) if len(nums) > 3 else None
                overrides[name.strip()] = (rate, burst, infl, watches)
            except (ValueError, IndexError):
                log.warning("frontdoor: bad tenant override %r", part)
        return cls(
            max_conns=_num("ETCD_FRONTDOOR_MAX_CONNS", 100_000, int),
            max_inflight=_num("ETCD_FRONTDOOR_MAX_INFLIGHT", 4096,
                              int),
            max_queue_depth=_num("ETCD_FRONTDOOR_MAX_QUEUE", 8192,
                                 int),
            workers=_num("ETCD_FRONTDOOR_WORKERS", 16, int),
            tenant_rate=_num("ETCD_FRONTDOOR_RATE", 5000.0, float),
            tenant_burst=_num("ETCD_FRONTDOOR_BURST", 10_000.0,
                              float),
            tenant_inflight=_num("ETCD_FRONTDOOR_TENANT_INFLIGHT",
                                 1024, int),
            tenant_watches=_num("ETCD_FRONTDOOR_TENANT_WATCHES",
                                200_000, int),
            write_cost=_num("ETCD_FRONTDOOR_WRITE_COST", 1.0, float),
            read_cost=_num("ETCD_FRONTDOOR_READ_COST", 0.2, float),
            tenant_overrides=overrides,
        )


class _TenantState:
    __slots__ = ("bucket", "inflight", "watches", "max_inflight",
                 "max_watches", "label", "gauge")

    def __init__(self, cfg: FrontDoorConfig, name: str, label: str):
        rate, burst = cfg.tenant_rate, cfg.tenant_burst
        infl, watches = cfg.tenant_inflight, cfg.tenant_watches
        ov = cfg.tenant_overrides.get(name)
        if ov is not None:
            rate, burst, infl = ov[0], ov[1], ov[2]
            if ov[3] is not None:
                watches = ov[3]
        self.bucket = TokenBucket(rate, burst)
        self.inflight = 0
        self.watches = 0
        self.max_inflight = infl
        self.max_watches = watches
        self.label = label
        self.gauge = _obs.registry.gauge("etcd_tenant_inflight",
                                         tenant=label)


#: admission outcomes / reasons (the typed vocabulary the CATALOG
#: families and the 429 cause carry)
ADMIT = "admit"
SHED_WRITE = "shed_write"
SHED_ALL = "shed_all"
CLOSE = "close"


class Admission:
    """Admission policy state: per-tenant buckets/quotas + global
    ceilings.  Loop-thread-only — no locks; the front door calls it
    exclusively from the event loop (single-ownership model)."""

    def __init__(self, cfg: FrontDoorConfig,
                 queue_depth=lambda: 0):
        self.cfg = cfg
        self.inflight = 0
        self.queue_depth = queue_depth
        self.tenants: dict[str, _TenantState] = {}
        #: (outcome, reason) -> count; the local mirror /v2/stats/
        #: frontdoor serves (the registry is the export path)
        self.counts: dict[tuple[str, str], int] = {}

    def _bill(self, outcome: str, reason: str) -> None:
        _admit_counter(outcome, reason).inc()
        k = (outcome, reason)
        self.counts[k] = self.counts.get(k, 0) + 1

    def state(self, tenant: str) -> _TenantState:
        st = self.tenants.get(tenant)
        if st is None:
            if len(self.tenants) >= TENANT_STATE_MAX:
                # tenant-name flood: further tenants share one state
                # (bounded memory beats per-abuser precision)
                st = self.tenants.get("_overflow")
                if st is None:
                    st = _TenantState(self.cfg, "_overflow", "_other")
                    self.tenants["_overflow"] = st
                return st
            label = tenant if len(self.tenants) < TENANT_LABEL_MAX \
                else "_other"
            st = _TenantState(self.cfg, tenant, label)
            self.tenants[tenant] = st
        return st

    def decide(self, tenant: str, is_write: bool,
               now: float | None = None):
        """One admission decision.  Returns ``(outcome, reason,
        retry_after)``; callers must :meth:`begin` iff outcome is
        ADMIT.  Order: global ceilings (cheapest, protect the node)
        → tenant inflight → tenant bucket (write cost > read cost, so
        a draining bucket sheds writes first and reads last — the
        NOSPACE degradation shape, per tenant)."""
        if now is None:
            now = time.monotonic()
        if self.inflight >= self.cfg.max_inflight:
            self._bill(SHED_ALL, "global_inflight")
            return SHED_ALL, "global_inflight", 1.0
        if self.queue_depth() >= self.cfg.max_queue_depth:
            self._bill(SHED_ALL, "queue_depth")
            return SHED_ALL, "queue_depth", 1.0
        st = self.state(tenant)
        if st.inflight >= st.max_inflight:
            self._bill(SHED_ALL, "tenant_inflight")
            return SHED_ALL, "tenant_inflight", 1.0
        cost = self.cfg.write_cost if is_write else self.cfg.read_cost
        if not st.bucket.take(cost, now):
            ra = st.bucket.retry_after(cost, now)
            outcome = SHED_WRITE if is_write else SHED_ALL
            self._bill(outcome, "tenant_rate")
            return outcome, "tenant_rate", ra
        self._bill(ADMIT, "ok")
        return ADMIT, "ok", 0.0

    def begin(self, tenant: str) -> None:
        self.inflight += 1
        st = self.state(tenant)
        st.inflight += 1
        st.gauge.inc()

    def finish(self, tenant: str) -> None:
        self.inflight -= 1
        st = self.state(tenant)
        st.inflight -= 1
        st.gauge.inc(-1)

    def try_add_watches(self, tenant: str, n: int) -> bool:
        st = self.state(tenant)
        if st.watches + n > st.max_watches:
            return False
        st.watches += n
        return True

    def release_watches(self, tenant: str, n: int) -> None:
        st = self.state(tenant)
        st.watches = max(0, st.watches - n)

    def stats(self) -> dict:
        return {
            "inflight": self.inflight,
            "queueDepth": self.queue_depth(),
            "admission": {f"{o}/{r}": n
                          for (o, r), n in sorted(self.counts.items())},
            "tenants": {
                name: {"inflight": st.inflight,
                       "watches": st.watches,
                       "tokens": round(st.bucket.tokens, 3)}
                for name, st in self.tenants.items()
            },
        }


class _ConnSink(WatchMux):
    """A connection's watch delivery sink: a :class:`WatchMux` that
    kicks the event loop when items land.  ``kicked`` (guarded by the
    loop's completions lock) dedupes kicks — one mailbox entry per
    drain, however many events the fanout threads deliver."""

    __slots__ = ("loop", "conn", "kicked")

    def __init__(self, loop: "FrontDoor", conn: "_Conn",
                 capacity: int = 4096):
        super().__init__(capacity=capacity)
        self.loop = loop
        self.conn = conn
        self.kicked = False

    def offer(self, mid, e, block_s=None):
        ok = super().offer(mid, e, block_s)
        if ok:
            self.loop._watch_kick(self)
        return ok

    def offer_closed(self, mid):
        super().offer_closed(mid)
        self.loop._watch_kick(self)


class _Conn:
    """Per-connection state, owned exclusively by the loop thread."""

    __slots__ = ("sock", "fd", "addr", "mode", "rbuf", "out",
                 "close_after", "epoch", "tenant", "origin",
                 "want_write", "sink", "watchers", "open_members",
                 "single", "watch_count", "keepalive", "deadline_at",
                 "last_write", "chunked")

    def __init__(self, sock, addr):
        self.sock = sock
        self.fd = sock.fileno()
        self.addr = addr
        self.mode = "idle"  # idle | busy | watch | closed  # owner: frontdoor-loop
        self.rbuf = bytearray()  # owner: frontdoor-loop
        self.out = bytearray()  # owner: frontdoor-loop
        self.close_after = False  # owner: frontdoor-loop
        self.epoch = 0  # owner: frontdoor-loop
        self.tenant = None  # tenant billed for the inflight request  # owner: frontdoor-loop
        self.origin = ""  # owner: frontdoor-loop
        self.want_write = False  # owner: frontdoor-loop
        self.sink: _ConnSink | None = None  # owner: frontdoor-loop
        self.watchers: list | None = None  # owner: frontdoor-loop
        self.open_members = 0  # owner: frontdoor-loop
        self.single = False  # untagged single-watch line format  # owner: frontdoor-loop
        self.watch_count = 0  # quota units to release at teardown  # owner: frontdoor-loop
        self.keepalive = 0.0  # owner: frontdoor-loop
        self.deadline_at = 0.0  # owner: frontdoor-loop
        self.last_write = 0.0  # owner: frontdoor-loop
        self.chunked = False  # owner: frontdoor-loop


def _status_line(status: int) -> bytes:
    phrases = {200: "OK", 201: "Created", 204: "No Content",
               400: "Bad Request", 403: "Forbidden",
               404: "Not Found", 405: "Method Not Allowed",
               412: "Precondition Failed", 413: "Payload Too Large",
               429: "Too Many Requests",
               431: "Request Header Fields Too Large",
               500: "Internal Server Error",
               503: "Service Unavailable",
               507: "Insufficient Storage"}
    return (f"HTTP/1.1 {status} "
            f"{phrases.get(status, 'Unknown')}\r\n").encode()


def _response(status: int, body: bytes, headers: dict | None = None,
              close: bool = False) -> bytes:
    out = bytearray(_status_line(status))
    for k, v in (headers or {}).items():
        out += f"{k}: {v}\r\n".encode()
    out += f"Content-Length: {len(body)}\r\n".encode()
    if close:
        out += b"Connection: close\r\n"
    out += b"\r\n"
    out += body
    return bytes(out)


def _error_parts(err: Exception) -> tuple[int, dict, bytes]:
    """``(status, headers, body)`` for an error — assembled into a
    response on the loop thread (via ``_reply``) so CORS headers get
    injected there, same as every other reply."""
    if isinstance(err, EtcdError):
        body = (err.to_json() + "\n").encode()
        headers = {"Content-Type": "application/json",
                   "X-Etcd-Index": str(err.index)}
        if isinstance(err, EtcdOverCapacity):
            # integer-second ceiling, minimum 1: Retry-After is a
            # pacing hint, and "0" invites an immediate retry storm
            headers["Retry-After"] = str(max(
                1, int(err.retry_after + 0.999)))
        return err.http_status(), headers, body
    log.warning("frontdoor: internal error: %s", err)
    return 500, {}, b"Internal Server Error\n"


class FrontDoor:
    """Selectors-based client front end for one listener.

    Exposes the ``_Server`` surface cli.py relies on
    (``server_address``, ``shutdown()``) so the two serving modes are
    interchangeable."""

    def __init__(self, etcd, host: str, port: int, *,
                 config: FrontDoorConfig | None = None,
                 cors: set[str] | None = None,
                 server_timeout: float | None = None,
                 watch_timeout: float | None = None,
                 watch_keepalive: float | None = None,
                 extra_routes: dict | None = None,
                 watch_redirect: str | None = None):
        # lazy: api.http imports LISTEN_BACKLOG from this module at
        # module level, so the reverse import must happen at runtime
        from ..api import http as _http

        self._http = _http
        self.etcd = etcd
        self.cfg = config or FrontDoorConfig()
        self.cors = cors
        self.server_timeout = (_http.DEFAULT_SERVER_TIMEOUT
                               if server_timeout is None
                               else server_timeout)
        self.watch_timeout = (_http.DEFAULT_WATCH_TIMEOUT
                              if watch_timeout is None
                              else watch_timeout)
        self.watch_keepalive = (_http.DEFAULT_WATCH_KEEPALIVE
                                if watch_keepalive is None
                                else watch_keepalive)
        # role-split hooks.  extra_routes: exact path ->
        # handler(method, path, query, headers, body) returning
        # (status, headers, body); runs on the worker pool so batch
        # endpoints (the ingest role's /mraft/propose_many lineage)
        # never stall the event loop.  watch_redirect: base URL of
        # the apply/watch worker — wait= requests 307 there, keeping
        # the stateless ingest free of long-held watch connections.
        self.extra_routes = extra_routes or {}
        self.watch_redirect = watch_redirect

        self._lsock = socket.socket(socket.AF_INET,
                                    socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET,
                               socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, port))
        self._lsock.listen(LISTEN_BACKLOG)
        self._lsock.setblocking(False)

        self._sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)

        self._conns: dict[int, _Conn] = {}  # owner: frontdoor-loop
        # bounded handoff to the worker pool; depth is an admission
        # input (queue_depth ceiling), so overload surfaces as a 429
        # at the door, not latency inside
        self._jobs: queue.Queue = queue.Queue(
            maxsize=self.cfg.max_queue_depth)
        self.admission = Admission(self.cfg, self._jobs.qsize)

        self._lock = threading.Lock()
        self._completions: list = []
        self._wake_armed = False

        self._timers: list = []  # owner: frontdoor-loop
        self._tseq = 0  # owner: frontdoor-loop
        self._stopping = False
        self._threads: list[threading.Thread] = []

    # -- lifecycle ---------------------------------------------------------

    @property
    def server_address(self):
        return self._lsock.getsockname()

    def start(self) -> "FrontDoor":
        self._sel.register(self._lsock, selectors.EVENT_READ,
                           "accept")
        self._sel.register(self._wake_r, selectors.EVENT_READ,
                           "wakeup")
        t = threading.Thread(target=self._run, daemon=True,
                             name="frontdoor-loop")
        t.start()
        self._threads.append(t)
        for i in range(self.cfg.workers):
            w = threading.Thread(target=self._worker, daemon=True,
                                 name=f"frontdoor-worker-{i}")
            w.start()
            self._threads.append(w)
        return self

    def shutdown(self) -> None:
        self._stopping = True
        self._wake()
        # best-effort fast wakeup; a full queue may drop sentinels,
        # in which case workers still exit via the _stopping flag
        # within their get() timeout
        for _ in range(self.cfg.workers):
            try:
                self._jobs.put_nowait(None)
            except queue.Full:
                break
        for t in self._threads:
            t.join(timeout=2.0)

    def stats_json(self) -> bytes:
        s = self.admission.stats()
        s["connsOpen"] = len(self._conns)
        return (json.dumps(s) + "\n").encode()

    # -- cross-thread mailbox ----------------------------------------------

    def _wake(self) -> None:
        with self._lock:
            if self._wake_armed:
                return
            self._wake_armed = True
        try:
            self._wake_w.send(b"x")
        except (BlockingIOError, OSError):
            pass

    def _post(self, item) -> None:
        with self._lock:
            self._completions.append(item)
        self._wake()

    def _watch_kick(self, sink: _ConnSink) -> None:
        with self._lock:
            if sink.kicked:
                return
            sink.kicked = True
            self._completions.append(("watch", sink.conn))
        self._wake()

    # -- event loop --------------------------------------------------------

    def _run(self) -> None:
        while not self._stopping:
            timeout = self._timer_delay()
            for key, _mask in self._sel.select(timeout):
                try:
                    if key.data == "accept":
                        self._accept()
                    elif key.data == "wakeup":
                        self._drain_wakeup()
                    else:
                        conn = key.data
                        if _mask_writable(_mask):
                            self._flush(conn)
                        if conn.mode != "closed" \
                                and _mask_readable(_mask):
                            self._on_readable(conn)
                except Exception:  # the loop must never die
                    log.exception("frontdoor: event handler error")
                    if isinstance(key.data, _Conn):
                        self._teardown(key.data)
            try:
                self._fire_timers()
                self._process_completions()
            except Exception:  # pragma: no cover
                log.exception("frontdoor: loop maintenance error")
        # teardown
        for conn in list(self._conns.values()):
            self._teardown(conn)
        try:
            self._sel.unregister(self._lsock)
        except KeyError:
            pass
        self._lsock.close()
        self._sel.close()
        self._wake_r.close()
        self._wake_w.close()

    def _drain_wakeup(self) -> None:
        try:
            while self._wake_r.recv(4096):
                pass
        except (BlockingIOError, OSError):
            pass
        with self._lock:
            self._wake_armed = False

    def _process_completions(self) -> None:
        while True:
            with self._lock:
                if not self._completions:
                    return
                batch = self._completions
                self._completions = []
            for item in batch:
                kind = item[0]
                if kind == "resp":
                    _k, conn, epoch, parts, close = item
                    if conn.epoch != epoch or conn.mode != "busy":
                        continue  # conn was torn down meanwhile
                    if conn.tenant is not None:
                        self.admission.finish(conn.tenant)
                        conn.tenant = None
                    conn.mode = "idle"
                    conn.close_after = conn.close_after or close
                    status, headers, body = parts
                    self._reply(conn, status, body, headers)
                    if conn.mode != "closed" \
                            and not conn.close_after:
                        self._process_rbuf(conn)
                elif kind == "watch":
                    _k, conn = item
                    with self._lock:
                        if conn.sink is not None:
                            conn.sink.kicked = False
                    if conn.mode == "watch":
                        self._drain_watch(conn)

    # -- timers ------------------------------------------------------------

    def _arm(self, when: float, kind: str, conn: _Conn) -> None:
        self._tseq += 1
        heapq.heappush(self._timers,
                       (when, self._tseq, kind, conn, conn.epoch))

    def _timer_delay(self) -> float:
        if not self._timers:
            return 0.5
        delay = self._timers[0][0] - time.monotonic()
        return min(0.5, max(0.0, delay))

    def _fire_timers(self) -> None:
        now = time.monotonic()
        while self._timers and self._timers[0][0] <= now:
            _when, _seq, kind, conn, epoch = heapq.heappop(
                self._timers)
            if conn.epoch != epoch or conn.mode != "watch":
                continue  # stale timer (lazy invalidation)
            if kind == "deadline":
                self._end_watch(conn)
            elif kind == "ka":
                if conn.keepalive and \
                        now - conn.last_write >= conn.keepalive:
                    self._queue_chunk(conn, b"\n")
                self._arm(now + (conn.keepalive or 1.0), "ka", conn)

    # -- accept / read / write ---------------------------------------------

    def _accept(self) -> None:
        while True:
            try:
                sock, addr = self._lsock.accept()
            except (BlockingIOError, OSError):
                return
            try:
                act = _faults.hit("frontdoor.accept")
                if act == _faults.DROP:
                    sock.close()
                    continue
            except OSError:
                sock.close()
                continue
            if len(self._conns) >= self.cfg.max_conns:
                # connection ceiling: close before a byte is read —
                # the one decision that cannot be a 429 (parsing the
                # request would cost the memory the ceiling protects)
                self.admission._bill(CLOSE, "conn_ceiling")
                sock.close()
                continue
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP,
                                socket.TCP_NODELAY, 1)
            except OSError:
                pass
            conn = _Conn(sock, addr)
            self._conns[conn.fd] = conn
            self._sel.register(sock, selectors.EVENT_READ, conn)
            _M_CONNS.inc()

    def _on_readable(self, conn: _Conn) -> None:
        try:
            act = _faults.hit("frontdoor.read")
            if act == _faults.DROP:
                self._teardown(conn)
                return
        except OSError:
            self._queue_bytes(conn, _response(
                503, b"injected fault\n", None, True))
            conn.close_after = True
            return
        got = 0
        while got < READ_QUANTUM:
            try:
                data = conn.sock.recv(65536)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                self._teardown(conn)
                return
            if not data:
                self._teardown(conn)
                return
            conn.rbuf += data
            got += len(data)
            if len(data) < 65536:
                break
        if len(conn.rbuf) > MAX_HEADER_BYTES + MAX_BODY_BYTES:
            self._teardown(conn)
            return
        if conn.mode == "idle":
            self._process_rbuf(conn)

    def _queue_bytes(self, conn: _Conn, data: bytes) -> None:
        conn.out += data
        conn.last_write = time.monotonic()
        self._flush(conn)

    def _queue_chunk(self, conn: _Conn, data: bytes) -> None:
        self._queue_bytes(conn, f"{len(data):x}\r\n".encode()
                          + data + b"\r\n")

    def _flush(self, conn: _Conn) -> None:
        if conn.mode == "closed":
            return
        while conn.out:
            try:
                n = conn.sock.send(conn.out)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                self._teardown(conn)
                return
            if n == 0:
                break
            del conn.out[:n]
        if len(conn.out) > MAX_OUT_BYTES:
            # slow consumer: evict rather than buffer without bound
            self._teardown(conn)
            return
        want = bool(conn.out)
        if want != conn.want_write:
            conn.want_write = want
            events = selectors.EVENT_READ
            if want:
                events |= selectors.EVENT_WRITE
            try:
                self._sel.modify(conn.sock, events, conn)
            except (KeyError, ValueError, OSError):
                pass
        if not conn.out and conn.close_after \
                and conn.mode in ("idle",):
            self._teardown(conn)

    def _teardown(self, conn: _Conn) -> None:
        if conn.mode == "closed":
            return
        if conn.mode == "busy" and conn.tenant is not None:
            self.admission.finish(conn.tenant)
            conn.tenant = None
        if conn.sink is not None:
            self._close_watch_state(conn)
        conn.mode = "closed"
        conn.epoch += 1
        self._conns.pop(conn.fd, None)
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        _M_CONNS.inc(-1)

    # -- request parsing ---------------------------------------------------

    def _process_rbuf(self, conn: _Conn) -> None:
        while conn.mode == "idle" and not conn.close_after:
            end = conn.rbuf.find(b"\r\n\r\n")
            if end < 0:
                if len(conn.rbuf) > MAX_HEADER_BYTES:
                    self._queue_bytes(conn, _response(
                        431, b"header too large\n", None, True))
                    conn.close_after = True
                return
            head = bytes(conn.rbuf[:end])
            try:
                lines = head.decode("latin-1").split("\r\n")
                method, target, version = lines[0].split(" ", 2)
                headers = {}
                for ln in lines[1:]:
                    k, _, v = ln.partition(":")
                    headers[k.strip().lower()] = v.strip()
            except (ValueError, IndexError):
                self._queue_bytes(conn, _response(
                    400, b"bad request\n", None, True))
                conn.close_after = True
                return
            try:
                clen = int(headers.get("content-length") or 0)
            except ValueError:
                clen = 0
            if clen > MAX_BODY_BYTES:
                self._queue_bytes(conn, _response(
                    413, b"body too large\n", None, True))
                conn.close_after = True
                return
            total = end + 4 + clen
            if len(conn.rbuf) < total:
                return  # body still in flight
            body = bytes(conn.rbuf[end + 4:total])
            del conn.rbuf[:total]
            connhdr = headers.get("connection", "").lower()
            if connhdr == "close" or (version == "HTTP/1.0"
                                      and connhdr != "keep-alive"):
                conn.close_after = True
            conn.origin = headers.get("origin", "")
            self._dispatch(conn, method, target, headers, body)

    def _cors_headers(self, conn: _Conn) -> dict:
        if not self.cors:
            return {}
        if "*" in self.cors:
            allow = "*"
        elif conn.origin in self.cors:
            allow = conn.origin
        else:
            return {}
        return {
            "Access-Control-Allow-Methods":
                "POST, GET, OPTIONS, PUT, DELETE",
            "Access-Control-Allow-Origin": allow,
            "Access-Control-Allow-Headers": "accept, content-type",
        }

    def _reply(self, conn: _Conn, status: int, body: bytes,
               headers: dict | None = None) -> None:
        h = dict(headers or {})
        h.update(self._cors_headers(conn))
        self._queue_bytes(conn, _response(status, body, h,
                                          conn.close_after))

    def _reply_error(self, conn: _Conn, err: Exception) -> None:
        status, h, body = _error_parts(err)
        self._reply(conn, status, body, h)

    # -- dispatch ----------------------------------------------------------

    def _dispatch(self, conn: _Conn, method: str, target: str,
                  headers: dict, body: bytes) -> None:
        _http = self._http
        parsed = urllib.parse.urlsplit(target)
        path = urllib.parse.unquote(parsed.path)

        if method == "OPTIONS":
            if self.cors:
                self._reply(conn, 200, b"")
            else:
                self._reply(conn, 405, b"Method Not Allowed\n",
                            {"Allow": "GET,PUT,POST,DELETE"})
            return
        if method not in ("GET", "PUT", "POST", "DELETE", "HEAD"):
            self._reply(conn, 405, b"Method Not Allowed\n",
                        {"Allow": "GET,PUT,POST,DELETE"})
            return

        # ops plane: inline, admission-exempt — an overloaded node
        # must stay observable
        if path == _http.METRICS_PREFIX:
            self._serve_metrics(conn, method)
            return
        if path.startswith(_http.STATS_PREFIX):
            self._serve_stats(conn, method, path)
            return
        if path == _http.MACHINES_PREFIX:
            self._serve_machines(conn, method)
            return

        handler = self.extra_routes.get(path)
        if handler is not None:
            conn.mode = "busy"
            try:
                self._jobs.put_nowait(
                    (conn, conn.epoch,
                     ("route", handler, method, path, parsed.query,
                      headers, body)))
            except queue.Full:
                conn.mode = "idle"
                self._reply(conn, 503, b"overloaded\n",
                            {"Retry-After": "1"})
            return

        if path == _http.WATCH_PREFIX:
            if self.watch_redirect is not None:
                self._redirect_watch(conn, _http.WATCH_PREFIX, "")
                return
            self._serve_watch_many(conn, method, headers, body)
            return
        if path.startswith(_http.KEYS_PREFIX):
            self._serve_keys(conn, method, path, parsed.query,
                             headers, body)
            return
        self._reply(conn, 404, b"404 page not found\n")

    def _form(self, query: str, headers: dict,
              body: bytes) -> dict:
        form = urllib.parse.parse_qs(query, keep_blank_values=True)
        if body:
            ctype = headers.get("content-type", "")
            if "application/x-www-form-urlencoded" in ctype \
                    or not ctype:
                body_form = urllib.parse.parse_qs(
                    body.decode(), keep_blank_values=True)
                for k, v in form.items():
                    body_form.setdefault(k, v)
                form = body_form
        return form

    def _serve_keys(self, conn: _Conn, method: str, path: str,
                    query: str, headers: dict, body: bytes) -> None:
        if method not in ("GET", "PUT", "POST", "DELETE"):
            self._reply(conn, 405, b"Method Not Allowed\n",
                        {"Allow": "GET,PUT,POST,DELETE"})
            return
        try:
            form = self._form(query, headers, body)
            rr = self._http.parse_request(method, path, form,
                                          gen_id())
            keepalive = self.watch_keepalive
            if "keepalive" in form:
                try:
                    keepalive = float(form["keepalive"][0])
                    # non-finite values poison the timer heap (a NaN
                    # at the top can never be popped)
                    if keepalive < 0 or not math.isfinite(keepalive):
                        raise ValueError
                except ValueError:
                    raise EtcdError(
                        ECODE_INVALID_FIELD,
                        'invalid value for "keepalive"') from None
        except EtcdError as e:
            self._reply_error(conn, e)
            return
        except UnicodeDecodeError:
            self._reply(conn, 400, b"bad request\n")
            return

        tenant = parse_tenant(headers, path)
        is_write = method != "GET"
        outcome, reason, ra = self.admission.decide(tenant, is_write)
        if outcome != ADMIT:
            self._reply_error(conn, EtcdOverCapacity(
                cause=f"{tenant}: {reason}",
                index=self.etcd.store.index(), retry_after=ra))
            return

        if rr.wait:
            if self.watch_redirect is not None:
                self._redirect_watch(conn, path, query)
                return
            self._start_single_watch(conn, rr, tenant, keepalive)
            return

        self.admission.begin(tenant)
        conn.tenant = tenant
        conn.mode = "busy"
        try:
            self._jobs.put_nowait((conn, conn.epoch, rr))
        except queue.Full:
            # decide() raced a fill-up; shed honestly
            self.admission.finish(tenant)
            conn.tenant = None
            conn.mode = "idle"
            self.admission._bill(SHED_ALL, "queue_depth")
            self._reply_error(conn, EtcdOverCapacity(
                cause=f"{tenant}: queue_depth",
                index=self.etcd.store.index(), retry_after=1.0))

    def _redirect_watch(self, conn: _Conn, path: str,
                        query: str) -> None:
        """307 to the watch worker: method + body survive the hop,
        and stock HTTP clients re-issue wait GETs transparently."""
        loc = self.watch_redirect + path + (f"?{query}" if query
                                            else "")
        self._reply(conn, 307, b"", {"Location": loc})

    # -- worker pool -------------------------------------------------------

    def _worker(self) -> None:
        # _stopping is the authoritative exit signal: the None
        # sentinels shutdown() queues are best-effort wakeups that a
        # full job queue may never deliver
        while not self._stopping:
            try:
                job = self._jobs.get(timeout=0.5)
            except queue.Empty:
                continue
            if job is None:
                return
            conn, epoch, rr = job
            try:
                if type(rr) is tuple and rr[0] == "route":
                    _tag, handler, method, path, query, headers, \
                        body = rr
                    parts = handler(method, path, query, headers,
                                    body)
                else:
                    parts = self._do_request(rr)
            except Exception as e:  # pragma: no cover
                log.exception("frontdoor: worker error")
                parts = _error_parts(e)
            self._post(("resp", conn, epoch, parts, False))

    def _do_request(self, rr) -> tuple[int, dict, bytes]:
        """``(status, headers, body)`` — the loop thread assembles
        the wire response (and adds CORS headers) in the ``resp``
        completion handler."""
        try:
            resp = self.etcd.do(rr, timeout=self.server_timeout)
        except EtcdError as e:
            return _error_parts(e)
        except TimeoutError:
            return _error_parts(EtcdError(
                ECODE_RAFT_INTERNAL, "request timed out"))
        ev = resp.event
        if ev is None:  # pragma: no cover
            return _error_parts(
                RuntimeError("no event in response"))
        body = (json.dumps(ev.to_dict()) + "\n").encode()
        status = 201 if ev.is_created() else 200
        return status, {
            "Content-Type": "application/json",
            "X-Etcd-Index": str(ev.etcd_index),
            "X-Raft-Index": str(self.etcd.index()),
            "X-Raft-Term": str(self.etcd.term()),
        }, body

    # -- watch serving (threadless) ----------------------------------------

    def _watch_headers(self, conn: _Conn, etcd_index: int) -> None:
        out = bytearray(_status_line(200))
        out += b"Content-Type: application/json\r\n"
        out += f"X-Etcd-Index: {etcd_index}\r\n".encode()
        out += f"X-Raft-Index: {self.etcd.index()}\r\n".encode()
        out += f"X-Raft-Term: {self.etcd.term()}\r\n".encode()
        out += b"Transfer-Encoding: chunked\r\n"
        for k, v in self._cors_headers(conn).items():
            out += f"{k}: {v}\r\n".encode()
        out += b"\r\n"
        self._queue_bytes(conn, bytes(out))
        conn.chunked = True

    def _begin_watch(self, conn: _Conn, tenant: str, single: bool,
                     keepalive: float) -> None:
        conn.mode = "watch"
        conn.tenant = tenant
        conn.single = single
        conn.keepalive = keepalive
        conn.last_write = time.monotonic()
        conn.deadline_at = time.monotonic() + self.watch_timeout
        self._arm(conn.deadline_at, "deadline", conn)
        if keepalive:
            self._arm(time.monotonic() + keepalive, "ka", conn)

    def _start_single_watch(self, conn: _Conn, rr, tenant: str,
                            keepalive: float) -> None:
        if not self.admission.try_add_watches(tenant, 1):
            self.admission._bill(SHED_ALL, "tenant_watches")
            self._reply_error(conn, EtcdOverCapacity(
                cause=f"{tenant}: watch quota exhausted",
                index=self.etcd.store.index(), retry_after=1.0))
            return
        sink = _ConnSink(self, conn, capacity=256)
        ws = self.etcd.store.watch_many(
            [(rr.path, rr.recursive, rr.stream, rr.since)],
            mux=sink, mid_base=0)
        w = ws[0]
        if isinstance(w, EtcdError):
            sink.close()
            self.admission.release_watches(tenant, 1)
            self._reply_error(conn, w)
            return
        conn.sink = sink
        conn.watchers = ws
        conn.open_members = 1
        conn.watch_count = 1
        # enter watch mode BEFORE the first write: _flush tears an
        # idle conn down the moment close_after's bytes drain
        self._begin_watch(conn, tenant, single=True,
                          keepalive=(keepalive if rr.stream else 0.0))
        self._watch_headers(conn, w.start_index)
        if w.replay is not None:
            self._replay_member(conn, w, 0,
                                (rr.path, rr.recursive))
        self._drain_watch(conn)

    def _serve_watch_many(self, conn: _Conn, method: str,
                          headers: dict, body: bytes) -> None:
        _http = self._http
        if method != "POST":
            self._reply(conn, 405, b"Method Not Allowed\n",
                        {"Allow": "POST"})
            return
        try:
            doc = json.loads(body or b"[]")
            if not isinstance(doc, list) \
                    or len(doc) > _http.WATCH_BATCH_MAX:
                raise ValueError("bad batch")
            specs = [(str(d.get("key", "/")),
                      bool(d.get("recursive", False)),
                      bool(d.get("stream", True)),
                      int(d.get("since", 0)))
                     for d in doc]
        except (ValueError, TypeError, AttributeError,
                json.JSONDecodeError):
            self._reply_error(conn, EtcdError(
                ECODE_INVALID_FORM,
                "watch batch must be a JSON array of watch specs "
                f"(max {_http.WATCH_BATCH_MAX})"))
            return

        tenant = parse_tenant(headers, "")
        outcome, reason, ra = self.admission.decide(tenant, False)
        if outcome != ADMIT:
            self._reply_error(conn, EtcdOverCapacity(
                cause=f"{tenant}: {reason}",
                index=self.etcd.store.index(), retry_after=ra))
            return
        # the whole batch is checked against the tenant's watch quota
        # AT REGISTRATION — a quota breach is a typed 429 before the
        # stream opens, never a mid-stream eviction
        if not self.admission.try_add_watches(tenant, len(specs)):
            self.admission._bill(SHED_ALL, "tenant_watches")
            self._reply_error(conn, EtcdOverCapacity(
                cause=f"{tenant}: watch quota exhausted "
                      f"({len(specs)} requested)",
                index=self.etcd.store.index(), retry_after=1.0))
            return

        sink = _ConnSink(self, conn, capacity=max(
            4096, 2 * _http.WATCH_REG_CHUNK))
        conn.sink = sink
        conn.watchers = []
        conn.open_members = 0
        conn.watch_count = len(specs)
        # watch mode first, then the first write (see
        # _start_single_watch)
        self._begin_watch(conn, tenant, single=False,
                          keepalive=self.watch_keepalive)
        self._watch_headers(conn, self.etcd.store.index())

        for base in range(0, len(specs), _http.WATCH_REG_CHUNK):
            ws = self.etcd.store.watch_many(
                specs[base:base + _http.WATCH_REG_CHUNK], mux=sink,
                mid_base=base)
            conn.watchers.extend(ws)
            for i, w in enumerate(ws, start=base):
                if isinstance(w, EtcdError):
                    self._queue_chunk(conn, (json.dumps(
                        {"watch": i,
                         "error": json.loads(w.to_json())})
                        + "\n").encode())
                else:
                    conn.open_members += 1
            for j, w in enumerate(ws):
                if getattr(w, "replay", None) is not None:
                    self._replay_member(conn, w, base + j,
                                        specs[base + j])
            if conn.mode != "watch":
                return  # slow-consumer eviction mid-registration
            self._drain_watch(conn, end_ok=False)
        self._drain_watch(conn)

    def _replay_member(self, conn: _Conn, w, mid: int,
                       spec) -> None:
        """History catch-up ``[w.replay, w.since_index)`` straight to
        the wire (same contract as api/http.py's replay: live
        dispatch neither overlaps nor gaps it)."""
        key = clean_path(spec[0])
        recursive = spec[1]
        eh = self.etcd.store.watcher_hub.event_history
        nxt = w.replay
        while nxt < w.since_index and conn.mode != "closed":
            try:
                ev = eh.scan(key, recursive, nxt)
            except EtcdError as err:
                if not conn.single:
                    self._queue_chunk(conn, (json.dumps(
                        {"watch": mid,
                         "error": json.loads(err.to_json())})
                        + "\n").encode())
                w.remove()  # closed marker arrives via the sink
                return
            if ev is None or ev.index() >= w.since_index:
                return
            if conn.single:
                line = ev.to_dict()
            else:
                line = {"watch": mid}
                line.update(ev.to_dict())
            self._queue_chunk(conn, (json.dumps(line)
                                     + "\n").encode())
            nxt = ev.index() + 1

    def _drain_watch(self, conn: _Conn, end_ok: bool = True) -> None:
        sink = conn.sink
        if sink is None or conn.mode != "watch":
            return
        got_event = False
        while True:
            item = sink.pop(timeout=0)
            if item is None:
                break
            mid, ev = item
            if ev is None:
                conn.open_members -= 1
                if not conn.single:
                    self._queue_chunk(conn, (json.dumps(
                        {"watch": mid, "closed": True})
                        + "\n").encode())
                continue
            if conn.single:
                line = ev.to_dict()
            else:
                line = {"watch": mid}
                line.update(ev.to_dict())
            self._queue_chunk(conn, (json.dumps(line)
                                     + "\n").encode())
            got_event = True
            if conn.mode != "watch":
                return  # evicted while writing
        if conn.single and got_event and conn.watchers \
                and not getattr(conn.watchers[0], "stream", True):
            # one-shot long-poll: first event ends the exchange
            self._end_watch(conn)
            return
        if end_ok and conn.open_members <= 0:
            self._end_watch(conn)

    def _close_watch_state(self, conn: _Conn) -> None:
        """Release watch resources: sink FIRST so the batched
        removal's member closes are no-ops, then hub removal, then
        the quota."""
        sink, watchers = conn.sink, conn.watchers
        conn.sink = None
        conn.watchers = None
        if sink is not None:
            sink.close()
        if watchers:
            self.etcd.store.watcher_hub.remove_many(watchers)
        if conn.watch_count and conn.tenant is not None:
            self.admission.release_watches(conn.tenant,
                                           conn.watch_count)
        conn.watch_count = 0
        conn.tenant = None
        conn.open_members = 0

    def _end_watch(self, conn: _Conn) -> None:
        if conn.mode != "watch":
            return
        self._close_watch_state(conn)
        self._queue_chunk(conn, b"")  # terminating chunk
        conn.chunked = False
        conn.single = False
        conn.mode = "idle"
        if conn.mode == "idle" and not conn.close_after:
            self._process_rbuf(conn)
        elif conn.close_after and not conn.out:
            self._teardown(conn)

    # -- ops plane ---------------------------------------------------------

    def _serve_metrics(self, conn: _Conn, method: str) -> None:
        if method != "GET":
            self._reply(conn, 405, b"Method Not Allowed\n",
                        {"Allow": "GET"})
            return
        from ..obs.exporter import CONTENT_TYPE, render_prometheus

        self._reply(conn, 200, render_prometheus(_obs.registry),
                    {"Content-Type": CONTENT_TYPE})

    def _serve_stats(self, conn: _Conn, method: str,
                     path: str) -> None:
        if method != "GET":
            self._reply(conn, 405, b"Method Not Allowed\n",
                        {"Allow": "GET"})
            return
        sub = path[len(self._http.STATS_PREFIX):].strip("/")
        if sub == "store":
            body = self.etcd.store.json_stats()
        elif sub == "self":
            body = self.etcd.server_stats.to_json()
        elif sub == "leader":
            body = self.etcd.leader_stats.to_json()
        elif sub == "spans":
            from ..utils.trace import tracer

            body = tracer.snapshot_json()
        elif sub == "slo":
            # declared-objective burn-rate verdict over the
            # windowed-delta ring
            from ..obs import slo as _slo

            body = _slo.default_verdict_json()
        elif sub == "timeseries":
            from ..obs import timeseries as _timeseries

            body = _timeseries.start_default().snapshot_json()
        elif sub == "frontdoor":
            body = self.stats_json()
        else:
            self._reply(conn, 404, b"404 page not found\n")
            return
        self._reply(conn, 200, body,
                    {"Content-Type": "application/json"})

    def _serve_machines(self, conn: _Conn, method: str) -> None:
        if method not in ("GET", "HEAD"):
            self._reply(conn, 405, b"Method Not Allowed\n",
                        {"Allow": "GET,HEAD"})
            return
        endpoints = self.etcd.cluster_store.get().client_urls_all()
        body = ", ".join(endpoints).encode()
        if method == "HEAD":
            h = bytearray(_status_line(200))
            for k, v in self._cors_headers(conn).items():
                h += f"{k}: {v}\r\n".encode()
            h += f"Content-Length: {len(body)}\r\n\r\n".encode()
            self._queue_bytes(conn, bytes(h))
            return
        self._reply(conn, 200, body)


def _mask_readable(mask: int) -> bool:
    return bool(mask & selectors.EVENT_READ)


def _mask_writable(mask: int) -> bool:
    return bool(mask & selectors.EVENT_WRITE)


def serve_frontdoor(etcd, host: str, port: int, ssl_context=None,
                    cors: set[str] | None = None,
                    config: FrontDoorConfig | None = None, **kw):
    """Start the event-driven front door on ``host:port``; returns an
    object with the ``_Server`` surface (``server_address``,
    ``shutdown()``).

    TLS listeners fall back to the threaded server: a non-blocking
    TLS handshake state machine is out of scope here, and the
    admission-relevant deployments terminate TLS in front."""
    if ssl_context is not None:
        from ..api import http as _http

        log.info("frontdoor: TLS listener falls back to the "
                 "threaded server")
        return _http.serve(_http.make_client_handler(etcd, cors=cors,
                                                     **kw),
                           host, port, ssl_context)
    fd = FrontDoor(etcd, host, port,
                   config=config or FrontDoorConfig.from_env(
                       os.environ),
                   cors=cors, **kw)
    return fd.start()
