"""HTTP client API (reference etcdserver/etcdhttp/http.go; the port's
copy of ``etcd_tpu/api/http.py``, client side only).

The client mux serves /v2/keys (GET with wait/stream/quorum; PUT with
set/update/create/CAS via prevExist/prevValue/prevIndex; POST unique
in-order create; DELETE with CAD), the batched /v2/watch stream,
/v2/machines and /v2/stats/{self,store,leader,spans}.  Response headers
carry X-Etcd-Index / X-Raft-Index / X-Raft-Term on every reply
(http.go:331-334).  Not ported yet: the peer mux (/raft), /metrics,
/v2/stats/slo and /v2/stats/timeseries, and the ``http.client``
failpoint; they come with the servers and tooling that use them.
"""

from __future__ import annotations

import json
import logging
import math
import queue
import socketserver
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..server.server import gen_id
from ..utils.errors import (
    ECODE_INDEX_NAN,
    ECODE_INVALID_FIELD,
    ECODE_INVALID_FORM,
    ECODE_RAFT_INTERNAL,
    ECODE_TTL_NAN,
    EtcdError,
)
from ..wire.requests import Request

log = logging.getLogger(__name__)

KEYS_PREFIX = "/v2/keys"
WATCH_PREFIX = "/v2/watch"
MACHINES_PREFIX = "/v2/machines"
STATS_PREFIX = "/v2/stats"

#: listen backlog of the client server: the socketserver default of 5
#: resets a connection burst in the kernel (the reference's front door
#: module holds the same constant)
LISTEN_BACKLOG = 1024

DEFAULT_SERVER_TIMEOUT = 0.5  # reference http.go:29
DEFAULT_WATCH_TIMEOUT = 300.0  # reference http.go:32
# blank-line chunk cadence on idle streaming watches so proxies and
# client read timeouts don't tear down a healthy stream
DEFAULT_WATCH_KEEPALIVE = 25.0
# /v2/watch batched registration cap: one request may register this
# many watches over one multiplexed stream
WATCH_BATCH_MAX = 200_000
# specs registered per hub-lock take on /v2/watch; history catch-up
# drains to the wire between chunks so the mux never has to hold a
# whole reconnect storm's replay
WATCH_REG_CHUNK = 512


def parse_request(method: str, path: str, form: dict[str, list[str]],
                  id: int) -> Request:
    """Validate form fields into a Request
    (reference http.go:148-285)."""

    def bad(code, cause):
        return EtcdError(code, cause)

    if not path.startswith(KEYS_PREFIX):
        raise bad(ECODE_INVALID_FORM, "incorrect key prefix")
    p = path[len(KEYS_PREFIX):]

    def get_uint64(key):
        vals = form.get(key)
        if not vals:
            return 0
        try:
            v = int(vals[0])
            if v < 0 or v >= 1 << 64:
                raise ValueError
            return v
        except ValueError:
            raise bad(ECODE_INDEX_NAN, f'invalid value for "{key}"') \
                from None

    def get_bool(key, code=ECODE_INVALID_FIELD):
        vals = form.get(key)
        if not vals:
            return False
        v = vals[0].lower()
        # Go strconv.ParseBool accepted values
        if v in ("1", "t", "true"):
            return True
        if v in ("0", "f", "false"):
            return False
        raise bad(code, f'invalid value for "{key}"')

    p_idx = get_uint64("prevIndex")
    w_idx = get_uint64("waitIndex")

    rec = get_bool("recursive")
    sort = get_bool("sorted")
    wait = get_bool("wait")
    dir = get_bool("dir")
    stream = get_bool("stream")

    if wait and method != "GET":
        raise bad(ECODE_INVALID_FIELD,
                  '"wait" can only be used with GET requests')

    p_v = form.get("prevValue", [""])[0]
    if "prevValue" in form and p_v == "":
        raise bad(ECODE_INVALID_FIELD, '"prevValue" cannot be empty')

    ttl = None
    ttl_vals = form.get("ttl")
    if ttl_vals and len(ttl_vals[0]) > 0:
        try:
            ttl = int(ttl_vals[0])
            if ttl < 0:
                raise ValueError
        except ValueError:
            raise bad(ECODE_TTL_NAN, 'invalid value for "ttl"') from None

    pe = None
    if "prevExist" in form:
        pe = get_bool("prevExist")

    rr = Request(
        id=id,
        method=method,
        path=p,
        val=form.get("value", [""])[0],
        dir=dir,
        prev_value=p_v,
        prev_index=p_idx,
        prev_exist=pe,
        recursive=rec,
        since=w_idx,
        sorted=sort,
        stream=stream,
        wait=wait,
        quorum=get_bool("quorum"),
        # consistency knob: GETs are linearizable by default on
        # the dist tier (lease/ReadIndex/follower-wait, no WAL);
        # ?serializable=true opts back into the possibly-stale
        # local-replica read, ?quorum=true remains the
        # through-the-log QGET
        serializable=get_bool("serializable"),
    )

    if ttl is not None:
        rr.expiration = int((time.time() + ttl) * 1e9)

    return rr


class EtcdRequestHandler(BaseHTTPRequestHandler):
    """One handler class; the server instance carries the routing
    config (CORS origins, timeouts)."""

    protocol_version = "HTTP/1.1"
    # injected by make_client_handler: the co-hosted MultiGroupServer
    etcd = None
    cors: set[str] | None = None
    server_timeout = DEFAULT_SERVER_TIMEOUT
    watch_timeout = DEFAULT_WATCH_TIMEOUT
    watch_keepalive = DEFAULT_WATCH_KEEPALIVE

    def log_message(self, fmt, *args):  # quiet by default
        log.debug("http: " + fmt, *args)

    # -- plumbing ----------------------------------------------------------

    def _form(self) -> dict[str, list[str]]:
        parsed = urllib.parse.urlsplit(self.path)
        form = urllib.parse.parse_qs(parsed.query, keep_blank_values=True)
        length = int(self.headers.get("Content-Length") or 0)
        if length:
            ctype = self.headers.get("Content-Type", "")
            body = self.rfile.read(length)
            if "application/x-www-form-urlencoded" in ctype or not ctype:
                body_form = urllib.parse.parse_qs(
                    body.decode(), keep_blank_values=True)
                # body values take precedence (Go ParseForm order)
                for k, v in form.items():
                    body_form.setdefault(k, v)
                form = body_form
            else:
                self._raw_body = body
        return form

    def _reply(self, status: int, body: bytes,
               headers: dict | None = None) -> None:
        self.send_response(status)
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self._cors_headers()
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _cors_headers(self) -> None:
        if not self.cors:
            return
        origin = self.headers.get("Origin", "")
        if "*" in self.cors:
            allow = "*"
        elif origin in self.cors:
            allow = origin
        else:
            return
        self.send_header("Access-Control-Allow-Methods",
                         "POST, GET, OPTIONS, PUT, DELETE")
        self.send_header("Access-Control-Allow-Origin", allow)
        self.send_header("Access-Control-Allow-Headers",
                         "accept, content-type")

    def _write_error(self, err: Exception) -> None:
        if isinstance(err, EtcdError):
            body = (err.to_json() + "\n").encode()
            self._reply(err.http_status(), body, {
                "Content-Type": "application/json",
                "X-Etcd-Index": str(err.index),
            })
        else:
            log.warning("http: internal error: %s", err)
            self._reply(500, b"Internal Server Error\n")

    def _write_event(self, ev) -> None:
        """Reference writeEvent (http.go:327-341)."""
        body = (json.dumps(ev.to_dict()) + "\n").encode()
        status = 201 if ev.is_created() else 200
        self._reply(status, body, {
            "Content-Type": "application/json",
            "X-Etcd-Index": str(ev.etcd_index),
            "X-Raft-Index": str(self.etcd.index()),
            "X-Raft-Term": str(self.etcd.term()),
        })

    # -- dispatch ----------------------------------------------------------

    def _route(self, method: str) -> None:
        # Go's req.URL.Path arrives percent-decoded; decode so keys
        # with spaces/escapes land in the same namespace
        path = urllib.parse.unquote(
            urllib.parse.urlsplit(self.path).path)
        try:
            if path == WATCH_PREFIX:
                self._serve_watch_many(method)
            elif path == MACHINES_PREFIX:
                self._serve_machines(method)
            elif path.startswith(STATS_PREFIX):
                self._serve_stats(method, path)
            elif path.startswith(KEYS_PREFIX):
                self._serve_keys(method)
            else:
                self._reply(404, b"404 page not found\n")
        except BrokenPipeError:
            pass
        except Exception as e:  # pragma: no cover
            log.exception("http: handler error")
            try:
                self._write_error(e)
            except Exception:
                pass

    def do_GET(self):
        self._route("GET")

    def do_PUT(self):
        self._route("PUT")

    def do_POST(self):
        self._route("POST")

    def do_DELETE(self):
        self._route("DELETE")

    def do_HEAD(self):
        self._route("HEAD")

    def __getattr__(self, name):
        # unknown HTTP methods get 405 + Allow (reference allowMethod,
        # http.go:391-400), not BaseHTTPRequestHandler's 501
        if name.startswith("do_"):
            return self._method_not_allowed
        raise AttributeError(name)

    def _method_not_allowed(self):
        self._reply(405, b"Method Not Allowed\n",
                    {"Allow": "GET,PUT,POST,DELETE"})

    def do_OPTIONS(self):
        if self.cors:
            self.send_response(200)
            self._cors_headers()
            self.send_header("Content-Length", "0")
            self.end_headers()
        else:
            self._reply(405, b"Method Not Allowed\n",
                        {"Allow": "GET,PUT,POST,DELETE"})

    # -- endpoints ---------------------------------------------------------

    def _serve_keys(self, method: str) -> None:
        """Reference serveKeys (http.go:74-107)."""
        if method not in ("GET", "PUT", "POST", "DELETE"):
            self._reply(405, b"Method Not Allowed\n",
                        {"Allow": "GET,PUT,POST,DELETE"})
            return
        try:
            form = self._form()
            rr = parse_request(
                method,
                urllib.parse.unquote(
                    urllib.parse.urlsplit(self.path).path),
                form, gen_id())
            # per-request keepalive override for streaming watches:
            # ?keepalive=SECONDS (0 disables) — the escape hatch for
            # clients that JSON-parse every line and can't skip the
            # blank keepalive chunks
            keepalive = self.watch_keepalive
            if "keepalive" in form:
                try:
                    keepalive = float(form["keepalive"][0])
                    # reject non-finite values (NaN compares False
                    # against every bound yet is truthy)
                    if keepalive < 0 or not math.isfinite(keepalive):
                        raise ValueError
                except ValueError:
                    raise EtcdError(ECODE_INVALID_FIELD,
                                    'invalid value for "keepalive"') \
                        from None
        except EtcdError as e:
            self._write_error(e)
            return

        try:
            resp = self.etcd.do(rr, timeout=self.server_timeout
                                if not rr.wait else None)
        except EtcdError as e:
            self._write_error(e)
            return
        except TimeoutError:
            self._write_error(EtcdError(ECODE_RAFT_INTERNAL,
                                        "request timed out"))
            return

        if resp.event is not None:
            self._write_event(resp.event)
        elif resp.watcher is not None:
            self._handle_watch(resp.watcher, rr.stream, keepalive)
        else:  # pragma: no cover
            self._write_error(RuntimeError("no event/watcher"))

    def _serve_watch_many(self, method: str) -> None:
        """POST /v2/watch — batched watch registration + ONE
        multiplexed chunked stream (no reference counterpart —
        100k discovery watches must not cost 100k hub-lock round
        trips and 100k connections).

        Body: JSON array of ``{"key", "recursive", "stream",
        "since"}`` specs (stream defaults true).  The reply streams
        JSON lines tagged with the spec position: ``{"watch": i,
        ...event}``, ``{"watch": i, "closed": true}`` when a member
        was evicted or fired one-shot, ``{"watch": i, "error":
        {...}}`` for a spec a compacted history rejected; blank lines
        are keepalives."""
        if method != "POST":
            self._reply(405, b"Method Not Allowed\n", {"Allow": "POST"})
            return
        length = int(self.headers.get("Content-Length") or 0)
        try:
            doc = json.loads(self.rfile.read(length) or b"[]")
            if not isinstance(doc, list) or len(doc) > WATCH_BATCH_MAX:
                raise ValueError("bad batch")
            specs = [(str(d.get("key", "/")),
                      bool(d.get("recursive", False)),
                      bool(d.get("stream", True)),
                      int(d.get("since", 0)))
                     for d in doc]
        except (ValueError, TypeError, AttributeError,
                json.JSONDecodeError):
            self._write_error(EtcdError(
                ECODE_INVALID_FORM,
                "watch batch must be a JSON array of watch specs "
                f"(max {WATCH_BATCH_MAX})"))
            return

        from ..store.fanout import WatchMux

        mux = WatchMux(capacity=max(4096, 2 * WATCH_REG_CHUNK))
        watchers: list = []
        open_members = 0
        try:
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("X-Etcd-Index",
                             str(self.etcd.store.index()))
            self.send_header("Transfer-Encoding", "chunked")
            self._cors_headers()
            self.end_headers()
            self.wfile.flush()

            def flush_mux() -> int:
                """Write everything queued; returns members closed."""
                closed = 0
                while True:
                    item = mux.pop(timeout=0)
                    if item is None:
                        return closed
                    mid, ev = item
                    if ev is None:
                        line = {"watch": mid, "closed": True}
                        closed += 1
                    else:
                        line = {"watch": mid}
                        line.update(ev.to_dict())
                    self._write_chunk((json.dumps(line)
                                       + "\n").encode())

            # register in chunks (bounded hub-lock takes), then stream
            # each lagging member's history catch-up STRAIGHT to the
            # wire: a member can lag a whole history window, and
            # buffering any batch's replay in the bounded mux would
            # evict it during registration — the mux carries only
            # live events (dispatched past each member's advanced
            # since-index), replay reads the history ring outside
            # every lock at the connection's own pace
            for base in range(0, len(specs), WATCH_REG_CHUNK):
                ws = self.etcd.store.watch_many(
                    specs[base:base + WATCH_REG_CHUNK], mux=mux,
                    mid_base=base)
                watchers.extend(ws)
                for i, w in enumerate(ws, start=base):
                    if isinstance(w, EtcdError):
                        self._write_chunk((json.dumps(
                            {"watch": i,
                             "error": json.loads(w.to_json())})
                            + "\n").encode())
                    else:
                        open_members += 1
                for j, w in enumerate(ws):
                    if getattr(w, "replay", None) is not None:
                        self._replay_member(w, base + j,
                                            specs[base + j])
                open_members -= flush_mux()

            deadline = time.monotonic() + self.watch_timeout
            last_write = time.monotonic()
            while open_members > 0:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    break
                item = mux.pop(timeout=min(remain, 1.0))
                if item is None:
                    if self.watch_keepalive and \
                            (time.monotonic() - last_write
                             >= self.watch_keepalive):
                        self._write_chunk(b"\n")
                        last_write = time.monotonic()
                    continue
                mid, ev = item
                if ev is None:
                    # member closed (evicted or fired one-shot); the
                    # stream ends once every member has
                    line = {"watch": mid, "closed": True}
                    open_members -= 1
                else:
                    line = {"watch": mid}
                    line.update(ev.to_dict())
                self._write_chunk((json.dumps(line) + "\n").encode())
                last_write = time.monotonic()
        except (BrokenPipeError, ConnectionResetError):
            pass
        finally:
            # close the mux FIRST so the batched removal's member
            # closes become no-ops instead of 100k queued markers
            mux.close()
            self.etcd.store.watcher_hub.remove_many(watchers)
            try:
                self._write_chunk(b"")  # terminating chunk
            except (BrokenPipeError, ConnectionResetError):
                pass

    def _replay_member(self, w, mid: int, spec) -> None:
        """Stream one mux member's deferred history catch-up
        ``[w.replay, w.since_index)`` to the wire — live dispatch
        (which starts at ``since_index``) neither overlaps nor gaps
        it.  A compaction that outruns the replay surfaces as an
        honest per-member error + closure."""
        from ..store import clean_path
        from ..utils.errors import EtcdError as _EE

        key = clean_path(spec[0])
        recursive = spec[1]
        eh = self.etcd.store.watcher_hub.event_history
        nxt = w.replay
        while nxt < w.since_index:
            try:
                ev = eh.scan(key, recursive, nxt)
            except _EE as err:
                self._write_chunk((json.dumps(
                    {"watch": mid,
                     "error": json.loads(err.to_json())})
                    + "\n").encode())
                w.remove()  # closed marker arrives via the mux
                return
            if ev is None or ev.index() >= w.since_index:
                return
            line = {"watch": mid}
            line.update(ev.to_dict())
            self._write_chunk((json.dumps(line) + "\n").encode())
            nxt = ev.index() + 1

    def _serve_stats(self, method: str, path: str) -> None:
        """/v2/stats/{self,store,leader} — observability endpoints
        (new work: the 0.5-alpha reference collects
        store counters but never wires an HTTP stats route)."""
        if method != "GET":
            self._reply(405, b"Method Not Allowed\n", {"Allow": "GET"})
            return
        sub = path[len(STATS_PREFIX):].strip("/")
        if sub == "store":
            body = self.etcd.store.json_stats()
        elif sub == "self":
            body = self.etcd.server_stats.to_json()
        elif sub == "leader":
            body = self.etcd.leader_stats.to_json()
        elif sub == "spans":
            # host-span latency aggregates (no reference counterpart:
            # 0.5-alpha has no stats route at all, let alone tracing)
            from ..utils.trace import tracer

            body = tracer.snapshot_json()
        else:
            self._reply(404, b"404 page not found\n")
            return
        self._reply(200, body,
                    {"Content-Type": "application/json"})

    def _serve_machines(self, method: str) -> None:
        """Reference serveMachines (http.go:111-117)."""
        if method not in ("GET", "HEAD"):
            self._reply(405, b"Method Not Allowed\n",
                        {"Allow": "GET,HEAD"})
            return
        endpoints = self.etcd.cluster_store.get().client_urls_all()
        body = ", ".join(endpoints).encode()
        if method == "HEAD":
            # RFC 7231: HEAD carries headers only
            self.send_response(200)
            self._cors_headers()
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            return
        self._reply(200, body)

    def _handle_watch(self, watcher, stream: bool,
                      keepalive: float | None = None) -> None:
        """Long-poll / chunked streaming watch
        (reference handleWatch, http.go:343-386)."""
        if keepalive is None:
            keepalive = self.watch_keepalive
        try:
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("X-Etcd-Index", str(watcher.start_index))
            self.send_header("X-Raft-Index", str(self.etcd.index()))
            self.send_header("X-Raft-Term", str(self.etcd.term()))
            self.send_header("Transfer-Encoding", "chunked")
            self._cors_headers()
            self.end_headers()
            self.wfile.flush()

            deadline = time.monotonic() + self.watch_timeout
            last_write = time.monotonic()
            while True:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    break
                ev = watcher.next_event(timeout=min(remain, 1.0))
                if ev is None:
                    if watcher.removed:
                        break
                    # idle stream keepalive: a blank JSON line (a
                    # chunk clients skip) so read timeouts and
                    # middleboxes don't reap a healthy stream
                    if stream and keepalive and \
                            (time.monotonic() - last_write
                             >= keepalive):
                        self._write_chunk(b"\n")
                        last_write = time.monotonic()
                    continue
                body = (json.dumps(ev.to_dict()) + "\n").encode()
                self._write_chunk(body)
                last_write = time.monotonic()
                if not stream:
                    break
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            pass
        finally:
            watcher.remove()
            try:
                self._write_chunk(b"")  # terminating chunk
            except (BrokenPipeError, ConnectionResetError):
                pass

    def _write_chunk(self, data: bytes) -> None:
        self.wfile.write(f"{len(data):x}\r\n".encode())
        self.wfile.write(data)
        self.wfile.write(b"\r\n")
        self.wfile.flush()


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    request_queue_size = LISTEN_BACKLOG


def _make_handler_class(etcd, cors: set[str] | None = None,
                        server_timeout: float = DEFAULT_SERVER_TIMEOUT,
                        watch_timeout: float = DEFAULT_WATCH_TIMEOUT,
                        watch_keepalive: float = DEFAULT_WATCH_KEEPALIVE):
    return type("Handler", (EtcdRequestHandler,), {
        "etcd": etcd,
        "cors": cors,
        "server_timeout": server_timeout,
        "watch_timeout": watch_timeout,
        "watch_keepalive": watch_keepalive,
    })


def make_client_handler(etcd, cors: set[str] | None = None, **kw):
    """Reference NewClientHandler (http.go:38-53): ``etcd`` is the
    server that answers (``do``, ``index``, ``term``, ``store``,
    ``cluster_store``, the stats objects)."""
    return _make_handler_class(etcd, cors, **kw)


def serve(handler_class, host: str, port: int,
          ssl_context=None) -> _Server:
    """Start an HTTP server thread; returns the server (shutdown() to
    stop)."""
    httpd = _Server((host, port), handler_class)
    if ssl_context is not None:
        httpd.socket = ssl_context.wrap_socket(httpd.socket,
                                               server_side=True)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd
