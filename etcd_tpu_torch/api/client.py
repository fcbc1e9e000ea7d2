"""Python client library for the v2 API (reference client/http.go,
client.go: Create/Get/Watch actions over HTTP with cancellable
round trips and long-poll watchers; the port's copy of
``etcd_tpu/api/client.py``).

The batch-endpoint methods (``get_many``/
``propose_many``, the /mraft peer-tier lanes) use opportunistic
binary framing: the client advertises ``Accept:
application/x-etcd-batch`` on every batch call and upgrades to the
fixed-width wire only after the server answers in kind — a
JSON-only server (or proxy that strips the reply Content-Type)
degrades the client to HTTP+JSON with zero failed ops, counted in
``etcd_client_wire_fallback_total``, never silent."""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.parse
import urllib.request

from ..obs import metrics as _obs
from ..utils.backoff import Backoff
from ..wire import clientmsg
from ..wire.distmsg import FrameError


class ClientError(Exception):
    def __init__(self, code: int, body: dict | str):
        self.code = code
        self.body = body
        super().__init__(f"HTTP {code}: {body}")


class Client:
    """Minimal v2 client (the reference's is just what discovery
    needs; ours adds delete/set for the CLI and tests)."""

    def __init__(self, endpoints: list[str], timeout: float = 5.0,
                 tls_info=None, retries: int = 0,
                 wire: str = "auto"):
        """``tls_info`` (utils.transport.TLSInfo): client context for
        https endpoints — client-cert auth + CA verification
        (reference pkg/transport/listener.go:114-135).

        ``retries``: extra full endpoint sweeps after every endpoint
        failed to connect, paced by the shared jittered backoff
        (``etcd_backoff_retries_total{site="client"}``).  Default 0
        keeps the historical fail-fast behavior; drills and
        long-lived clients opt in."""
        if not endpoints:
            raise ValueError("no endpoints")
        self.endpoints = [e.rstrip("/") for e in endpoints]
        self.timeout = timeout
        self.retries = retries
        self._ssl = None
        if tls_info is not None and not tls_info.empty():
            self._ssl = tls_info.client_context()
        # batch-wire negotiation state: "auto" advertises
        # the binary framing and upgrades on the first binary reply;
        # "binary" means negotiated (request bodies upgrade too);
        # "json" is the sticky fallback — either forced by the
        # caller or entered after a non-binary reply / decode error
        # (counted in etcd_client_wire_fallback_total).
        if wire not in ("auto", "json"):
            raise ValueError(f"wire must be auto|json, got {wire!r}")
        self._wire = wire

    # -- http --------------------------------------------------------------

    def _request(self, method: str, path: str,
                 params: dict | None = None,
                 data: bytes | None = None,
                 content_type: str | None = None,
                 timeout: float | None = None,
                 accept: str | None = None):
        """One request attempt per endpoint until one connects: the
        single copy of the failover + error-vocabulary policy.
        Returns the OPEN response (caller reads or streams it);
        HTTP errors surface as ClientError, dead endpoints are
        skipped.  With ``retries`` set, a fully-failed endpoint
        sweep re-runs after a shared jittered-backoff wait (an
        answered-but-erroring endpoint still fails fast: an HTTP
        error is an answer, not an outage).

        Exception to fail-fast: a 429/503 carrying
        ``Retry-After`` is an admission-control shed.  It retries the
        SAME endpoint after honoring the server's pacing hint (floored
        by the shared jittered backoff, billed to
        ``etcd_backoff_retries_total{site="admission"}``) — failing
        over a shed request to another node defeats the shed and turns
        one overloaded member into a cluster-wide retry storm."""
        last_err: Exception = ClientError(0, "no endpoints tried")
        backoff = None
        admission_backoff = None
        shed_budget = self.retries
        for sweep in range(self.retries + 1):
            for ep in self.endpoints:
                url = ep + path
                if params:
                    url += "?" + urllib.parse.urlencode(params)
                while True:
                    req = urllib.request.Request(url, data=data,
                                                 method=method)
                    if content_type:
                        req.add_header("Content-Type", content_type)
                    if accept:
                        req.add_header("Accept", accept)
                    try:
                        return urllib.request.urlopen(
                            req, timeout=timeout or self.timeout,
                            context=self._ssl)
                    except urllib.error.HTTPError as e:
                        body = e.read().decode()
                        try:
                            parsed = json.loads(body)
                        except json.JSONDecodeError:
                            parsed = body
                        retry_after = e.headers.get("Retry-After") \
                            if e.headers else None
                        if e.code in (429, 503) and retry_after \
                                and shed_budget > 0:
                            shed_budget -= 1
                            if admission_backoff is None:
                                admission_backoff = Backoff(
                                    base=0.25, cap=30.0,
                                    site="admission")
                            try:
                                hint = float(retry_after)
                            except ValueError:
                                hint = 0.0
                            # clamp the server's hint: a buggy or
                            # hostile Retry-After must not park the
                            # caller beyond the backoff cap
                            time.sleep(min(
                                max(hint, admission_backoff.next()),
                                30.0))
                            continue  # same endpoint, paced
                        raise ClientError(e.code, parsed) from None
                    except (urllib.error.URLError, OSError) as e:
                        last_err = e
                        break  # next endpoint
            if sweep < self.retries:
                if backoff is None:
                    backoff = Backoff(base=0.25, cap=5.0,
                                      site="client")
                time.sleep(backoff.next())
        raise last_err

    def _do(self, method: str, path: str, params: dict | None = None,
            form: dict | None = None, timeout: float | None = None):
        data = urllib.parse.urlencode(form).encode() if form else None
        with self._request(
                method, "/v2/keys" + path, params, data,
                "application/x-www-form-urlencoded" if data else None,
                timeout) as resp:
            body = resp.read().decode()
            out = json.loads(body) if body.strip() else {}
            out["etcdIndex"] = int(
                resp.headers.get("X-Etcd-Index") or 0)
            return out

    # -- actions (reference client/http.go:184-247) ------------------------

    def create(self, key: str, value: str, ttl: int | None = None):
        form = {"value": value, "prevExist": "false"}
        if ttl is not None:
            form["ttl"] = str(ttl)
        return self._do("PUT", key, form=form)

    def set(self, key: str, value: str, ttl: int | None = None, **extra):
        form = {"value": value}
        if ttl is not None:
            form["ttl"] = str(ttl)
        form.update({k: str(v) for k, v in extra.items()})
        return self._do("PUT", key, form=form)

    def get(self, key: str, recursive: bool = False, sorted: bool = False,
            quorum: bool = False, serializable: bool = False):
        """``quorum`` forces the through-the-log read; default GETs
        are linearizable on the dist tier (leader lease / batched
        ReadIndex / follower wait-point —); ``serializable``
        opts back into the possibly-stale local-replica read."""
        params = {}
        if recursive:
            params["recursive"] = "true"
        if sorted:
            params["sorted"] = "true"
        if quorum:
            params["quorum"] = "true"
        if serializable:
            params["serializable"] = "true"
        return self._do("GET", key, params=params)

    def delete(self, key: str, recursive: bool = False, dir: bool = False,
               **extra):
        params = {}
        if recursive:
            params["recursive"] = "true"
        if dir:
            params["dir"] = "true"
        params.update({k: str(v) for k, v in extra.items()})
        return self._do("DELETE", key, params=params)

    def watch(self, key: str, wait_index: int | None = None,
              recursive: bool = False, timeout: float | None = None):
        """Single long-poll watch (reference Watcher.Next,
        client/http.go:164-177)."""
        params = {"wait": "true"}
        if wait_index is not None:
            params["waitIndex"] = str(wait_index)
        if recursive:
            params["recursive"] = "true"
        return self._do("GET", key, params=params,
                        timeout=timeout or 330.0)

    def watch_stream(self, key: str, wait_index: int | None = None,
                     recursive: bool = False,
                     timeout: float | None = None):
        """Streaming watch generator (?wait=true&stream=true):
        yields one event dict per change on a single chunked
        connection; blank keepalive lines are skipped.  Iteration
        ends when the server closes the stream (watch timeout or
        watcher eviction)."""
        params = {"wait": "true", "stream": "true"}
        if wait_index is not None:
            params["waitIndex"] = str(wait_index)
        if recursive:
            params["recursive"] = "true"
        with self._request("GET", "/v2/keys" + key, params=params,
                           timeout=timeout or 330.0) as resp:
            for line in resp:
                if line.strip():
                    yield json.loads(line)

    def watch_many(self, specs: list[dict],
                   timeout: float | None = None):
        """Batched multiplexed watch (POST /v2/watch): register
        every spec (``{"key", "recursive", "stream", "since"}``) in
        one request and yield ``{"watch": <spec idx>, ...event}``
        lines off one chunked stream.  ``{"watch": i, "closed":
        true}`` marks a member evicted or fired one-shot; the stream
        ends when every member has closed."""
        with self._request("POST", "/v2/watch",
                           data=json.dumps(specs).encode(),
                           content_type="application/json",
                           timeout=timeout or 330.0) as resp:
            for line in resp:
                if line.strip():
                    yield json.loads(line)

    # -- batch endpoints -------------------------------------------

    def _batch_post(self, path: str, body: bytes, content_type: str,
                    timeout: float | None) -> tuple[bytes, bool]:
        """POST one batch request, advertising the binary framing
        unless the client is (or fell back to) JSON-only.  Returns
        ``(reply bytes, reply was binary)`` and runs the negotiation
        state machine: the first binary reply upgrades ``auto`` ->
        ``binary``; a non-binary reply while we were hoping for (or
        had negotiated) binary demotes to sticky ``json`` and counts
        the downgrade — the mixed-version path is a metric, never a
        failed op."""
        acc = clientmsg.CONTENT_TYPE if self._wire != "json" else None
        with self._request("POST", path, data=body,
                           content_type=content_type,
                           timeout=timeout, accept=acc) as resp:
            rbody = resp.read()
            rtype = resp.headers.get("Content-Type") or ""
        binary = clientmsg.CONTENT_TYPE in rtype
        if binary:
            if self._wire == "auto":
                self._wire = "binary"
        elif self._wire != "json":
            self._wire = "json"
            _obs.registry.counter("etcd_client_wire_fallback_total",
                                  reason="not_negotiated").inc()
        _obs.registry.counter(
            "etcd_client_wire_requests_total",
            wire="binary" if binary else "json").inc()
        return rbody, binary

    def _wire_decode_error(self) -> None:
        """A negotiated binary reply failed to parse (truncating
        proxy, version skew mid-upgrade): fall back to JSON for the
        rest of this client's life and count why."""
        self._wire = "json"
        _obs.registry.counter("etcd_client_wire_fallback_total",
                              reason="decode_error").inc()

    def get_many(self, paths: list[str], timeout: float | None = None
                 ) -> tuple[list, dict[int, tuple[int, str]]]:
        """Batched linearizable reads (POST /mraft/get_many
        lane).  Returns ``(vals, errs)``: ``vals[i]`` is the leaf
        value (str) or None, ``errs`` maps failed indexes to
        ``(errorCode, message)``.  The request body upgrades to the
        DCB1 binary frame only after a reply has proven the server
        speaks it; a decode failure retries once over JSON (reads
        are idempotent)."""
        if self._wire == "binary":
            body = bytes(clientmsg.pack_get_request(paths))
            ct = clientmsg.CONTENT_TYPE
        else:
            body = json.dumps(list(paths)).encode()
            ct = "application/json"
        rbody, binary = self._batch_post(
            "/mraft/get_many", body, ct, timeout)
        if binary:
            try:
                vals, errs = clientmsg.unpack_get_response(rbody)
            except FrameError:
                self._wire_decode_error()
                return self.get_many(paths, timeout)
            return ([v.decode() if isinstance(v, bytes) else v
                     for v in vals], errs)
        d = json.loads(rbody)
        errs = {int(i): (int(e.get("errorCode", 300)),
                         e.get("message", ""))
                for i, e in (d.get("errs") or {}).items()}
        return list(d.get("vals") or []), errs

    def propose_many(self, reqs: list,
                     timeout: float | None = None
                     ) -> tuple[int, dict[int, tuple[int, str]]]:
        """Batched writes (POST /mraft/propose_many).  ``reqs`` is a
        list of ``wire.requests.Request``; returns ``(n, errs)`` with
        the error-sparse verdict map.  The request body is the
        version-stable packed-Request frame either way — only the
        REPLY framing is negotiated, so a downgrade mid-stream can
        never re-send (and double-apply) a write.  A reply that
        negotiated binary but fails to decode raises (the writes may
        have applied; re-proposing is not safe) after demoting the
        client to JSON for subsequent calls."""
        from ..server.distserver import pack_requests
        rbody, binary = self._batch_post(
            "/mraft/propose_many", pack_requests(reqs),
            "application/octet-stream", timeout)
        if binary:
            try:
                return clientmsg.unpack_propose_response(rbody)
            except FrameError as e:
                self._wire_decode_error()
                raise ClientError(
                    200, f"binary propose reply undecodable: {e}"
                ) from None
        d = json.loads(rbody)
        errs = {int(i): (int(e.get("errorCode", 300)),
                         e.get("message", ""))
                for i, e in (d.get("errs") or {}).items()}
        return int(d.get("n", 0)), errs
