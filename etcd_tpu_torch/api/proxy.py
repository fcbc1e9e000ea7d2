"""Stateless proxy mode (reference proxy/; the port's copy of
``etcd_tpu/api/proxy.py``).

Reverse-proxies client requests to cluster members with endpoint
failure tracking: a failed endpoint is quarantined for 5 seconds
(director.go:14-16,86-93); hop-by-hop headers are stripped and
X-Forwarded-For appended (reverse.go:15-30,107-118).  The readonly
variant rejects non-GET with 501 (proxy.go:26-40).
"""

from __future__ import annotations

import logging
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler

log = logging.getLogger(__name__)

ENDPOINT_FAILURE_WAIT = 5.0

SINGLE_HOP_HEADERS = (
    "Connection",
    "Keep-Alive",
    "Proxy-Authenticate",
    "Proxy-Authorization",
    "Te",
    "Trailers",
    "Transfer-Encoding",
    "Upgrade",
)


class Endpoint:
    def __init__(self, url: str):
        self.url = url.rstrip("/")
        self.available = True
        self._lock = threading.Lock()

    def failed(self) -> None:
        """Quarantine for ENDPOINT_FAILURE_WAIT then reconsider
        (director.go:66-93)."""
        with self._lock:
            if not self.available:
                return
            self.available = False
        log.warning("proxy: marked endpoint %s unavailable", self.url)

        def unfail():
            time.sleep(ENDPOINT_FAILURE_WAIT)
            with self._lock:
                self.available = True
            log.info("proxy: marked endpoint %s available", self.url)

        threading.Thread(target=unfail, daemon=True).start()


class Director:
    def __init__(self, scheme: str, addrs: list[str]):
        if not addrs:
            raise ValueError("one or more upstream addresses required")
        self.ep = [Endpoint(f"{scheme}://{a}") for a in addrs]

    def endpoints(self) -> list[Endpoint]:
        return [e for e in self.ep if e.available]


def NewProxyHandler(addrs: list[str], scheme: str = "http",
                    readonly: bool = False):
    """Handler class factory (reference proxy.NewHandler)."""
    director = Director(scheme, addrs)

    class ProxyHandler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            log.debug("proxy: " + fmt, *args)

        def _proxy(self):
            if readonly and self.command != "GET":
                self.send_response(501)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return

            endpoints = director.endpoints()
            if not endpoints:
                log.warning("proxy: zero endpoints currently available")
                self.send_response(503)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return

            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else None

            headers = {k: v for k, v in self.headers.items()
                       if k.title() not in SINGLE_HOP_HEADERS
                       and k.title() != "Host"
                       and k.title() != "Content-Length"}
            client_ip = self.client_address[0]
            prior = self.headers.get("X-Forwarded-For")
            headers["X-Forwarded-For"] = (
                f"{prior}, {client_ip}" if prior else client_ip)

            resp = None
            for ep in endpoints:
                url = ep.url + self.path
                req = urllib.request.Request(url, data=body,
                                             method=self.command,
                                             headers=headers)
                try:
                    resp = urllib.request.urlopen(req, timeout=30)
                    break
                except urllib.error.HTTPError as e:
                    resp = e  # HTTP-level errors pass through
                    break
                except (urllib.error.URLError, OSError) as e:
                    log.warning(
                        "proxy: failed to direct request to %s: %s",
                        ep.url, e)
                    ep.failed()
                    continue

            if resp is None:
                log.warning("proxy: unable to get response from %d "
                            "endpoint(s)", len(endpoints))
                self.send_response(502)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return

            data = resp.read()
            self.send_response(resp.status
                               if hasattr(resp, "status") else resp.code)
            for k, v in resp.headers.items():
                if k.title() in SINGLE_HOP_HEADERS or \
                        k.title() == "Content-Length":
                    continue
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        do_GET = do_PUT = do_POST = do_DELETE = do_HEAD = _proxy

    ProxyHandler.director = director
    return ProxyHandler


def ReadonlyProxyHandler(addrs: list[str], scheme: str = "http"):
    return NewProxyHandler(addrs, scheme, readonly=True)
