"""TLS listener/transport factories (reference pkg/transport/
listener.go): optional TLS server contexts with client-cert auth and
CA pools, and client-side contexts for peer transport."""

from __future__ import annotations

import ssl
from dataclasses import dataclass


@dataclass
class TLSInfo:
    """Reference pkg/transport/listener.go:53-96."""

    cert_file: str = ""
    key_file: str = ""
    ca_file: str = ""

    def empty(self) -> bool:
        return self.cert_file == "" and self.key_file == ""

    def __str__(self) -> str:
        return (f"cert = {self.cert_file}, key = {self.key_file}, "
                f"ca = {self.ca_file}")

    def server_context(self) -> ssl.SSLContext:
        """ServerConfig (listener.go:98-112): client-cert auth is
        required when a CA file is given."""
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(self.cert_file, self.key_file)
        if self.ca_file:
            ctx.verify_mode = ssl.CERT_REQUIRED
            ctx.load_verify_locations(self.ca_file)
        return ctx

    def client_context(self) -> ssl.SSLContext:
        """ClientConfig (listener.go:114-135)."""
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        if self.cert_file:
            ctx.load_cert_chain(self.cert_file, self.key_file)
        if self.ca_file:
            ctx.load_verify_locations(self.ca_file)
        else:
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        return ctx


def new_listener_context(info: TLSInfo) -> ssl.SSLContext | None:
    """None for plain HTTP (reference NewListener, listener.go:14-30)."""
    if info.empty():
        return None
    return info.server_context()
