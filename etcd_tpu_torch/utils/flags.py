"""Typed flag values + env fallback (reference pkg/flag.go,
pkg/flags/, pkg/types/urls.go).

Precedence: explicit flags > ETCD_* environment variables > defaults
(pkg/flag.go:73-88).
"""

from __future__ import annotations

import argparse
import ipaddress
import logging
import os
import urllib.parse

log = logging.getLogger(__name__)

PROXY_VALUE_OFF = "off"
PROXY_VALUE_READONLY = "readonly"
PROXY_VALUE_ON = "on"
PROXY_VALUES = (PROXY_VALUE_OFF, PROXY_VALUE_READONLY, PROXY_VALUE_ON)


def validate_urls(s: str) -> list[str]:
    """Validated, sorted URL list (reference pkg/types/urls.go:30-56)."""
    strs = s.split(",")
    if not strs:
        raise ValueError("no valid URLs given")
    out = []
    for raw in strs:
        raw = raw.strip()
        u = urllib.parse.urlsplit(raw)
        if u.scheme not in ("http", "https"):
            raise ValueError(f"URL scheme must be http or https: {raw}")
        if ":" not in u.netloc:
            raise ValueError(
                f'URL address does not have the form "host:port": {raw}')
        if u.path:
            raise ValueError(f"URL must not contain a path: {raw}")
        out.append(f"{u.scheme}://{u.netloc}")
    return sorted(out)


def parse_cors(s: str) -> set[str]:
    """Reference pkg/cors.go:28-46."""
    out = set()
    for v in s.split(","):
        v = v.strip()
        if not v:
            continue
        if v != "*":
            u = urllib.parse.urlsplit(v)
            if not u.scheme and not u.netloc and not u.path:
                raise ValueError(f"invalid CORS origin: {v}")
        out.add(v)
    return out


def parse_ip_address_port(s: str) -> str:
    """DEPRECATED addr-style flag value IP:port
    (pkg/flags/ipaddressport.go — the host must be a literal IPv4
    address and the port numeric; hostnames, schemes, and unix
    sockets are rejected)."""
    host, sep, port = s.partition(":")
    if not sep or not port or not (port.isascii() and port.isdigit()):
        raise ValueError(f"bad IP address:port: {s}")
    try:
        ipaddress.IPv4Address(host)
    except ValueError:
        raise ValueError(f"bad IP address:port: {s}") from None
    return f"{host}:{port}"


IGNORED_FLAGS = (
    # reference main.go:43-57 — accepted but ignored for 0.4 compat
    "cluster-active-size",
    "cluster-remove-delay",
    "cluster-sync-interval",
    "config",
    "force",
    "max-result-buffer",
    "max-retry-attempts",
    "peer-heartbeat-interval",
    "peer-election-timeout",
    "retry-interval",
    "snapshot",
    "v",
    "vv",
)

DEPRECATED_FLAGS = ("peers", "peers-file")


def set_flags_from_env(parser: argparse.ArgumentParser,
                       args: argparse.Namespace,
                       explicitly_set: set[str]) -> None:
    """ETCD_<UPPER_SNAKE> fallback for flags not set on the command
    line (reference pkg/flag.go:73-88)."""
    for action in parser._actions:
        opt = action.option_strings[0].lstrip("-") \
            if action.option_strings else None
        if opt is None or opt in explicitly_set:
            continue
        key = "ETCD_" + opt.upper().replace("-", "_")
        val = os.environ.get(key)
        if val:
            setattr(args, action.dest,
                    action.type(val) if action.type else val)


def urls_from_flags(args, urls_attr: str, addr_attr: str,
                    explicitly_set: set[str], tls_empty: bool = True
                    ) -> list[str]:
    """Arbitrate new-style URL flags vs deprecated addr flags
    (reference pkg/flag.go:99-125)."""
    urls_flag = urls_attr.replace("_", "-")
    addr_flag = addr_attr.replace("_", "-")
    urls_set = urls_flag in explicitly_set
    addr_set = addr_flag in explicitly_set
    if addr_set:
        if urls_set:
            raise ValueError(
                f"set only one of flags -{urls_flag} and -{addr_flag}")
        scheme = "http" if tls_empty else "https"
        return [f"{scheme}://{getattr(args, addr_attr)}"]
    return validate_urls(getattr(args, urls_attr))
