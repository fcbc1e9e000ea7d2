"""HTTP API: /v2/keys client API, /raft peer API, proxy mode, and the
Python client library (reference etcdserver/etcdhttp/, proxy/, client/;
the port of ``etcd_tpu/api``)."""

from .http import (
    DEFAULT_SERVER_TIMEOUT,
    DEFAULT_WATCH_TIMEOUT,
    EtcdRequestHandler,
    KEYS_PREFIX,
    MACHINES_PREFIX,
    make_client_handler,
    make_peer_handler,
    parse_request,
    serve,
)
from .client import Client, ClientError
from .proxy import Director, NewProxyHandler, ReadonlyProxyHandler

__all__ = [
    "make_client_handler",
    "make_peer_handler",
    "parse_request",
    "serve",
    "EtcdRequestHandler",
    "Client",
    "ClientError",
    "Director",
    "NewProxyHandler",
    "ReadonlyProxyHandler",
    "KEYS_PREFIX",
    "MACHINES_PREFIX",
    "DEFAULT_SERVER_TIMEOUT",
    "DEFAULT_WATCH_TIMEOUT",
]
