"""The HTTP client API (``http.py``: /v2/keys, /v2/watch, /v2/machines,
/v2/stats/*), the port of the client side of ``etcd_tpu/api/http.py``."""

from .http import (
    DEFAULT_SERVER_TIMEOUT,
    DEFAULT_WATCH_TIMEOUT,
    KEYS_PREFIX,
    MACHINES_PREFIX,
    EtcdRequestHandler,
    make_client_handler,
    parse_request,
    serve,
)

__all__ = [
    "DEFAULT_SERVER_TIMEOUT",
    "DEFAULT_WATCH_TIMEOUT",
    "EtcdRequestHandler",
    "KEYS_PREFIX",
    "MACHINES_PREFIX",
    "make_client_handler",
    "parse_request",
    "serve",
]
