"""L4 state machine: hierarchical KV tree with TTLs and watches
(reference store/).

Host-side (see store.py docstring).  Public surface mirrors the Store
interface (reference store/store.go:40-62) in snake_case.
"""

from .event import (
    COMPARE_AND_DELETE,
    COMPARE_AND_SWAP,
    CREATE,
    DELETE,
    EXPIRE,
    Event,
    GET,
    NodeExtern,
    SET,
    UPDATE,
)
from .fanout import FanoutEngine, WatchMux
from .store import MIN_EXPIRE_TIME, Store, clean_path
from .node_internal import PERMANENT
from .watcher import (
    NOTIFY_EVICTED,
    NOTIFY_SENT,
    NOTIFY_SKIPPED,
    Watcher,
    WatcherHub,
)

__all__ = [
    "Store",
    "Event",
    "NodeExtern",
    "Watcher",
    "WatcherHub",
    "FanoutEngine",
    "WatchMux",
    "NOTIFY_SKIPPED",
    "NOTIFY_SENT",
    "NOTIFY_EVICTED",
    "PERMANENT",
    "MIN_EXPIRE_TIME",
    "clean_path",
    "GET",
    "CREATE",
    "SET",
    "UPDATE",
    "DELETE",
    "COMPARE_AND_SWAP",
    "COMPARE_AND_DELETE",
    "EXPIRE",
]
