"""The co-hosted multi-group server (``multigroup.MultiGroupServer``),
the distributed tier (``distserver.DistServer``, with its append
pipeline ``distpipe.py``, peer links ``peerlink.py`` and linearizable
read bookkeeping ``readindex.py``) and what they need: the shared
serving seams and restart replay (``server.py``), array-form GroupEntry
replay (``gereplay.py``), cluster membership in the store
(``cluster.py``) and the stats endpoints' sources (``stats.py``).  The
port of that part of ``etcd_tpu/server``; the single-group
``EtcdServer``, the role topology and the front door are not ported
yet."""

from .cluster import Cluster, ClusterStore, Member
from .multigroup import MultiGroupServer, group_of
from .server import (
    DEFAULT_SNAP_COUNT,
    Response,
    ServerStoppedError,
    UnknownMethodError,
    apply_request_to_store,
    gen_id,
)

__all__ = [
    "Cluster",
    "ClusterStore",
    "DEFAULT_SNAP_COUNT",
    "Member",
    "MultiGroupServer",
    "Response",
    "ServerStoppedError",
    "UnknownMethodError",
    "apply_request_to_store",
    "gen_id",
    "group_of",
]
