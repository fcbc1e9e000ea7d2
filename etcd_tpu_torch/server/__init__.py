"""Server orchestration (the port of ``etcd_tpu/server``): the classic
single-group ``EtcdServer`` (``server.py``, with its configuration
``config.py`` and peer transport ``sender.py``), the event-driven front
door every tier serves through (``frontdoor.py``), the co-hosted
multi-group server (``multigroup.MultiGroupServer``), the distributed
tier (``distserver.DistServer``, with its append pipeline
``distpipe.py``, peer links ``peerlink.py`` and linearizable read
bookkeeping ``readindex.py``) and what they share: array-form
GroupEntry replay (``gereplay.py``), cluster membership in the store
(``cluster.py``) and the stats endpoints' sources (``stats.py``); and
the role-split topology (``roles.py``: a supervisor nursing an ingest,
an apply/watch worker fed over the shared-memory ring ``shmring.py``,
and serving shards, each a ``DistServer``)."""

from .cluster import (
    Cluster,
    ClusterStore,
    Member,
    new_member,
    parse_member_id,
)
from .config import CLUSTER_STATE_NEW, ServerConfig
from .multigroup import MultiGroupServer, group_of
from .sender import new_sender
from .server import (
    DEFAULT_SNAP_COUNT,
    EtcdServer,
    Response,
    ServerStoppedError,
    UnknownMethodError,
    WalSnapStorage,
    apply_request_to_store,
    gen_id,
    new_server,
)

__all__ = [
    "CLUSTER_STATE_NEW",
    "Cluster",
    "ClusterStore",
    "DEFAULT_SNAP_COUNT",
    "EtcdServer",
    "Member",
    "MultiGroupServer",
    "Response",
    "ServerConfig",
    "ServerStoppedError",
    "UnknownMethodError",
    "WalSnapStorage",
    "apply_request_to_store",
    "gen_id",
    "group_of",
    "new_member",
    "new_sender",
    "new_server",
    "parse_member_id",
]
