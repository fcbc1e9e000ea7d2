"""Server configuration (reference etcdserver/config.go,
cluster_state.go; the port's copy of ``etcd_tpu/server/config.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field

from .cluster import Cluster

CLUSTER_STATE_NEW = "new"
CLUSTER_STATE_VALUES = (CLUSTER_STATE_NEW,)


@dataclass
class ServerConfig:
    name: str = "default"
    discovery_url: str = ""
    client_urls: list[str] = field(default_factory=list)
    data_dir: str = ""
    snap_count: int = 0
    cluster: Cluster = field(default_factory=Cluster)
    cluster_state: str = CLUSTER_STATE_NEW
    # WAL-replay execution backend: "host" = sequential Python path,
    # "tpu" = the stream lane on the card (wal/replay_device.py), "auto"
    # = the measured router's lane (wal/backend_policy.py).
    storage_backend: str = "auto"
    # peer transport TLS (utils.transport.TLSInfo); None/empty = http
    peer_tls: object = None

    def verify(self) -> None:
        """Reference config.go:24-43."""
        m = self.cluster.find_name(self.name)
        if m is None:
            raise ValueError(
                f"could not find name {self.name!r} in cluster")
        url_map = set()
        for memb in self.cluster.values():
            for url in memb.peer_urls:
                if url in url_map:
                    raise ValueError(
                        f"duplicate url {url!r} in server config")
                url_map.add(url)
