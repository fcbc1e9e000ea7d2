"""Discovery bootstrap client (reference discovery/discovery.go; the
port's copy of ``etcd_tpu/discovery/discovery.py``).

Register self under the discovery prefix, read _config/size, then
watch until ``size`` peers have registered; emits the initial-cluster
string (discovery.go:213-227).  Retries use exponential backoff capped
at ``MAX_RETRY`` rounds (discovery.go:28-31,161-175).
"""

from __future__ import annotations

import logging
import time
import urllib.parse

log = logging.getLogger(__name__)

MAX_RETRY = 3
# injectable for tests (reference discovery.go:46-47)
TIMEOUT_TIMESCALE = 1.0


class DiscoveryError(Exception):
    pass


class ClusterFullError(DiscoveryError):
    """The discovery token's size is already satisfied by other peers
    (reference ErrFullCluster, discovery.go:149-157)."""


class Discoverer:
    def __init__(self, durl: str, id: int, config: str, client=None):
        """``client`` implements create/get/watch against the discovery
        service; defaults to the bundled etcd client."""
        u = urllib.parse.urlsplit(durl)
        self.url = durl
        self.cluster = u.path.strip("/")
        self.id = id
        self.config = config
        if client is None:
            from ..api.client import Client

            base = urllib.parse.urlunsplit(
                (u.scheme, u.netloc, "", "", ""))
            client = Client([base])
        self.client = client

    def discover(self) -> str:
        """Reference discovery.go:55-99."""
        # 1. register self
        self._create_self()
        # 2. wait for enough peers
        nodes, size, index = self._check_cluster()
        all_nodes = self._wait_nodes(nodes, size, index)
        return nodes_to_cluster(all_nodes)

    def _create_self(self) -> None:
        """Reference discovery.go:101-111."""
        key = f"/{self.cluster}/{self.id:x}"
        self.client.create(key, self.config)

    def _check_cluster(self):
        """Read registered nodes + expected size
        (reference discovery.go:113-159)."""
        retry = 0
        while True:
            try:
                resp = self.client.get(f"/{self.cluster}/_config/size")
                size = int(resp["node"]["value"])
                resp = self.client.get(f"/{self.cluster}", recursive=False,
                                       sorted=True)
                nodes = [n for n in resp["node"].get("nodes", [])
                         if not n["key"].rsplit("/", 1)[-1].startswith("_")]
                nodes.sort(key=lambda n: n.get("createdIndex", 0))
                # a late joiner cut off by the size limit must abort,
                # not bootstrap without itself (discovery.go:149-157)
                selected = nodes[:size]
                self_key = f"/{self.cluster}/{self.id:x}"
                if len(nodes) > size and not any(
                        n["key"].endswith(f"/{self.id:x}")
                        for n in selected):
                    raise ClusterFullError(
                        f"cluster is full: size={size}, "
                        f"self={self_key}")
                index = resp.get("etcdIndex", 0)
                return selected, size, index
            except ClusterFullError:
                raise
            except Exception as e:
                retry += 1
                if retry > MAX_RETRY:
                    raise DiscoveryError(f"too many retries: {e}") from e
                wait = (2 ** retry) * TIMEOUT_TIMESCALE
                log.info("discovery: error %s, retrying in %.1fs", e, wait)
                time.sleep(wait)

    def _wait_nodes(self, nodes, size, index):
        """Watch until size peers registered
        (reference discovery.go:161-207)."""
        all_nodes = list(nodes)
        watch_index = index
        while len(all_nodes) < size:
            try:
                resp = self.client.watch(f"/{self.cluster}",
                                         wait_index=watch_index + 1,
                                         recursive=True)
            except Exception as e:
                log.info("discovery: watch error %s, retrying", e)
                time.sleep(TIMEOUT_TIMESCALE)
                continue
            if not resp.get("node"):
                # long-poll timed out with no event: re-watch
                # (the reference retries via waitNodesRetry,
                # discovery.go:176-186)
                continue
            node = resp["node"]
            name = node["key"].rsplit("/", 1)[-1]
            watch_index = node.get("modifiedIndex", watch_index + 1)
            if name.startswith("_"):
                continue
            if not any(n["key"] == node["key"] for n in all_nodes):
                all_nodes.append(node)
        return all_nodes[:size]


def nodes_to_cluster(nodes) -> str:
    """Reference discovery.go:213-218."""
    return ",".join(n["value"] for n in nodes)


def proxy_endpoints(durl: str, client=None) -> list[str]:
    """Read the member peer URLs a discovery cluster has registered —
    the proxy-mode bootstrap (a proxy is not a member: it reads the
    registry without createSelf/waitNodes, then proxies to whatever
    peers exist).  Returns the registered peer URLs.
    """
    u = urllib.parse.urlsplit(durl)
    cluster = u.path.strip("/")
    if client is None:
        from ..api.client import Client

        base = urllib.parse.urlunsplit((u.scheme, u.netloc, "", "", ""))
        client = Client([base])
    resp = client.get(f"/{cluster}", recursive=False, sorted=True)
    nodes = [n for n in resp["node"].get("nodes", [])
             if not n["key"].rsplit("/", 1)[-1].startswith("_")]
    nodes.sort(key=lambda n: n.get("createdIndex", 0))
    urls = []
    for n in nodes:
        # registry values are "name=peerurl" pairs (nodes_to_cluster)
        val = n.get("value", "")
        urls.append(val.split("=", 1)[1] if "=" in val else val)
    return [x for x in urls if x]
