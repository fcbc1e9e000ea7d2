"""Cluster membership (reference etcdserver/cluster.go, member.go,
cluster_store.go).

Member identity is sha1(name + peerURLs) truncated to uint64
(member.go:37-55).  Runtime membership is replicated *inside the KV
store* under /_etcd/machines/<hex-id>, so conf changes ride the same
consensus log as user writes.
"""

from __future__ import annotations

import hashlib
import json
import random
import urllib.parse

from ..store import PERMANENT, Store
from ..utils.errors import ECODE_KEY_NOT_FOUND, EtcdError

MACHINE_KV_PREFIX = "/_etcd/machines/"
RAFT_ATTRIBUTES_SUFFIX = "/raftAttributes"
ATTRIBUTES_SUFFIX = "/attributes"
RAFT_PREFIX = "/raft"


class RaftAttributes:
    def __init__(self, peer_urls: list[str] | None = None):
        self.peer_urls = peer_urls or []

    def to_dict(self):
        return {"PeerURLs": self.peer_urls}

    @classmethod
    def from_dict(cls, d):
        return cls(d.get("PeerURLs") or [])


class Attributes:
    def __init__(self, name: str = "", client_urls: list[str] | None = None):
        self.name = name
        self.client_urls = client_urls or []

    def to_dict(self):
        return {"Name": self.name, "ClientURLs": self.client_urls}

    @classmethod
    def from_dict(cls, d):
        return cls(d.get("Name", ""), d.get("ClientURLs") or [])


class Member:
    def __init__(self, id: int = 0, name: str = "",
                 peer_urls: list[str] | None = None,
                 client_urls: list[str] | None = None):
        self.id = id
        self.raft_attributes = RaftAttributes(peer_urls)
        self.attributes = Attributes(name, client_urls)

    @property
    def name(self) -> str:
        return self.attributes.name

    @property
    def peer_urls(self) -> list[str]:
        return self.raft_attributes.peer_urls

    @property
    def client_urls(self) -> list[str]:
        return self.attributes.client_urls

    def store_key(self) -> str:
        return MACHINE_KV_PREFIX + format(self.id, "x")

    def to_dict(self) -> dict:
        d = {"ID": self.id}
        d.update(self.raft_attributes.to_dict())
        d.update(self.attributes.to_dict())
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Member":
        return cls(id=d.get("ID", 0), name=d.get("Name", ""),
                   peer_urls=d.get("PeerURLs") or [],
                   client_urls=d.get("ClientURLs") or [])

    def __repr__(self):
        return f"Member(id={self.id:x}, name={self.name!r}, " \
               f"peers={self.peer_urls})"


def new_member(name: str, peer_urls: list[str],
               now: float | None = None) -> Member:
    """Generate the deterministic ID from name+peerURLs
    (reference member.go:37-55)."""
    b = name.encode()
    for p in peer_urls:
        b += p.encode()
    if now is not None:
        b += str(int(now)).encode()
    digest = hashlib.sha1(b).digest()
    id = int.from_bytes(digest[:8], "big")
    return Member(id=id, name=name, peer_urls=list(peer_urls))


def parse_member_id(key: str) -> int:
    return int(key.rsplit("/", 1)[-1], 16)


class Cluster(dict):
    """id -> Member map (reference cluster.go:15-128)."""

    def find_id(self, id: int) -> Member | None:
        return self.get(id)

    def find_name(self, name: str) -> Member | None:
        for m in self.values():
            if m.name == name:
                return m
        return None

    def add(self, m: Member) -> None:
        if self.find_id(m.id) is not None:
            raise ValueError(f"member exists with identical ID {m!r}")
        self[m.id] = m

    def pick(self, id: int) -> str:
        """Random peer address for a member (cluster.go:52-63)."""
        m = self.find_id(id)
        if m is None or not m.peer_urls:
            return ""
        return random.choice(m.peer_urls)

    def set_from_string(self, s: str) -> None:
        """Parse 'name1=http://...,name2=http://...'
        (reference cluster.go:66-85)."""
        self.clear()
        # keep_blank_values so "name=" surfaces to the empty-URL
        # guard below instead of silently parsing to an empty cluster
        v = urllib.parse.parse_qs(s.replace(",", "&"),
                                  strict_parsing=False,
                                  keep_blank_values=True)
        for name, urls in v.items():
            if not urls or any(u == "" for u in urls):
                raise ValueError(f"empty URL given for {name!r}")
            m = new_member(name, sorted(urls))
            self.add(m)

    def __str__(self) -> str:
        sl = []
        for m in self.values():
            for u in m.peer_urls:
                sl.append(f"{m.name}={u}")
        return ",".join(sorted(sl))

    def ids(self) -> list[int]:
        return sorted(self.keys())

    def peer_urls_all(self) -> list[str]:
        out = []
        for m in self.values():
            out.extend(m.peer_urls)
        return sorted(out)

    def client_urls_all(self) -> list[str]:
        out = []
        for m in self.values():
            out.extend(m.client_urls)
        return sorted(out)


class ClusterStore:
    """Membership replicated in the KV store
    (reference cluster_store.go:28-104)."""

    def __init__(self, st: Store):
        self.store = st

    def add(self, m: Member) -> None:
        self.store.create(m.store_key() + RAFT_ATTRIBUTES_SUFFIX, False,
                          json.dumps(m.raft_attributes.to_dict()), False,
                          PERMANENT)
        self.store.create(m.store_key() + ATTRIBUTES_SUFFIX, False,
                          json.dumps(m.attributes.to_dict()), False,
                          PERMANENT)

    def get(self) -> Cluster:
        c = Cluster()
        try:
            e = self.store.get(MACHINE_KV_PREFIX, True, True)
        except EtcdError as err:
            if err.error_code == ECODE_KEY_NOT_FOUND:
                return c
            raise
        for n in e.node.nodes or []:
            if len(n.nodes or []) != 2:
                # half-published member (its two attribute keys
                # commit as separate replicated writes): skip until
                # the second lands rather than 500 the reader.
                # ONLY the structural case is skipped — a corrupt
                # value (json error) must still surface, not be
                # silently indistinguishable from mid-publish
                continue
            c.add(node_to_member(n))
        return c

    def remove(self, id: int) -> None:
        p = self.get().find_id(id).store_key()
        self.store.delete(p, True, True)


def node_to_member(n) -> Member:
    """Build a member from its store subtree (child nodes sorted by
    key: /attributes then /raftAttributes) —
    reference cluster_store.go:76-96."""
    m = Member(id=parse_member_id(n.key))
    nodes = n.nodes or []
    if len(nodes) != 2:
        raise ValueError(f"len(nodes) = {len(nodes)}, want 2")
    if nodes[0].key != n.key + ATTRIBUTES_SUFFIX:
        raise ValueError(f"key = {nodes[0].key}, want "
                         f"{n.key + ATTRIBUTES_SUFFIX}")
    m.attributes = Attributes.from_dict(json.loads(nodes[0].value))
    if nodes[1].key != n.key + RAFT_ATTRIBUTES_SUFFIX:
        raise ValueError(f"key = {nodes[1].key}, want "
                         f"{n.key + RAFT_ATTRIBUTES_SUFFIX}")
    m.raft_attributes = RaftAttributes.from_dict(json.loads(nodes[1].value))
    return m
