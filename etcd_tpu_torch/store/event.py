"""Store events and external node representation
(reference store/event.go, store/node_extern.go)."""

from __future__ import annotations

from dataclasses import dataclass, field

# actions (reference store/event.go:3-12)
GET = "get"
CREATE = "create"
SET = "set"
UPDATE = "update"
DELETE = "delete"
COMPARE_AND_SWAP = "compareAndSwap"
COMPARE_AND_DELETE = "compareAndDelete"
EXPIRE = "expire"


def rfc3339(t: float | None) -> str | None:
    """Epoch seconds -> RFC3339Nano, Go zero time for None."""
    if t is None:
        return "0001-01-01T00:00:00Z"
    import datetime

    dt = datetime.datetime.fromtimestamp(t, datetime.timezone.utc)
    return dt.strftime("%Y-%m-%dT%H:%M:%S.%f") + "Z"


def parse_rfc3339(s: str | None) -> float | None:
    if s is None or s.startswith("0001-01-01"):
        return None
    import datetime

    s2 = s.rstrip("Z")
    # tolerate fractional seconds of any width (Go RFC3339Nano)
    if "." in s2:
        head, frac = s2.split(".", 1)
        frac = (frac + "000000")[:6]
        s2 = f"{head}.{frac}"
        fmt = "%Y-%m-%dT%H:%M:%S.%f"
    else:
        fmt = "%Y-%m-%dT%H:%M:%S"
    dt = datetime.datetime.strptime(s2, fmt).replace(
        tzinfo=datetime.timezone.utc)
    return dt.timestamp()


@dataclass
class NodeExtern:
    """External node representation (node_extern.go:12-22)."""

    key: str = ""
    value: str | None = None
    dir: bool = False
    expiration: float | None = None
    ttl: int = 0
    nodes: list["NodeExtern"] | None = None
    modified_index: int = 0
    created_index: int = 0

    def to_dict(self) -> dict:
        """JSON shape with omitempty semantics matching the reference's
        struct tags."""
        d = {}
        if self.key:
            d["key"] = self.key
        if self.value is not None:
            d["value"] = self.value
        if self.dir:
            d["dir"] = True
        if self.expiration is not None:
            d["expiration"] = rfc3339(self.expiration)
        if self.ttl:
            d["ttl"] = self.ttl
        if self.nodes:
            d["nodes"] = [n.to_dict() for n in self.nodes]
        if self.modified_index:
            d["modifiedIndex"] = self.modified_index
        if self.created_index:
            d["createdIndex"] = self.created_index
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "NodeExtern":
        return cls(
            key=d.get("key", ""),
            value=d.get("value"),
            dir=d.get("dir", False),
            expiration=parse_rfc3339(d.get("expiration")),
            ttl=d.get("ttl", 0),
            nodes=[cls.from_dict(x) for x in d["nodes"]]
            if d.get("nodes") else None,
            modified_index=d.get("modifiedIndex", 0),
            created_index=d.get("createdIndex", 0),
        )


@dataclass
class Event:
    """Reference store/event.go:14-48."""

    action: str
    node: NodeExtern | None = None
    prev_node: NodeExtern | None = None
    etcd_index: int = 0  # json:"-"

    def is_created(self) -> bool:
        if self.action == CREATE:
            return True
        return self.action == SET and self.prev_node is None

    def index(self) -> int:
        return self.node.modified_index if self.node else 0

    def to_dict(self) -> dict:
        d = {"action": self.action}
        if self.node is not None:
            d["node"] = self.node.to_dict()
        if self.prev_node is not None:
            d["prevNode"] = self.prev_node.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Event":
        return cls(
            action=d["action"],
            node=NodeExtern.from_dict(d["node"]) if d.get("node") else None,
            prev_node=NodeExtern.from_dict(d["prevNode"])
            if d.get("prevNode") else None,
        )


def new_event(action: str, key: str, modified_index: int,
              created_index: int) -> Event:
    return Event(action=action,
                 node=NodeExtern(key=key, modified_index=modified_index,
                                 created_index=created_index))
