"""Internal store node: KV leaf or directory (reference store/node.go).

``expire_time`` is epoch seconds or None for permanent (the reference
uses the zero time.Time as the permanent sentinel, node.go:85-90).
"""

from __future__ import annotations

import math
import time
from typing import Callable, Optional

from ..utils.errors import (
    ECODE_DIR_NOT_EMPTY,
    ECODE_NODE_EXIST,
    ECODE_NOT_DIR,
    ECODE_NOT_FILE,
    EtcdError,
)
from .event import NodeExtern


def child_path(parent: str, name: str) -> str:
    """``posixpath.join`` for the store's normalized shapes: parent
    is a clean absolute path, name a single non-empty slash-free
    segment (one definition — store and watcher both build child
    paths on hot paths)."""
    return ("/" + name) if parent == "/" else parent + "/" + name

# Compare result explanations (node.go:12-17)
COMPARE_MATCH = 0
COMPARE_INDEX_NOT_MATCH = 1
COMPARE_VALUE_NOT_MATCH = 2
COMPARE_NOT_MATCH = 3

PERMANENT: float | None = None


def split_path(p: str) -> tuple[str, str]:
    """path.Split semantics: (dir-with-trailing-slash, name)."""
    i = p.rfind("/")
    return p[: i + 1], p[i + 1:]


class Node:
    __slots__ = ("path", "created_index", "modified_index", "parent",
                 "expire_time", "acl", "value", "children", "store")

    def __init__(self, store, path: str, created_index: int, parent,
                 acl: str, expire_time: float | None,
                 value: str = "", children: dict | None = None):
        self.path = path
        self.created_index = created_index
        self.modified_index = created_index
        self.parent = parent
        self.expire_time = expire_time
        self.acl = acl
        self.value = value
        self.children = children
        self.store = store

    # -- constructors ------------------------------------------------------

    @classmethod
    def new_kv(cls, store, path, value, created_index, parent, acl,
               expire_time):
        return cls(store, path, created_index, parent, acl, expire_time,
                   value=value)

    @classmethod
    def new_dir(cls, store, path, created_index, parent, acl, expire_time):
        return cls(store, path, created_index, parent, acl, expire_time,
                   children={})

    # -- predicates --------------------------------------------------------

    def is_hidden(self) -> bool:
        """Hidden nodes begin with '_' (node.go:78-82)."""
        _, name = split_path(self.path)
        return name.startswith("_")

    def is_permanent(self) -> bool:
        return self.expire_time is None

    def is_dir(self) -> bool:
        return self.children is not None

    # -- accessors ---------------------------------------------------------

    def read(self) -> str:
        if self.is_dir():
            raise EtcdError(ECODE_NOT_FILE, "", self.store.current_index)
        return self.value

    def write(self, value: str, index: int) -> None:
        if self.is_dir():
            raise EtcdError(ECODE_NOT_FILE, "", self.store.current_index)
        self.value = value
        self.modified_index = index

    def expiration_and_ttl(self) -> tuple[float | None, int]:
        """TTL = ceil(expire - now), 1..n (node.go:122-139)."""
        if not self.is_permanent():
            ttl = math.ceil(self.expire_time - time.time())
            if ttl < 1:
                ttl = 1
            return self.expire_time, int(ttl)
        return None, 0

    def list(self) -> list["Node"]:
        if not self.is_dir():
            raise EtcdError(ECODE_NOT_DIR, "", self.store.current_index)
        return list(self.children.values())

    def get_child(self, name: str) -> Optional["Node"]:
        if not self.is_dir():
            raise EtcdError(ECODE_NOT_DIR, self.path,
                            self.store.current_index)
        return self.children.get(name)

    def add(self, child: "Node") -> None:
        if not self.is_dir():
            raise EtcdError(ECODE_NOT_DIR, "", self.store.current_index)
        _, name = split_path(child.path)
        if name in self.children:
            raise EtcdError(ECODE_NODE_EXIST, "", self.store.current_index)
        self.children[name] = child

    # -- removal -----------------------------------------------------------

    def remove(self, dir: bool, recursive: bool,
               callback: Callable[[str], None] | None) -> None:
        """Reference node.go:198-252."""
        if self.is_dir():
            if not dir:
                raise EtcdError(ECODE_NOT_FILE, self.path,
                                self.store.current_index)
            if self.children and not recursive:
                raise EtcdError(ECODE_DIR_NOT_EMPTY, self.path,
                                self.store.current_index)

        if not self.is_dir():  # key-value pair
            _, name = split_path(self.path)
            if self.parent is not None and \
                    self.parent.children.get(name) is self:
                del self.parent.children[name]
            if callback is not None:
                callback(self.path)
            if not self.is_permanent():
                self.store.ttl_key_heap.remove(self)
            return

        for child in list(self.children.values()):
            child.remove(True, True, callback)

        _, name = split_path(self.path)
        if self.parent is not None and self.parent.children.get(name) is self:
            del self.parent.children[name]
            if callback is not None:
                callback(self.path)
            if not self.is_permanent():
                self.store.ttl_key_heap.remove(self)

    # -- representation ----------------------------------------------------

    def load_extern(self, ext: NodeExtern, recursive: bool,
                    sorted_: bool) -> None:
        """loadInternalNode semantics (node_extern.go:24-55): a
        directory ALWAYS lists its immediate non-hidden children;
        ``recursive`` only controls deeper expansion."""
        if self.is_dir():
            ext.dir = True
            ext.nodes = [c.repr(recursive, sorted_)
                         for c in self.list() if not c.is_hidden()]
            if sorted_:
                ext.nodes.sort(key=lambda n: n.key)
        else:
            ext.value = self.value
        ext.expiration, ext.ttl = self.expiration_and_ttl()

    def repr(self, recursive: bool, sorted_: bool) -> NodeExtern:
        """Reference node.go:254-305."""
        if self.is_dir():
            ext = NodeExtern(key=self.path, dir=True,
                             modified_index=self.modified_index,
                             created_index=self.created_index)
            ext.expiration, ext.ttl = self.expiration_and_ttl()
            if not recursive:
                return ext
            ext.nodes = [c.repr(recursive, sorted_)
                         for c in self.list() if not c.is_hidden()]
            if sorted_:
                ext.nodes.sort(key=lambda n: n.key)
            return ext

        ext = NodeExtern(key=self.path, value=self.value,
                         modified_index=self.modified_index,
                         created_index=self.created_index)
        ext.expiration, ext.ttl = self.expiration_and_ttl()
        return ext

    def update_ttl(self, expire_time: float | None) -> None:
        """Reference node.go:307-330."""
        if not self.is_permanent():
            if expire_time is None:
                self.expire_time = None
                self.store.ttl_key_heap.remove(self)
            else:
                self.expire_time = expire_time
                self.store.ttl_key_heap.update(self)
        else:
            if expire_time is not None:
                self.expire_time = expire_time
                self.store.ttl_key_heap.push(self)

    def compare(self, prev_value: str, prev_index: int) -> tuple[bool, int]:
        """Reference node.go:334-349."""
        index_match = prev_index == 0 or self.modified_index == prev_index
        value_match = prev_value == "" or self.value == prev_value
        ok = value_match and index_match
        if value_match and index_match:
            which = COMPARE_MATCH
        elif index_match and not value_match:
            which = COMPARE_VALUE_NOT_MATCH
        elif value_match and not index_match:
            which = COMPARE_INDEX_NOT_MATCH
        else:
            which = COMPARE_NOT_MATCH
        return ok, which

    def clone(self) -> "Node":
        if not self.is_dir():
            n = Node.new_kv(self.store, self.path, self.value,
                            self.created_index, self.parent, self.acl,
                            self.expire_time)
            n.modified_index = self.modified_index
            return n
        clone = Node.new_dir(self.store, self.path, self.created_index,
                             self.parent, self.acl, self.expire_time)
        clone.modified_index = self.modified_index
        for key, child in self.children.items():
            clone.children[key] = child.clone()
        return clone

    def recover_and_clean(self) -> None:
        """Rebuild parent/store refs; re-register TTLs
        (reference node.go:375-388)."""
        if self.is_dir():
            for child in self.children.values():
                child.parent = self
                child.store = self.store
                child.recover_and_clean()
        if self.expire_time is not None:
            self.store.ttl_key_heap.push(self)

    # -- snapshot JSON (Go struct field names, Parent omitted) -------------

    def to_json_dict(self) -> dict:
        from .event import rfc3339

        d = {
            "Path": self.path,
            "CreatedIndex": self.created_index,
            "ModifiedIndex": self.modified_index,
            "ExpireTime": rfc3339(self.expire_time),
            "ACL": self.acl,
            "Value": self.value,
            "Children": None,
        }
        if self.is_dir():
            d["Children"] = {k: c.to_json_dict()
                             for k, c in self.children.items()}
        return d

    @classmethod
    def from_json_dict(cls, store, d: dict) -> "Node":
        from .event import parse_rfc3339

        children = None
        if d.get("Children") is not None:
            children = {}
        n = cls(store, d["Path"], d.get("CreatedIndex", 0), None,
                d.get("ACL", ""), parse_rfc3339(d.get("ExpireTime")),
                value=d.get("Value", ""), children=children)
        n.modified_index = d.get("ModifiedIndex", 0)
        if children is not None:
            for k, cd in d["Children"].items():
                n.children[k] = cls.from_json_dict(store, cd)
        return n
