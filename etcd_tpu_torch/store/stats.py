"""Per-operation success/fail counters (reference store/stats.go)."""

from __future__ import annotations

import json
import threading

SET_SUCCESS = 0
SET_FAIL = 1
DELETE_SUCCESS = 2
DELETE_FAIL = 3
CREATE_SUCCESS = 4
CREATE_FAIL = 5
UPDATE_SUCCESS = 6
UPDATE_FAIL = 7
COMPARE_AND_SWAP_SUCCESS = 8
COMPARE_AND_SWAP_FAIL = 9
GET_SUCCESS = 10
GET_FAIL = 11
EXPIRE_COUNT = 12
COMPARE_AND_DELETE_SUCCESS = 13
COMPARE_AND_DELETE_FAIL = 14

_FIELDS = {
    SET_SUCCESS: "set_success",
    SET_FAIL: "set_fail",
    DELETE_SUCCESS: "delete_success",
    DELETE_FAIL: "delete_fail",
    CREATE_SUCCESS: "create_success",
    CREATE_FAIL: "create_fail",
    UPDATE_SUCCESS: "update_success",
    UPDATE_FAIL: "update_fail",
    COMPARE_AND_SWAP_SUCCESS: "compare_and_swap_success",
    COMPARE_AND_SWAP_FAIL: "compare_and_swap_fail",
    GET_SUCCESS: "get_success",
    GET_FAIL: "get_fail",
    EXPIRE_COUNT: "expire_count",
    COMPARE_AND_DELETE_SUCCESS: "compare_and_delete_success",
    COMPARE_AND_DELETE_FAIL: "compare_and_delete_fail",
}


# Read-serve paths: the GET counters above conflate every
# read; the serve-path split lets bench forensics attribute read
# throughput to the lane that actually carried it.  Labels match
# server/readindex.py's PATH_* constants.
READ_PATHS = ("lease", "read_index", "follower_wait", "serializable",
              "quorum", "cohosted")


class Stats:
    def __init__(self):
        self._lock = threading.Lock()
        for name in _FIELDS.values():
            setattr(self, name, 0)
        self.watchers = 0
        self.reads_by_path = {p: 0 for p in READ_PATHS}

    def inc(self, field: int, n: int = 1) -> None:
        name = _FIELDS[field]
        with self._lock:
            setattr(self, name, getattr(self, name) + n)

    def inc_read_path(self, path: str, n: int = 1) -> None:
        """Count a served read against its serve path (the split:
        lease / read_index / follower_wait / serializable / quorum /
        cohosted).  Unknown paths raise — a typo'd path would
        silently vanish from the bench forensics otherwise."""
        with self._lock:
            self.reads_by_path[path] = self.reads_by_path[path] + n

    def clone(self) -> "Stats":
        c = Stats()
        for name in _FIELDS.values():
            setattr(c, name, getattr(self, name))
        c.watchers = self.watchers
        c.reads_by_path = dict(self.reads_by_path)
        return c

    def total_reads(self) -> int:
        return self.get_success + self.get_fail

    def total_transactions(self) -> int:
        return (self.set_success + self.set_fail
                + self.delete_success + self.delete_fail
                + self.compare_and_swap_success + self.compare_and_swap_fail
                + self.compare_and_delete_success
                + self.compare_and_delete_fail
                + self.update_success + self.update_fail)

    def to_dict(self) -> dict:
        """JSON field names as in the reference struct tags."""
        return {
            "getsSuccess": self.get_success,
            "getsFail": self.get_fail,
            "setsSuccess": self.set_success,
            "setsFail": self.set_fail,
            "deleteSuccess": self.delete_success,
            "deleteFail": self.delete_fail,
            "updateSuccess": self.update_success,
            "updateFail": self.update_fail,
            "createSuccess": self.create_success,
            "createFail": self.create_fail,
            "compareAndSwapSuccess": self.compare_and_swap_success,
            "compareAndSwapFail": self.compare_and_swap_fail,
            "compareAndDeleteSuccess": self.compare_and_delete_success,
            "compareAndDeleteFail": self.compare_and_delete_fail,
            "expireCount": self.expire_count,
            "watchers": self.watchers,
            # additive key (not in the reference struct): per-path
            # read attribution for the linearizable read path
            "readsByPath": dict(self.reads_by_path),
        }

    def to_json(self) -> bytes:
        return json.dumps(self.to_dict()).encode()

    @classmethod
    def from_dict(cls, d: dict) -> "Stats":
        s = cls()
        s.get_success = d.get("getsSuccess", 0)
        s.get_fail = d.get("getsFail", 0)
        s.set_success = d.get("setsSuccess", 0)
        s.set_fail = d.get("setsFail", 0)
        s.delete_success = d.get("deleteSuccess", 0)
        s.delete_fail = d.get("deleteFail", 0)
        s.update_success = d.get("updateSuccess", 0)
        s.update_fail = d.get("updateFail", 0)
        s.create_success = d.get("createSuccess", 0)
        s.create_fail = d.get("createFail", 0)
        s.compare_and_swap_success = d.get("compareAndSwapSuccess", 0)
        s.compare_and_swap_fail = d.get("compareAndSwapFail", 0)
        s.compare_and_delete_success = d.get("compareAndDeleteSuccess", 0)
        s.compare_and_delete_fail = d.get("compareAndDeleteFail", 0)
        s.expire_count = d.get("expireCount", 0)
        s.watchers = d.get("watchers", 0)
        s.reads_by_path.update(d.get("readsByPath", {}))
        return s
