"""Server-level statistics (/v2/stats/self and /v2/stats/leader).

The 0.5-alpha reference tracks only store op counters and never wires
an HTTP stats endpoint (0.4.x had /v2/stats, documented
in Documentation/api.md); observability is called out there as new
work for the rebuild, so this module provides the classic field shape
plus counters fed from the apply loop and peer transport.
"""

from __future__ import annotations

import json
import threading
import time

#: raft roles, indexed as ``raft/core.py`` numbers them
STATE_FOLLOWER, STATE_CANDIDATE, STATE_LEADER = 0, 1, 2
STATE_NAMES = ("StateFollower", "StateCandidate", "StateLeader")


class ServerStats:
    """Process-wide serving counters, lock-guarded (the host control
    plane is threaded; device state needs no such guard)."""

    def __init__(self, name: str, id: int):
        self.name = name
        self.id = id
        self.start_time = time.time()
        self._lock = threading.Lock()
        self.state = "StateFollower"
        self.leader_id = 0
        self.leader_since = None
        self.recv_append_cnt = 0
        self.send_append_cnt = 0

    def recv_append(self) -> None:
        with self._lock:
            self.recv_append_cnt += 1

    def send_append(self) -> None:
        with self._lock:
            self.send_append_cnt += 1

    def set_state(self, state_idx: int, leader_id: int) -> None:
        with self._lock:
            name = STATE_NAMES[state_idx] \
                if 0 <= state_idx < 3 else "StateFollower"
            if leader_id != self.leader_id or name != self.state:
                self.leader_since = time.time()
            self.state = name
            self.leader_id = leader_id

    def to_dict(self) -> dict:
        with self._lock:
            now = time.time()
            uptime = now - (self.leader_since or now)
            return {
                "name": self.name,
                "id": f"{self.id:x}",
                "state": self.state,
                "startTime": time.strftime(
                    "%Y-%m-%dT%H:%M:%S%z",
                    time.localtime(self.start_time)),
                "leaderInfo": {
                    "leader": f"{self.leader_id:x}",
                    "uptime": f"{uptime:.6f}s",
                },
                "recvAppendRequestCnt": self.recv_append_cnt,
                "sendAppendRequestCnt": self.send_append_cnt,
            }

    def to_json(self) -> bytes:
        return json.dumps(self.to_dict()).encode()


class LeaderStats:
    """Per-follower replication counters while this member leads."""

    def __init__(self, id: int):
        self.id = id
        self._lock = threading.Lock()
        self.followers: dict[str, dict] = {}

    def _entry(self, follower_id: int) -> dict:
        return self.followers.setdefault(
            f"{follower_id:x}",
            {"latency": {"current": 0.0, "average": 0.0,
                         "minimum": float("inf"), "maximum": 0.0},
             "counts": {"success": 0, "fail": 0}})

    def observe(self, follower_id: int, latency_s: float) -> None:
        with self._lock:
            f = self._entry(follower_id)
            lat = f["latency"]
            cnt = f["counts"]
            cnt["success"] += 1
            ms = latency_s * 1e3
            lat["current"] = ms
            lat["minimum"] = min(lat["minimum"], ms)
            lat["maximum"] = max(lat["maximum"], ms)
            lat["average"] += (ms - lat["average"]) / cnt["success"]

    def fail(self, follower_id: int) -> None:
        with self._lock:
            self._entry(follower_id)["counts"]["fail"] += 1

    def to_json(self) -> bytes:
        with self._lock:
            followers = {}
            for fid, f in self.followers.items():
                lat = dict(f["latency"])
                if lat["minimum"] == float("inf"):  # failures only:
                    lat["minimum"] = 0.0  # keep the JSON RFC-valid
                followers[fid] = {"latency": lat,
                                  "counts": dict(f["counts"])}
            return json.dumps({
                "leader": f"{self.id:x}",
                "followers": followers,
            }).encode()
