"""Raft consensus: ``core`` is the single-group state machine (reference
raft/raft.go), ``log`` its entry log and ``node`` the serialized driver
that emits Ready batches (the classic single-group server's, copies of
``etcd_tpu/raft/{core,log,node}.py``); ``batched`` is the [G, ...]-
batched engine on the card, ``multiraft`` the co-hosted G-groups x
M-members runtime on it and ``distmember`` one host's member slot of G
groups (the port of ``etcd_tpu/raft/batched.py``, ``multiraft.py`` and
``distmember.py``).  Only the first three are imported here: they need
no torch."""

from .core import (
    NONE,
    Progress,
    Raft,
    RaftPanicError,
    SoftState,
    STATE_CANDIDATE,
    STATE_FOLLOWER,
    STATE_LEADER,
)
from .log import LogError, RaftLog
from .node import (
    Node,
    Peer,
    Ready,
    StoppedError,
    restart_node,
    start_node,
)

__all__ = [
    "NONE",
    "Raft",
    "RaftLog",
    "RaftPanicError",
    "LogError",
    "Progress",
    "SoftState",
    "STATE_FOLLOWER",
    "STATE_CANDIDATE",
    "STATE_LEADER",
    "Node",
    "Peer",
    "Ready",
    "StoppedError",
    "start_node",
    "restart_node",
]
