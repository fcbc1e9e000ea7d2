"""Protobuf codecs (the port's own copy of the part of ``etcd_tpu/wire``
the WAL, the snapshotter and the servers use), byte-compatible with the
reference's generated marshalers, so WAL segments and snapshot files
written by either package replay in the other.  The dist tier's frames
(``distmsg``, ``clientmsg``, ``rolemsg``, declared in ``schema``) are
copies too, byte-equal on the wire."""

from .proto import (
    CONF_CHANGE_ADD_NODE,
    CONF_CHANGE_REMOVE_NODE,
    ENTRY_CONF_CHANGE,
    ENTRY_NORMAL,
    ConfChange,
    Entry,
    GroupEntry,
    HardState,
    ProtoError,
    Record,
    SnapPb,
    Snapshot,
    is_empty_hard_state,
    is_empty_snap,
    marshal_group_entries,
)

__all__ = [
    "CONF_CHANGE_ADD_NODE",
    "CONF_CHANGE_REMOVE_NODE",
    "ENTRY_CONF_CHANGE",
    "ENTRY_NORMAL",
    "ConfChange",
    "Entry",
    "GroupEntry",
    "HardState",
    "ProtoError",
    "Record",
    "SnapPb",
    "Snapshot",
    "is_empty_hard_state",
    "is_empty_snap",
    "marshal_group_entries",
]
