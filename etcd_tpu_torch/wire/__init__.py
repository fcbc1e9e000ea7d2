"""Protobuf codecs of the WAL's records (the port's own copy of the part
of ``etcd_tpu/wire`` the WAL uses), byte-compatible with the reference's
generated marshalers, so WAL segments written by either package replay
in the other."""

from .proto import (
    ENTRY_NORMAL,
    Entry,
    HardState,
    ProtoError,
    Record,
    is_empty_hard_state,
)

__all__ = [
    "ENTRY_NORMAL",
    "Entry",
    "HardState",
    "ProtoError",
    "Record",
    "is_empty_hard_state",
]
