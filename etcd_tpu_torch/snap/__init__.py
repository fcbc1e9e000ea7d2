"""Snapshots: CRC-protected snapshot files (``snapshotter.Snapshotter``,
whose pluggable ``crc_fn`` takes the raw-CRC kernel on the card for
large blobs) and the verifier of streamed snapshot chunks
(``stream.ChunkVerifier``), the port of the part of ``etcd_tpu/snap``
on the card's path."""

from .snapshotter import (
    DEFAULT_SNAP_KEEP,
    NoSnapshotError,
    SnapCRCMismatchError,
    SnapEmptyError,
    Snapshotter,
)
from .stream import ChunkVerifier

__all__ = [
    "ChunkVerifier",
    "DEFAULT_SNAP_KEEP",
    "NoSnapshotError",
    "SnapCRCMismatchError",
    "SnapEmptyError",
    "Snapshotter",
]
