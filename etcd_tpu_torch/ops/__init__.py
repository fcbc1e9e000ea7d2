"""Device ops: batched CRC32-Castagnoli (a hand-written CUDA kernel and
its plain torch version) and batched quorum commit index."""

from .crc_device import (
    crc32c_batch,
    chain_verify_device,
    raw_crc_batch,
    shift_crc_batch,
)
from .quorum import commit_index_batch, maybe_commit_batch

__all__ = [
    "crc32c_batch",
    "chain_verify_device",
    "raw_crc_batch",
    "shift_crc_batch",
    "commit_index_batch",
    "maybe_commit_batch",
]
