"""CRC32-Castagnoli host digest and GF(2) algebra (the port's own copy
of ``etcd_tpu/crc``): the constants of the device CRC ops are built from
these."""

from .crc32c import Digest, update, value, raw_update, make_table, new_digest
from . import gf2

__all__ = [
    "Digest",
    "update",
    "value",
    "raw_update",
    "make_table",
    "new_digest",
    "gf2",
]
