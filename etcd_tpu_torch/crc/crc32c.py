"""CRC32-Castagnoli host implementation.

Semantics match Go's ``hash/crc32`` with the Castagnoli table as used
throughout the reference (wal/wal.go:49, snap/snapshotter.go:26), and
the seedable digest of pkg/crc/crc.go:23:

The port's own copy of ``etcd_tpu/crc/crc32c.py``: the port imports nothing of
``etcd_tpu``, so the host algebra it builds its constants from lives here
too, line for line the same.

- ``update(crc, data)`` == Go ``crc32.Update(crc, castagnoliTable, data)``
  (pre/post inversion per call; increments chain across calls).
- ``Digest(prev)`` == Go ``crc.New(prev, crcTable)`` — a digest whose
  state *seeds from a previous Sum32 value*.

Fast path uses the hardware-accelerated ``google_crc32c`` wheel when
present; the table fallback is pure numpy/python.
"""

from __future__ import annotations

import numpy as np

try:  # hardware-accelerated (SSE4.2/ARMv8 CRC instructions)
    import google_crc32c as _gcrc
except ImportError:  # pragma: no cover
    _gcrc = None

# Reflected Castagnoli polynomial, as in Go's crc32.Castagnoli table.
POLY_REFLECTED = 0x82F63B78

_MASK32 = 0xFFFFFFFF


def make_table() -> np.ndarray:
    """256-entry lookup table for the reflected-polynomial recurrence."""
    tab = np.empty(256, dtype=np.uint32)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (POLY_REFLECTED if crc & 1 else 0)
        tab[i] = crc
    return tab


TABLE = make_table()
_TABLE_INT = [int(x) for x in TABLE]


def raw_update(state: int, data: bytes) -> int:
    """Table recurrence with NO inversions: the pure linear map.

    ``raw_update(s, m)`` is affine in ``s`` over GF(2); the device path
    computes ``raw_update(0, m)`` in parallel and fixes up seeds with
    gf2 matrices.
    """
    s = state & _MASK32
    tab = _TABLE_INT
    for b in data:
        s = tab[(s ^ b) & 0xFF] ^ (s >> 8)
    return s


def _update_py(crc: int, data: bytes) -> int:
    return raw_update(crc ^ _MASK32, data) ^ _MASK32


def update(crc: int, data) -> int:
    """Go ``crc32.Update`` semantics (per-call pre/post inversion)."""
    data = bytes(data)
    if _gcrc is not None:
        return _gcrc.extend(crc & _MASK32, data)
    return _update_py(crc & _MASK32, data)


def value(data) -> int:
    """CRC32C of ``data`` from a zero seed (== ``update(0, data)``)."""
    return update(0, data)


class Digest:
    """Seedable rolling digest — the pkg/crc/crc.go:23 seam.

    ``Digest(prev).write(m); .sum32()`` == Go
    ``d := crc.New(prev, tab); d.Write(m); d.Sum32()``.
    """

    __slots__ = ("crc",)

    def __init__(self, prev: int = 0):
        self.crc = prev & _MASK32

    def write(self, data) -> None:
        self.crc = update(self.crc, data)

    def sum32(self) -> int:
        return self.crc


def new_digest(prev: int = 0) -> Digest:
    return Digest(prev)
