"""Vectorised host WAL builder: right-aligned random records and their
rolling CRC32C chain, at a million records in seconds.

A per-record ``crc32c.update`` in pure Python is far too slow at that
size, so the raw CRCs come from a column-serial walk of the byte table
over all rows at once, and the chain from a fold over per-length 4x256
shift tables; sampled links are checked against ``crc32c.update``.
``chip_smoke.py`` and the variant race (``crc_variants_bench``) build
their data here.
"""

from __future__ import annotations

import numpy as np

from ..crc import crc32c, gf2
from ..ops.crc_device import inject_seeds

_MASK32 = 0xFFFFFFFF


def raw_crcs(buf: np.ndarray) -> np.ndarray:
    """Raw CRC32C state of every right-aligned row: a column-serial walk
    of the byte table over all rows at once (uint32 [N])."""
    table = crc32c.TABLE
    s = np.zeros(buf.shape[0], np.uint32)
    for col in np.ascontiguousarray(buf.T):
        s = table[(s ^ col) & 0xFF] ^ (s >> 8)
    return s


def _shift_tables(length: int) -> list[list[int]]:
    """t[k][b] = Z^length @ (b << 8k): Z^length applied to a 32-bit state
    as four byte lookups."""
    z = gf2.zero_operator(length)
    cols = gf2.from_bits(z.T)  # word j = image of state bit j
    b = np.arange(256, dtype=np.uint32)
    out = []
    for k in range(4):
        t = np.zeros(256, np.uint32)
        for m in range(8):
            t ^= np.where((b >> m) & 1, cols[8 * k + m], np.uint32(0))
        out.append([int(x) for x in t])
    return out


def chain(raw: np.ndarray, lens: np.ndarray, seed_val: int) -> np.ndarray:
    """The WAL's rolling CRC chain, stored[i] = update(stored[i-1],
    data_i) with stored[-1] = seed_val, from the raw CRCs:
    update(p, m) = Z^len(m) (p ^ ~0) ^ raw(m) ^ ~0, folded in order."""
    tabs = {int(l): _shift_tables(int(l)) for l in np.unique(lens)}
    out = np.empty(raw.size, np.uint32)
    prev = seed_val
    for i, (r, l) in enumerate(zip(raw.tolist(), lens.tolist())):
        t0, t1, t2, t3 = tabs[l]
        x = prev ^ _MASK32
        prev = (t0[x & 0xFF] ^ t1[(x >> 8) & 0xFF] ^ t2[(x >> 16) & 0xFF]
                ^ t3[x >> 24] ^ r ^ _MASK32)
        out[i] = prev
    return out


def make_wal(n: int, width: int, lo: int, hi: int, seed_val: int,
             seed: int, n_check: int = 1000):
    """``n`` records of ``lo``..``hi`` random bytes right-aligned in
    ``width``-byte rows, and their rolling CRC chain from ``seed_val``;
    ``n_check`` sampled links are checked against ``crc32c.update``
    (RuntimeError on a mismatch).  Returns (buf, lens, stored)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, size=n).astype(np.int32)
    buf = rng.integers(0, 256, size=(n, width), dtype=np.uint8)
    buf[np.arange(width)[None, :] < (width - lens)[:, None]] = 0
    stored = chain(raw_crcs(buf), lens, seed_val)
    for i in rng.choice(n, size=min(n, n_check), replace=False):
        prev = seed_val if i == 0 else int(stored[i - 1])
        data = buf[i, width - lens[i]:].tobytes()
        if crc32c.update(prev, data) != int(stored[i]):
            raise RuntimeError(f"host chain disagrees with crc32c.update "
                               f"at record {i}")
    return buf, lens, stored


def injected(buf: np.ndarray, lens: np.ndarray, stored: np.ndarray,
             seed_val: int) -> np.ndarray:
    """A copy of ``buf`` with each record's chain predecessor
    (``seed_val``, then ``stored[:-1]``) written into the 4 padding
    bytes left of it, so that ``raw ^ ~0 == stored`` link by link
    (``crc_device.inject_seeds``).  Needs ``lens + 4 <= width``."""
    prev = np.concatenate([np.asarray([seed_val], np.uint32),
                           np.asarray(stored[:-1], np.uint32)])
    return inject_seeds(buf.copy(), lens, prev)
