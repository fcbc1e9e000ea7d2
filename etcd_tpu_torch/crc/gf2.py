"""GF(2) linear algebra for parallel CRC combination.

CRC32 state evolution is linear over GF(2): processing ``k`` zero bytes
multiplies the 32-bit state (as a bit-vector) by a fixed 32x32 matrix
``Z^k``.  This gives the classic ``crc32_combine`` identity

    update(c1, m2) == (Z^len(m2) @ c1) ^ value(m2)

which converts the reference WAL's strictly-sequential rolling checksum
(wal/decoder.go:45-46 chained across segments via crcType records,
wal/wal.go:229-237) into:

    1. per-record ``value(data_i)`` — embarrassingly parallel (device),
    2. a batched affine fix-up ``Z^len_i @ prev_crc_i`` — vectorized
       here as [N,32] x [32,32] bit-matmuls over the bits of ``len_i``.

Matrix convention: ``M`` is a numpy uint8 [32,32] 0/1 matrix acting on
bit-vectors ``v`` (bit i of the uint32 == v[i]) by ``(M @ v) % 2``.

The port's own copy of ``etcd_tpu/crc/gf2.py``: the port imports nothing
of ``etcd_tpu``, so the host algebra it builds its constants from lives
here too, line for line the same.
"""

from __future__ import annotations

import numpy as np

from .crc32c import TABLE

_MASK32 = 0xFFFFFFFF
_BITS = np.arange(32, dtype=np.uint32)


def to_bits(x) -> np.ndarray:
    """uint32 scalar/array -> 0/1 bit array with trailing axis 32."""
    x = np.asarray(x, dtype=np.uint32)
    return ((x[..., None] >> _BITS) & 1).astype(np.uint8)


def from_bits(bits: np.ndarray) -> np.ndarray:
    """0/1 bit array [...,32] -> uint32 array."""
    b = bits.astype(np.uint32)
    return (b << _BITS).sum(axis=-1, dtype=np.uint32)


def identity() -> np.ndarray:
    return np.eye(32, dtype=np.uint8)


def matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a.astype(np.uint32) @ b.astype(np.uint32) % 2).astype(np.uint8)


def matvec(m: np.ndarray, x: int) -> int:
    v = to_bits(np.uint32(x))
    out = m.astype(np.uint32) @ v.astype(np.uint32) % 2
    return int(from_bits(out.astype(np.uint8)))


def _zero_byte_operator() -> np.ndarray:
    """Z^1: the state map for one zero byte, s' = T[s & 0xff] ^ (s >> 8).

    Column j is the image of unit bit j.
    """
    m = np.zeros((32, 32), dtype=np.uint8)
    for j in range(32):
        s = 1 << j
        out = int(TABLE[s & 0xFF]) ^ (s >> 8)
        m[:, j] = to_bits(np.uint32(out))
    return m


Z1 = _zero_byte_operator()

# Z^(2^k) for k in [0, 63): enough for any offset length.
_POWERS: list[np.ndarray] = [Z1]
for _ in range(62):
    _POWERS.append(matmul(_POWERS[-1], _POWERS[-1]))


def inverse(m: np.ndarray) -> np.ndarray:
    """Invert a [32,32] GF(2) matrix by Gaussian elimination.

    Every ``Z^k`` is invertible (processing zero bytes is a bijection
    on CRC states), so this never fails for the operators built here;
    raises ValueError on a singular input.
    """
    a = np.concatenate([m.astype(np.uint8) & 1, identity()], axis=1)
    n = m.shape[0]
    for col in range(n):
        piv = col + int(np.argmax(a[col:, col]))
        if a[piv, col] == 0:
            raise ValueError("singular GF(2) matrix")
        if piv != col:
            a[[col, piv]] = a[[piv, col]]
        elim = (a[:, col] == 1) & (np.arange(n) != col)
        a[elim] ^= a[col]
    return a[:, n:].copy()


def zero_operator(nbytes: int) -> np.ndarray:
    """Z^nbytes — advance a CRC state across nbytes of zeros."""
    m = identity()
    k = 0
    n = nbytes
    while n:
        if n & 1:
            m = matmul(_POWERS[k], m)
        n >>= 1
        k += 1
    return m


def shift(crc_state: int, nbytes: int) -> int:
    """raw state after nbytes zero bytes (no inversion convention)."""
    return matvec(zero_operator(nbytes), crc_state)


def combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC of concatenation: crc(m1||m2) from crc(m1), crc(m2), len(m2).

    Standard-convention CRCs (zlib crc32_combine semantics); equals
    ``update(crc1, m2)``.
    """
    return matvec(zero_operator(len2), crc1) ^ crc2


def combine_batch(prev: np.ndarray, crcs: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Vectorized ``combine``: out[i] = Z^lens[i] @ prev[i] ^ crcs[i].

    Loops over the ~30 bits of the length, not over N: records whose
    length has bit k set get one [N,32]@[32,32] matmul applied.
    """
    prev = np.asarray(prev, dtype=np.uint32)
    crcs = np.asarray(crcs, dtype=np.uint32)
    lens = np.asarray(lens, dtype=np.uint64)
    bits = to_bits(prev).astype(np.uint32)  # [N, 32]
    maxlen = int(lens.max()) if lens.size else 0
    k = 0
    while (1 << k) <= maxlen:
        mask = ((lens >> np.uint64(k)) & np.uint64(1)).astype(bool)
        if mask.any():
            shifted = bits[mask] @ _POWERS[k].T.astype(np.uint32) % 2
            bits[mask] = shifted
        k += 1
    return from_bits(bits.astype(np.uint8)) ^ crcs


def chain_verify(seed: int, stored: np.ndarray, crcs: np.ndarray,
                 lens: np.ndarray) -> np.ndarray:
    """Verify a rolling-CRC chain in parallel.

    stored[i] is the CRC recorded for record i (expected to equal
    ``update(stored[i-1], data_i)`` with ``stored[-1] == seed``);
    crcs[i] is ``value(data_i)`` computed independently (e.g. on
    device).  Returns a bool array: True where the chain holds.
    """
    stored = np.asarray(stored, dtype=np.uint32)
    prev = np.empty_like(stored)
    if stored.size:
        prev[0] = np.uint32(seed & _MASK32)
        prev[1:] = stored[:-1]
    expect = combine_batch(prev, crcs, lens)
    return expect == stored
