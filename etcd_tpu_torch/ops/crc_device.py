"""Batched CRC32-Castagnoli on the card: a bit contraction over GF(2).

The port of ``etcd_tpu/ops/crc_device.py``, with the same names and the
same three steps:

1. **Per-record raw CRC.**  For records right-aligned (left
   zero-padded) in an ``[N, L]`` uint8 buffer, the raw CRC state (no
   pre/post inversion) of each row is ``bits(row) @ C`` over GF(2), with
   ``C`` the ``[8L, 32]`` contribution matrix (row ``8i+k`` = effect of
   bit ``k`` of byte ``i``).  On CUDA this is the hand-written kernel of
   ``crc_cuda.py``; on the CPU its plain torch version.
2. **Seed/length fix-up.**  ``update(c, m) == Z^len(m) @ (c ^ ~0) ^
   raw(m) ^ ~0`` with ``Z`` the one-zero-byte operator: masked
   ``[N,32] @ [32,32]`` parity products over the bits of ``len``.
3. **Chain verify.**  Record i's stored CRC must equal
   ``update(stored[i-1], data_i)``: every link is checked at once
   against the stored previous value.

Representation: CRC states travel as int64 tensors holding the uint32
value (torch has no shift ops for uint32 on the CPU).  ``u32_numpy`` and
``u32_tensor`` convert at the boundary with numpy uint32.

Integer products: torch has no integer matmul on CUDA, so the GF(2)
contractions here multiply 0/1 float32 operands.  That is exact on both
devices: every sum is a count of at most ``8L <= 32768 < 2**24`` ones,
and 0/1 operands lose nothing in TF32 either (``entry`` and
``chip_smoke.py`` turn TF32 off all the same).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..crc import gf2
from .crc_bits import (  # noqa: F401  (re-exported under the JAX names)
    _from_bits32,
    _to_bits32,
    _unpack_bits,
    contribution_matrix,
)
from .crc_cuda import MAX_LENGTH, raw_crc_cuda, raw_crc_plain

_MASK32 = 0xFFFFFFFF

# -- host-side constant construction ----------------------------------------


@functools.lru_cache(maxsize=4)
def _zpow_stack(nbits: int) -> np.ndarray:
    """``[nbits, 32, 32]`` int8 stack of Z^(2^k) transposed for
    right-multiplication: bits_row @ stack[k] == Z^(2^k) @ state."""
    return np.stack([gf2._POWERS[k].T for k in range(nbits)]).astype(np.int8)


@functools.lru_cache(maxsize=16)
def _invert_table(max_len: int) -> np.ndarray:
    """``A[l] = (Z^l @ 0xFFFFFFFF) ^ 0xFFFFFFFF`` for l in [0, max_len].

    With this, Go-convention ``update(0, m) == raw(m) ^ A[len(m)]``.
    """
    out = np.empty(max_len + 1, dtype=np.uint32)
    state = _MASK32  # Z^0 @ ~0
    out[0] = 0
    for l in range(1, max_len + 1):
        state = gf2.matvec(gf2.Z1, state)
        out[l] = np.uint32(state ^ _MASK32)
    return out


# The same constants, uploaded once per (shape, device).


@functools.lru_cache(maxsize=8)
def _zpow_f32(nbits: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_zpow_stack(nbits).astype(np.float32)).to(device)


@functools.lru_cache(maxsize=32)
def _invert_table_t(max_len: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(
        _invert_table(max_len).astype(np.int64)).to(device)


# -- boundary with numpy uint32 ----------------------------------------------


def u32_tensor(x, device=None) -> torch.Tensor:
    """uint32 values (numpy, a scalar or a tensor) -> int64 tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=torch.int64) & _MASK32
    a = np.asarray(x, dtype=np.uint32).astype(np.int64)
    return torch.from_numpy(a).to(device or "cpu")


def u32_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 tensor of uint32 values -> numpy uint32."""
    return t.detach().cpu().numpy().astype(np.uint32)


# -- core ops ----------------------------------------------------------------


def raw_crc_batch(buf: torch.Tensor) -> torch.Tensor:
    """Raw (no-inversion) CRC states of right-aligned rows: int64 [N].

    ``buf`` is ``[N, L]`` uint8 with each record's bytes occupying the
    *rightmost* ``len`` columns and zeros elsewhere.  A CPU tensor takes
    the plain torch version; any other launches the CUDA kernel, which
    raises where it cannot run.  Rows wider than the kernel's
    ``MAX_LENGTH`` are folded from slabs of that width
    (:func:`_raw_crc_wide`), so a CUDA tensor of any width reaches the
    kernel.
    """
    if buf.shape[1] > MAX_LENGTH:
        return _raw_crc_wide(buf)
    if buf.device.type == "cpu":
        return raw_crc_plain(buf)
    return raw_crc_cuda(buf)


def _xor_rows(states: torch.Tensor) -> torch.Tensor:
    """XOR of each row of int64 uint32 values [N, S]: int64 [N], as a
    per-bit parity sum."""
    return _from_bits32(_to_bits32(states).sum(dim=1, dtype=torch.int32) & 1)


def _raw_crc_wide(buf: torch.Tensor) -> torch.Tensor:
    """:func:`raw_crc_batch` for rows wider than ``MAX_LENGTH``.

    By linearity over GF(2), ``raw(s_0 ++ ... ++ s_{S-1}) = XOR_j
    Z^(MAX_LENGTH (S-1-j)) raw(s_j)`` (``Z`` the one-zero-byte
    operator): the rows are left-padded to a multiple of ``MAX_LENGTH``
    (free for right-aligned rows: leading zeros leave a zero raw state
    zero), viewed as ``[N*S, MAX_LENGTH]``
    slabs whose raw states come from the kernel (or its plain version),
    each slab's state is shifted past the bytes to its right
    (:func:`shift_crc_batch`), and each row's slabs are XOR-reduced.
    The contribution matrix stays ``MAX_LENGTH`` bytes wide."""
    n, length = buf.shape
    slabs = -(-length // MAX_LENGTH)
    width = slabs * MAX_LENGTH
    if width != length:
        padded = buf.new_zeros((n, width))
        padded[:, width - length:] = buf
        buf = padded
    raws = raw_crc_batch(buf.contiguous().view(n * slabs, MAX_LENGTH))
    suffix = torch.arange(slabs - 1, -1, -1, dtype=torch.int64,
                          device=buf.device) * MAX_LENGTH
    shifted = shift_crc_batch(
        raws, suffix.repeat(n),
        nbits=((slabs - 1) * MAX_LENGTH).bit_length() or 1)
    return _xor_rows(shifted.view(n, slabs))


def shift_crc_batch(states: torch.Tensor, lens: torch.Tensor,
                    nbits: int = 32) -> torch.Tensor:
    """``Z^lens[i] @ states[i]`` elementwise: int64 [N].

    Loops over the low ``nbits`` bits of ``lens`` (default 32: the full
    uint32 range) with masked [N,32]@[32,32] parity products — the
    device form of gf2.combine_batch.
    """
    zp = _zpow_f32(nbits, states.device)  # [nbits, 32, 32]
    bits = _to_bits32(states).to(torch.float32)  # [N, 32]
    lens = lens.to(torch.int64)
    for k in range(nbits):
        shifted = torch.remainder(bits @ zp[k], 2)
        take = ((lens >> k) & 1).bool()
        bits = torch.where(take[:, None], shifted, bits)
    return _from_bits32(bits)


def crc32c_batch(buf: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Go-convention ``crc32.Update(0, castagnoli, m_i)`` for each row.

    ``buf`` [N, L] uint8 right-aligned, ``lens`` [N] actual byte
    lengths.  Equals ``crc.value(m_i)`` from the host path.
    """
    raw = raw_crc_batch(buf)
    atab = _invert_table_t(buf.shape[1], buf.device)
    return raw ^ atab[lens.to(torch.int64)]


def _chain_expected(prev_stored: torch.Tensor, raw: torch.Tensor,
                    lens: torch.Tensor, nbits: int = 32) -> torch.Tensor:
    """update(prev_stored[i], m_i) given raw CRCs: int64 [N]."""
    inv = prev_stored ^ _MASK32
    shifted = shift_crc_batch(inv, lens, nbits=nbits)
    return shifted ^ raw ^ _MASK32


def chain_verify_device(seed: int, stored: torch.Tensor, raw: torch.Tensor,
                        lens: torch.Tensor,
                        max_len: int | None = None) -> torch.Tensor:
    """Parallel rolling-chain verification: bool [N].

    ``stored[i]`` is the CRC recorded in record i (must equal
    ``update(stored[i-1], data_i)``, ``stored[-1] == seed``); ``raw``
    is ``raw_crc_batch`` output for the data rows.  True where the
    link holds; all-True implies the full sequential chain holds.
    """
    if stored.numel() == 0:
        return torch.zeros((0,), dtype=torch.bool, device=stored.device)
    prev = torch.cat([stored.new_tensor([int(seed) & _MASK32]),
                      stored[:-1]])
    return chain_links_device(prev, stored, raw, lens, max_len=max_len)


# -- seed injection: the zero-matmul chain verify ----------------------------
#
# Writing p' = Z4^-1 @ (prev ^ ~0) into the 4 padding bytes immediately
# left of each right-aligned record makes the plain raw CRC of the row
# equal update(prev, m) ^ ~0 (see etcd_tpu/ops/crc_device.py for the
# derivation), so the chain verify needs no shift products at all.


@functools.lru_cache(maxsize=1)
def _z4inv_tables() -> np.ndarray:
    """[4, 256] uint32: t[k][b] = Z4^-1 @ (b << 8k) — evaluates
    Z4^-1 @ x with 4 byte-table lookups."""
    z4inv = gf2.inverse(gf2.zero_operator(4))
    t = np.empty((4, 256), np.uint32)
    for k in range(4):
        for b in range(256):
            t[k, b] = gf2.matvec(z4inv, b << (8 * k))
    return t


def inject_seeds(rows: np.ndarray, lens, prev) -> np.ndarray:
    """Write Z4^-1(prev ^ ~0) into each row's 4 padding bytes just
    left of its record (host numpy, vectorized, in place).  After this,

        raw_crc_batch(rows) ^ 0xFFFFFFFF == update(prev[i], m_i)

    Requires 4 bytes of padding: lens + 4 <= rows.shape[1].
    """
    lens = np.asarray(lens, np.int64)
    n, w = rows.shape
    if n == 0:
        return rows
    if int(lens.max()) + 4 > w:
        raise ValueError(f"need 4 padding bytes: max len "
                         f"{int(lens.max())} + 4 > width {w}")
    t = _z4inv_tables()
    x = np.asarray(prev, np.uint32) ^ np.uint32(_MASK32)
    y = (t[0, x & 0xFF] ^ t[1, (x >> 8) & 0xFF]
         ^ t[2, (x >> 16) & 0xFF] ^ t[3, (x >> 24) & 0xFF])
    cols = (w - lens - 4)[:, None] + np.arange(4)
    vals = (y[:, None] >> (8 * np.arange(4, dtype=np.uint32))
            ).astype(np.uint8)
    rows[np.arange(n)[:, None], cols] = vals
    return rows


def chain_links_injected(rows_raw: torch.Tensor,
                         stored: torch.Tensor) -> torch.Tensor:
    """Chain verification for seed-injected rows: bool [N].

    ``rows_raw`` is ``raw_crc_batch`` output for rows prepared by
    :func:`inject_seeds`; ``stored`` the recorded CRCs."""
    return (rows_raw ^ _MASK32) == stored


def chain_links_device(prev: torch.Tensor, stored: torch.Tensor,
                       raw: torch.Tensor, lens: torch.Tensor,
                       max_len: int | None = None) -> torch.Tensor:
    """Link-wise chain verification with an explicit prev vector:
    bool [N] where ``update(prev[i], data_i) == stored[i]``.

    ``max_len``, when known (the padded row width), bounds the
    seed-shift loop to ``ceil(log2(max_len+1))`` rounds instead of 32.
    """
    if prev.numel() == 0:
        return torch.zeros((0,), dtype=torch.bool, device=prev.device)
    nbits = 32 if max_len is None else max(1, int(max_len).bit_length())
    return _chain_expected(prev, raw, lens, nbits=nbits) == stored
