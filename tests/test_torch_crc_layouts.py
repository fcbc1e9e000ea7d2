"""The host-side operand layouts of the port's two raw-CRC kernels,
driven through numpy emulations of the kernels' arithmetic and held
exactly equal to the JAX package's ``raw_crc_batch`` (its XLA path, on
the CPU).

- ``csrc/raw_crc.cu`` contracts on the 1-bit tensor cores: the A
  operand is a row's bytes as they lie in memory, the B operand
  ``crc_cuda.bit_columns`` (the contribution matrix transposed and
  packed to bits).  The emulation walks the kernel's 128-byte chunks and
  its lanes' 16-byte pieces, feeds the words to the four k-steps of
  ``mma.sync.m16n8k256.and.popc`` in the kernel's order, and takes the
  parity of the popcounts of AND.
- ``csrc/planes_crc.cu`` takes ``planes_cuda.plane_columns`` (each
  plane's C_k^T, K contiguous) and orders the contraction so that an
  operand register is a row word shifted and masked: ``(w >> P) &
  0x01010101`` in int8, ``((w >> P) & 0x00010001) * 1.0`` over even and
  odd bytes in bf16.  The emulation builds the kernel's shared-memory
  cores from ``plane_columns`` and sums the same products.
The kernels themselves are held against their plain versions on the
card by chip_smoke.py.
"""

import numpy as np
import pytest

from etcd_tpu.ops import crc_device as jdev
from etcd_tpu.ops import crc_variants as jv

from etcd_tpu_torch.ops import crc_cuda, planes_cuda

LENGTHS = [1, 4, 33, 64, 384, 4096]


def _rows(seed, n, length):
    """Right-aligned random records of random lengths."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 256, size=(n, length), dtype=np.uint8)
    lens = rng.integers(0, length + 1, size=n)
    lens[0] = length
    rows[np.arange(length)[None, :] < (length - lens)[:, None]] = 0
    return rows


def _pack(bits):
    """0/1 [n, 32] -> uint32 [n], bit j from column j."""
    return (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(
        axis=1).astype(np.uint32)


def _reference(rows):
    return np.asarray(jdev.raw_crc_batch(rows, use_pallas=False))


def _emulate_raw_crc(rows):
    """raw_crc.cu's arithmetic in numpy: for each 128-byte chunk and
    lane t, the pieces at c0 + 16t and c0 + 64 + 16t, four k-steps of
    (a0, a2) words against the same words of each B column, popcount of
    AND, parity."""
    n, length = rows.shape
    cols = crc_cuda.bit_columns(length)            # [32, Lp]
    lp = cols.shape[1]
    padded = np.zeros((n, lp), np.uint8)
    padded[:, :length] = rows
    acc = np.zeros((n, 32), np.int64)
    for c0 in range(0, lp, crc_cuda.CHUNK):
        for t in range(4):
            lo, hi = c0 + 16 * t, c0 + 64 + 16 * t
            p0 = np.ascontiguousarray(padded[:, lo:lo + 16]).view("<u4")
            p1 = np.ascontiguousarray(padded[:, hi:hi + 16]).view("<u4")
            q0 = np.ascontiguousarray(cols[:, lo:lo + 16]).view("<u4")
            q1 = np.ascontiguousarray(cols[:, hi:hi + 16]).view("<u4")
            for a, b in ((p0, q0), (p1, q1)):
                for step in (0, 2):  # (a0, a2) = words (step, step + 1)
                    for w in (step, step + 1):
                        acc += np.bitwise_count(
                            a[:, w][:, None] & b[:, w][None, :])
    return _pack(acc & 1)


@pytest.mark.parametrize("length", LENGTHS)
def test_bit_columns_through_the_1bit_products(length):
    rows = _rows(length, 40, length)
    np.testing.assert_array_equal(_emulate_raw_crc(rows), _reference(rows))


@pytest.mark.parametrize("length", LENGTHS)
def test_bit_columns_hold_the_contribution_matrix(length):
    """Byte i of column j holds C[8i + k, j] at bit k; zeros past L,
    and the width is a whole number of the kernel's chunks."""
    cols = crc_cuda.bit_columns(length)
    assert cols.dtype == np.uint8
    assert cols.shape == (32, crc_cuda.padded_width(length))
    assert cols.shape[1] % crc_cuda.CHUNK == 0
    assert not cols[:, length:].any()
    bits = (cols[:, :length, None] >> np.arange(8)) & 1    # [32, L, 8]
    c = np.asarray(jdev.contribution_matrix(length))       # [8L, 32]
    np.testing.assert_array_equal(bits.reshape(32, 8 * length).T, c)


@pytest.mark.parametrize("length", LENGTHS)
def test_plane_columns_are_the_plane_matrices_transposed(length):
    ckt = planes_cuda.plane_columns(length)
    assert ckt.dtype == np.int8
    assert ckt.shape[:2] == (8, 32) and ckt.shape[2] % planes_cuda.CHUNK == 0
    assert ckt.shape[2] - length < planes_cuda.CHUNK
    np.testing.assert_array_equal(
        ckt[:, :, :length], np.asarray(jv.plane_matrices(length)).transpose(0, 2, 1))
    assert not ckt[:, :, length:].any()


def _cores(ckt, operand):
    """planes_crc.cu's shared-memory C, from ``plane_columns``: int8
    cores (plane k, group G) of [32 columns, 16 bytes]; bf16 cores
    (k, G, half) of [32, 8], half 0 the even bytes of the group."""
    g = ckt.shape[2] // 16
    c = ckt.reshape(8, 32, g, 16).transpose(0, 2, 1, 3)    # [8, G, 32, 16]
    if operand == "int8":
        return c
    return np.stack([c[..., 0::2], c[..., 1::2]], axis=2)  # [8, G, 2, 32, 8]


def _emulate_planes(rows, operand, perturb):
    """planes_crc.cu's products in numpy (one orientation; the other
    sums the same products).  k-step (G, P): lane t's word w of the
    row's group G gives int8 operands (w >> P) & 0x01010101 and
    (w >> (P + 4)) & 0x01010101 against cores (P, G) and (P + 4, G), or
    bf16 operands (w >> P) & 0x00010001 and (w >> (P + 8)) & 0x00010001
    (bytes 0, 2 and 1, 3) against the even and odd halves of core
    (P, G)."""
    n, length = rows.shape
    ckt = planes_cuda.plane_columns(length).astype(np.int64)
    lc = ckt.shape[2]
    padded = np.zeros((n, lc), np.uint8)
    padded[:, :length] = rows
    words = (padded ^ np.uint8(perturb)).view("<u4")       # [n, lc / 4]
    cores = _cores(ckt, operand)
    acc = np.zeros((n, 32), np.int64)
    for gg in range(lc // 16):
        for t in range(4):
            w = words[:, 4 * gg + t].astype(np.int64)
            if operand == "int8":
                for p in range(4):
                    for plane, shift in ((p, p), (p + 4, p + 4)):
                        ops = np.stack([(w >> (shift + 8 * j)) & 1
                                        for j in range(4)], axis=1)
                        acc += ops @ cores[plane, gg, :, 4 * t:4 * t + 4].T
            else:
                for p in range(8):
                    for half, shift in ((0, p), (1, p + 8)):
                        ops = np.stack([(w >> (shift + 16 * j)) & 1
                                        for j in range(2)], axis=1)
                        acc += ops @ cores[p, gg, half, :, 2 * t:2 * t + 2].T
    return _pack(acc & 1)


@pytest.mark.parametrize("operand", sorted(planes_cuda.OPERANDS))
@pytest.mark.parametrize("length", [4, 33, 64, 384])
def test_plane_columns_through_the_planes_products(length, operand):
    rows = _rows(length + 7, 24, length)
    for perturb in (0, 3, 255):
        np.testing.assert_array_equal(
            _emulate_planes(rows, operand, perturb),
            _reference(rows ^ np.uint8(perturb)),
            err_msg=f"perturb={perturb}")
