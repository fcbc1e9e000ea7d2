"""The raw CRC's contribution matrix and the bit helpers that both the
torch ops (``crc_device``) and the kernel's module (``crc_cuda``) use.

Re-exported by ``crc_device`` under the names of
``etcd_tpu/ops/crc_device.py``; kept apart so that ``crc_cuda`` does not
depend on ``crc_device`` and ``crc_device`` can import the kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..crc import crc32c as _host
from ..crc import gf2


@functools.lru_cache(maxsize=16)
def contribution_matrix(length: int) -> np.ndarray:
    """``[8*length, 32]`` int8 matrix C: bits(row) @ C == raw CRC.

    Row ``8*i + k`` is the raw-CRC contribution of bit ``k`` (LSB
    first) of byte ``i`` (byte 0 = leftmost / most-padded position).
    Built by walking positions right-to-left with an accumulated
    zero-byte operator, so construction is O(L) 32x32 GF(2) matmuls.
    """
    t8 = np.zeros((32, 8), dtype=np.uint8)
    for k in range(8):
        t8[:, k] = gf2.to_bits(np.uint32(_host.TABLE[1 << k]))
    c = np.zeros((8 * length, 32), dtype=np.int8)
    acc = gf2.identity()  # Z^(L-1-i) as i walks right-to-left
    for i in range(length - 1, -1, -1):
        block = gf2.matmul(acc, t8)  # [32, 8]
        c[8 * i:8 * i + 8, :] = block.T
        acc = gf2.matmul(gf2.Z1, acc)
    return c


@functools.lru_cache(maxsize=32)
def _contribution_f32(length: int, device: torch.device) -> torch.Tensor:
    """:func:`contribution_matrix`, float32, uploaded once per
    (length, device)."""
    return torch.from_numpy(
        contribution_matrix(length).astype(np.float32)).to(device)


def _to_bits32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values (int64) [...,] -> int8 bits [..., 32] (LSB first)."""
    bit32 = torch.arange(32, dtype=torch.int64, device=x.device)
    return ((x[..., None] >> bit32) & 1).to(torch.int8)


def _from_bits32(bits: torch.Tensor) -> torch.Tensor:
    """0/1 bits [..., 32] of any number type -> int64 uint32 values."""
    bit32 = torch.arange(32, dtype=torch.int64, device=bits.device)
    return (bits.to(torch.int64) << bit32).sum(dim=-1)


def _unpack_bits(buf: torch.Tensor) -> torch.Tensor:
    """uint8 [N, L] -> int8 [N, 8L], LSB-first within each byte."""
    n, length = buf.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=buf.device)
    bits = (buf[:, :, None] >> shifts) & 1
    return bits.reshape(n, 8 * length).to(torch.int8)
