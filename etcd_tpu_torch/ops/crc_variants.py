"""Alternative formulations of the batched raw-CRC contraction.

The port of ``etcd_tpu/ops/crc_variants.py``, with the same names.
Every variant takes uint8 ``[N, L]`` right-aligned rows and returns
their raw CRC32C states as int64 [N] (uint32 values), bit-exact with
``crc_device.raw_crc_batch``; ``scripts/crc_variants_bench.py`` races
them.

- ``raw_crc_planes``: no bit unpack.  The final reduction is a parity,
  and for a byte x, ``(x >> k) & 127 == bit_k(x) (mod 2)``, so

      parity( sum_k ((x >> k) & 127) @ C_k ) == parity( bits @ C )

  with ``C_k [L, 32]`` the bit-k rows of the contribution matrix.
- ``raw_crc_transposed``: the contraction with the output as
  ``[32, N]``, ``C^T @ bits^T``.
- ``raw_crc_planes_t``: both together.
- ``raw_crc_pallas_planes`` / ``raw_crc_pallas_planes_t``: the planes
  contraction as the hand-written tensor-core kernel
  (``planes_cuda.planes_crc_cuda``, ``csrc/planes_crc.cu``) on a CUDA
  tensor, its plain version on a CPU tensor.
- ``raw_crc_int4`` / ``raw_crc_planes4`` (``TPU_RACE_VARIANTS``): the
  reference's int4-operand forms, here with the same 0/1 and ``& 7``
  operands in plain torch.

The plain forms multiply float32 operands (torch has no integer matmul
on CUDA).  That is exact: a 0/1 contraction sums at most ``8L`` ones,
and the ``& 127`` form at most ``8 * L * 127 = 4,161,536 < 2**24`` at
``L = 4096``; the ``& 7`` form less.  They work in row chunks so that
the float32 operands stay near 256 MB at any N.
"""

from __future__ import annotations

import os

import torch

from .crc_bits import _contribution_f32, _from_bits32, _unpack_bits
from .planes_cuda import (
    plane_matrices,
    plane_parity,
    planes_crc_cuda,
    planes_crc_plain,
)

# Bytes of float32 operands a plain variant holds at a time.
_PLAIN_CHUNK_BYTES = 256 << 20


def _chunked(buf: torch.Tensor, width: int, fn) -> torch.Tensor:
    """``fn`` over row chunks of ``buf`` whose float32 operand is
    ``width`` columns wide, into one int64 [N]."""
    n = buf.shape[0]
    step = max(1, _PLAIN_CHUNK_BYTES // (4 * width))
    out = torch.empty(n, dtype=torch.int64, device=buf.device)
    for r0 in range(0, n, step):
        out[r0:r0 + step] = fn(buf[r0:r0 + step])
    return out


def raw_crc_planes(buf: torch.Tensor) -> torch.Tensor:
    """Packed-plane contraction: int64 [N] raw CRC states."""
    return plane_parity(buf, 127)


def raw_crc_transposed(buf: torch.Tensor) -> torch.Tensor:
    """The ``[32, N]`` orientation of the unpacked contraction: int64
    [N]."""
    c = _contribution_f32(buf.shape[1], buf.device)

    def fn(rows):
        bits = _unpack_bits(rows).to(torch.float32)   # [n, 8L]
        acc = c.T @ bits.T                            # [32, n]
        return _from_bits32(torch.remainder(acc, 2).T)

    return _chunked(buf, 8 * buf.shape[1], fn)


def raw_crc_planes_t(buf: torch.Tensor) -> torch.Tensor:
    """Packed planes in the ``[32, N]`` orientation: int64 [N]."""
    return plane_parity(buf, 127, transposed=True)


# -- the packed-planes kernel ------------------------------------------------

#: default tile (rows per block) of the packed-planes kernel; the race
#: script sweeps it, and ``ETCD_CRC_TILE`` overrides it
PLANES_TILE = 1024


def _planes_env_tile() -> int:
    return int(os.environ.get("ETCD_CRC_TILE", PLANES_TILE))


def _pallas_planes(buf: torch.Tensor, tile: int, transposed: bool,
                   perturb: int = 0) -> torch.Tensor:
    """The kernel on a CUDA tensor, its plain version on a CPU one.

    The TPU kernel halved its tile until its VMEM working set fitted a
    budget (``_planes_tile_for``).  The Hopper kernel's shared memory
    does not grow with the tile (a block walks its tile in passes of up
    to 512 rows), so the tile runs as asked, and one the kernel cannot take
    (not in ``planes_cuda.TILES``) raises ValueError."""
    if buf.device.type == "cpu":
        return planes_crc_plain(buf, tile, transposed, perturb)
    return planes_crc_cuda(buf, tile, transposed, perturb)


def raw_crc_pallas_planes(buf: torch.Tensor,
                          tile: int | None = None) -> torch.Tensor:
    """Packed-planes kernel: int64 [N] raw CRC states."""
    return _pallas_planes(buf, tile or _planes_env_tile(), False)


def raw_crc_pallas_planes_t(buf: torch.Tensor,
                            tile: int | None = None) -> torch.Tensor:
    """Packed-planes kernel, ``[32, N]`` orientation: int64 [N]."""
    return _pallas_planes(buf, tile or _planes_env_tile(), True)


# -- the reference's int4-operand variants -----------------------------------


def raw_crc_int4(buf: torch.Tensor) -> torch.Tensor:
    """The dense bit contraction with the 0/1 operands the reference
    gives the MXU as int4: int64 [N]."""
    c = _contribution_f32(buf.shape[1], buf.device)

    def fn(rows):
        bits = _unpack_bits(rows).to(torch.float32)
        return _from_bits32(torch.remainder(bits @ c, 2))

    return _chunked(buf, 8 * buf.shape[1], fn)


def raw_crc_planes4(buf: torch.Tensor) -> torch.Tensor:
    """Packed planes with the reference's 3-bit ``(x >> k) & 7``
    operands (they fit int4's [-8, 7]): int64 [N]."""
    return plane_parity(buf, 7)


#: name -> callable, for the race script and the bench's variant knob
VARIANTS = {
    "planes": raw_crc_planes,
    "transposed": raw_crc_transposed,
    "planes_t": raw_crc_planes_t,
    "pallas_planes": raw_crc_pallas_planes,
    "pallas_planes_t": raw_crc_pallas_planes_t,
}

#: The reference's hardware-only candidates, which bet on the TPU MXU's
#: higher int4 rate.  The card does not race them: the H100 data sheet
#: gives no int4 tensor-core rate (int8 and fp8 are its narrowest), so
#: an int4 operand has nothing to win here.  They stay as plain torch,
#: exact, for ``parse_variant`` and the tests.
TPU_RACE_VARIANTS = {
    "int4": raw_crc_int4,
    "planes4": raw_crc_planes4,
}


def parse_variant(name: str) -> tuple[str, int | None]:
    """Validate and split a variant name of the ``base`` or
    ``base@tile`` grammar that the race script and the bench share.
    Returns (base, tile-or-None); raises ValueError on an unknown base
    or a non-numeric tile, so that a typo fails loudly instead of
    running another kernel under the wrong label."""
    base, _, tile = name.partition("@")
    known = ({"xla", "pallas"} | set(VARIANTS)
             | set(TPU_RACE_VARIANTS))
    if base not in known:
        raise ValueError(f"unknown CRC variant {name!r}")
    if tile and not tile.isdigit():
        raise ValueError(f"non-numeric tile in variant {name!r}")
    if tile and not base.startswith("pallas_planes"):
        raise ValueError(f"only pallas_planes kernels take @tile: "
                         f"{name!r}")
    return base, int(tile) if tile else None


def pallas_planes_perturbed(name: str = "pallas_planes",
                            tile: int | None = None):
    """``(buf, i) -> raw CRCs of buf ^ uint8(i)`` with the perturbation
    applied inside the kernel, for a sustained loop whose iterations
    must differ: the outer ``buf ^ i`` form costs a full extra pass
    over the batch in device memory each iteration, the kernel's
    perturb byte costs nothing.  ``i == 0`` is the unperturbed pass."""
    transposed = name.endswith("_t")

    def fn(buf, i):
        return _pallas_planes(buf, tile or _planes_env_tile(), transposed,
                              perturb=int(i))

    return fn
