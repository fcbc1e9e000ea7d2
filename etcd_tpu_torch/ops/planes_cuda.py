"""The packed-planes raw-CRC kernel for NVIDIA Hopper's tensor cores,
its binding and its plain torch version.

``planes_crc_cuda(buf, tile, transposed, perturb, operand)`` replaces
three TPU kernels that compute one function, the raw CRC32C state of
each right-aligned row of ``buf ^ perturb``:

- ``etcd_tpu/ops/crc_variants.py:_pallas_planes_kernel`` (8
  accumulating int8 products, one per bit plane, with an in-kernel
  perturb byte);
- ``crc_variants.py:_pallas_planes_t_kernel`` (the same in the
  ``[32, T]`` orientation): here ``transposed=True``;
- ``scripts/pallas_sweep.py:make_pallas_planes.kernel`` (a swept tile
  and an int8 or bf16 operand type): here ``tile`` and ``operand``.

The kernel is CUDA C++ in ``etcd_tpu_torch/csrc/planes_crc.cu`` (its
header gives the design and its bound on the card), built by the same
nvcc path as the raw-CRC kernel (``crc_cuda.build``).  Its design: the
bit planes are made in registers from the rows' words (never staged),
the plane matrices (:func:`plane_columns`, each ``C_k^T`` with K
contiguous) sit in shared memory, resident where they fit and streamed
in K-chunks otherwise; ``transposed=False`` multiplies with ``wgmma``
(the planes as A from registers), ``transposed=True`` with ``mma.sync``
(``C_k^T`` as A through ``ldmatrix``, the planes as B).  Its shared
memory does not grow with the tile (the tile is rows per block, walked
in passes of up to 512), so unlike the TPU kernel it never shrinks a
tile to fit; it takes multiples of 64 up to 2048 (:data:`TILES`) and
the wrapper raises on any other.

``planes_crc_plain`` is the same function in plain torch: unpack plane
by plane (``((x ^ p) >> k) & 1``), 8 float32 products, parity, pack,
in row chunks (``plane_parity``).  Sums are counts of at most
``8L <= 32,768`` ones, so float32 is exact whatever the kernel's
operand type, and the ``& 127`` operands of ``crc_variants.
raw_crc_planes`` sum to at most ``8 * L * 127 < 2**24`` at
``L = 4096``.  The products run in float32 because a bf16 product in
torch rounds its output to bf16.  The tests and ``chip_smoke.py`` use
``planes_crc_plain``; nothing on the card's path does.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .crc_bits import _from_bits32, contribution_matrix
from .crc_cuda import CSRC, library

SOURCE = CSRC / "planes_crc.cu"

#: rows per block the kernel takes: multiples of 64 up to 2048
TILES = tuple(range(64, 2049, 64))

#: operand types of the kernel's products, and their torch types
OPERANDS = {"int8": torch.int8, "bf16": torch.bfloat16}

# Bytes of float32 plane operands the plain version holds at a time.
_PLAIN_CHUNK_BYTES = 256 << 20


@functools.lru_cache(maxsize=16)
def plane_matrices(length: int) -> np.ndarray:
    """``[8, L, 32]`` int8: plane k's contribution matrix C_k (the
    bit-k rows of the contribution matrix)."""
    c = contribution_matrix(length)              # [8L, 32], row 8i+k
    return np.ascontiguousarray(
        c.reshape(length, 8, 32).transpose(1, 0, 2))


#: the kernel's K-chunk: C_k^T is padded to a multiple of it
CHUNK = 64


@functools.lru_cache(maxsize=16)
def plane_columns(length: int) -> np.ndarray:
    """int8 ``[8, 32, Lc]``, ``Lc`` = ``length`` rounded up to
    :data:`CHUNK`: each plane's ``C_k^T`` with K contiguous, zeros past
    ``length``.  The kernel's host operand, for both operand types: it
    copies it into shared memory as 16-byte cores of one column (and
    widens them to bf16 there)."""
    lc = -(-length // CHUNK) * CHUNK
    out = np.zeros((8, 32, lc), np.int8)
    out[:, :, :length] = plane_matrices(length).transpose(0, 2, 1)
    return out


@functools.lru_cache(maxsize=16)
def _columns_on(length: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(plane_columns(length)).to(device)


@functools.lru_cache(maxsize=32)
def _planes_f32(length: int, device: torch.device) -> torch.Tensor:
    """:func:`plane_matrices` as float32, uploaded once per (length,
    device): the plain version's operand."""
    return torch.from_numpy(plane_matrices(length)).to(device=device,
                                                       dtype=torch.float32)


def check_args(buf: torch.Tensor, tile: int, operand: str) -> None:
    """Raise ValueError on what neither the kernel nor its plain
    version takes: rows that are not uint8 ``[N, L]``, a tile not in
    :data:`TILES`, an operand type not in :data:`OPERANDS`."""
    if buf.dtype != torch.uint8:
        raise ValueError(f"planes_crc needs uint8 rows, got {buf.dtype}")
    if buf.dim() != 2:
        raise ValueError(f"planes_crc needs [N, L] rows, got shape "
                         f"{tuple(buf.shape)}")
    if tile not in TILES:
        raise ValueError(f"planes_crc takes a tile that is a multiple of "
                         f"64 up to 2048, not {tile!r}")
    if operand not in OPERANDS:
        raise ValueError(f"planes_crc operand must be one of "
                         f"{sorted(OPERANDS)}, not {operand!r}")


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry ``planes_crc_launch`` of a library built from
    :data:`SOURCE` (this one, or a diagnostic build of it)."""
    lib.planes_crc_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.planes_crc_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    return bind(library(SOURCE))


def planes_crc_cuda(buf: torch.Tensor, tile: int = 1024,
                    transposed: bool = False, perturb: int = 0,
                    operand: str = "int8") -> torch.Tensor:
    """Raw CRC states of the right-aligned rows of ``buf ^ perturb``
    (the low byte of ``perturb`` XORed into every byte): int64 [N].

    ``buf`` must be a contiguous uint8 ``[N, L]`` CUDA tensor with
    ``L >= 1``.  Launches on the current stream and does not wait; adds
    one to ``planes_crc_cuda.launches`` and to
    ``planes_crc_cuda.launches_by[(transposed, operand)]`` for each
    launch."""
    check_args(buf, tile, operand)
    if buf.device.type != "cuda":
        raise ValueError(f"planes_crc_cuda needs a CUDA tensor, got "
                         f"{buf.device}")
    if not buf.is_contiguous():
        raise ValueError("planes_crc_cuda needs contiguous rows")
    n, length = buf.shape
    if length < 1:
        raise ValueError("planes_crc_cuda needs rows of at least one byte")
    out = torch.empty(n, dtype=torch.int64, device=buf.device)
    if n == 0:
        return out
    ck = _columns_on(length, buf.device)
    lib = _library()
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        err = lib.planes_crc_launch(
            buf.data_ptr(), ck.data_ptr(), out.data_ptr(), n, length, tile,
            int(bool(transposed)), 0 if operand == "int8" else 1,
            int(perturb) & 0xFF, stream)
    if err != 0:
        raise RuntimeError(f"planes_crc kernel launch failed: cudaError "
                           f"{err}")
    planes_crc_cuda.launches += 1
    planes_crc_cuda.launches_by[(bool(transposed), operand)] += 1
    return out


planes_crc_cuda.launches = 0
planes_crc_cuda.launches_by = {(t, o): 0 for t in (False, True)
                               for o in OPERANDS}


def plane_parity(buf: torch.Tensor, mask: int = 1,
                 transposed: bool = False,
                 perturb: int = 0) -> torch.Tensor:
    """``parity(sum_k (((buf ^ perturb) >> k) & mask) @ C_k)``, packed:
    int64 [N].  With ``mask`` 1 the operands are the bit planes; any
    mask of low bits gives the same parity, since bits above bit 0 of
    an operand add even multiples.  Float32 products (exact: see the
    module docstring), ``C_k^T @ p^T`` when ``transposed``, in row
    chunks."""
    n, length = buf.shape
    ck = _planes_f32(length, buf.device)
    step = max(1, _PLAIN_CHUNK_BYTES // (4 * length))
    out = torch.empty(n, dtype=torch.int64, device=buf.device)
    for r0 in range(0, n, step):
        x = buf[r0:r0 + step].to(torch.int32) ^ (int(perturb) & 0xFF)
        acc = None
        for k in range(8):
            p = ((x >> k) & mask).to(torch.float32)
            r = (ck[k].T @ p.T).T if transposed else p @ ck[k]
            acc = r if acc is None else acc + r
        out[r0:r0 + step] = _from_bits32(torch.remainder(acc, 2))
    return out


def planes_crc_plain(buf: torch.Tensor, tile: int = 1024,
                     transposed: bool = False, perturb: int = 0,
                     operand: str = "int8") -> torch.Tensor:
    """The plain torch version of :func:`planes_crc_cuda`: int64 [N].

    Takes the same arguments and refuses the same ones.  ``tile`` and
    ``operand`` do not change the function; ``transposed`` runs the
    products as ``C_k^T @ p^T``, the kernel's other orientation."""
    check_args(buf, tile, operand)
    return plane_parity(buf, 1, transposed, perturb)
