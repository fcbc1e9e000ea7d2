"""The raw-CRC kernel for NVIDIA Hopper, its build, binding and plain
torch version, and the nvcc build that every kernel of the port shares.

``raw_crc_cuda`` replaces the TPU kernel ``etcd_tpu/ops/crc_pallas.py:
_kernel`` (via ``raw_crc_pallas``): uint8 ``[N, L]`` right-aligned rows
in, their raw CRC32C states out.  The kernel is CUDA C++ in
``etcd_tpu_torch/csrc/raw_crc.cu``, compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C entry point, loaded with
``ctypes``.  Its design (the header comment gives it in full, with its
bound on the card): the GF(2) contraction on the 1-bit tensor cores
(``mma.sync`` m16n8k256 ``and.popc``), the rows' bytes as they lie in
memory as the A operand, the contribution matrix packed to bits
(:func:`bit_columns`) resident in shared memory as B, and each warp's
tiles of rows brought in by ``cp.async.bulk`` through a ring of
stages.  Its ``rows`` argument (rows per warp tile: 16, 32 or 64) is
the tile that ``scripts/pallas_sweep.py:make_pallas_concat`` swept on
the TPU; the main path runs :data:`DEFAULT_ROWS`.

``library_path``/``build``/``library`` serve every ``.cu`` file under
``csrc/``: each source is built at first use into
``etcd_tpu_torch/build/``, named by a hash of that source, the shared
headers (``csrc/*.cuh``) and the flags, with nvcc's report kept beside
it as ``.log``; a failed build raises with nvcc's stderr.

``raw_crc_plain`` is the same function in plain torch ops (unpack the
bits, multiply by the contribution matrix, take parity, pack), in row
chunks so that it fits on the card at full size.  ``raw_crc_batch``
takes it only for a tensor on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from .crc_bits import (
    _contribution_f32,
    _from_bits32,
    _unpack_bits,
    contribution_matrix,
)

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCE = CSRC / "raw_crc.cu"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: rows per warp tile that raw_crc.cu is instantiated for; the main
#: path runs DEFAULT_ROWS
ROWS_PER_TILE = (16, 32, 64)
DEFAULT_ROWS = 32

#: bytes of a row each step of the kernel contracts
CHUNK = 128
#: the widest row the kernel takes: its packed B operand (32 x L bytes)
#: stays in shared memory
MAX_LENGTH = 4096

# Bytes of float32 bits the plain version unpacks at a time.
_PLAIN_CHUNK_BYTES = 256 << 20


# -- build and bind (every kernel of the port) -------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def _flags(defines: tuple[str, ...]) -> list[str]:
    return [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]


def library_path(source: Path = SOURCE,
                 defines: tuple[str, ...] = ()) -> Path:
    """Where the library built from ``source`` lives, keyed by the
    source's bytes, the headers under ``csrc/`` it may include, the
    flags and the ``defines``."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(_flags(defines)).encode())
    return BUILD_DIR / f"{source.stem}_{h.hexdigest()[:16]}.so"


def build(source: Path = SOURCE, defines: tuple[str, ...] = ()) -> Path:
    """Compile ``source`` unless the library for its bytes exists.

    ``defines`` (``NAME=VALUE``) go to nvcc as ``-D`` flags: the
    diagnostic builds of ``scripts/kernel_probe.py``; the port's own
    libraries have none.  nvcc's report (``-Xptxas -v``: registers,
    shared memory, spills) is kept beside the library with the suffix
    ``.log``.  Builds of two sources may run at once (each writes its
    own temporary file)."""
    so = library_path(source, defines)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(defines), "-o", str(tmp), str(source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"nvcc not found ({cmd[0]}): {source.name} "
                           f"cannot be built") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {source.name}:\n"
            f"{proc.stderr}")
    so.with_suffix(".log").write_text(proc.stderr)
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def library(source: Path = SOURCE) -> ctypes.CDLL:
    """The library built from ``source``, loaded once per process."""
    return ctypes.CDLL(str(build(source)))


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = library(SOURCE)
    lib.raw_crc_launch_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.raw_crc_launch_rows.restype = ctypes.c_int
    return lib


# -- the kernel's B operand ------------------------------------------------


def padded_width(length: int) -> int:
    """``length`` rounded up to the kernel's 128-byte chunk."""
    return -(-length // CHUNK) * CHUNK


@functools.lru_cache(maxsize=16)
def bit_columns(length: int) -> np.ndarray:
    """uint8 ``[32, Lp]`` (``Lp = padded_width(length)``): the
    contribution matrix transposed and packed to bits, the kernel's B
    operand.  Byte ``i`` of column ``j`` holds ``C[8i + k, j]`` at bit
    ``k``, so it lines up bit for bit with byte ``i`` of a row; bytes
    past ``length`` are 0."""
    c = contribution_matrix(length).reshape(length, 8, 32)
    weights = (1 << np.arange(8, dtype=np.uint16))[None, :, None]
    packed = (c.astype(np.uint16) * weights).sum(axis=1).astype(np.uint8)
    out = np.zeros((32, padded_width(length)), np.uint8)
    out[:, :length] = packed.T
    return out


@functools.lru_cache(maxsize=32)
def _columns_on(length: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(bit_columns(length)).to(device)


# -- the wrapper and its plain version ---------------------------------------


def raw_crc_cuda(buf: torch.Tensor, rows: int = DEFAULT_ROWS) -> torch.Tensor:
    """Raw CRC states of the right-aligned rows of ``buf``: int64 [N].

    ``buf`` must be a contiguous uint8 ``[N, L]`` CUDA tensor with
    ``1 <= L <= MAX_LENGTH``; ``rows`` is the kernel's rows per warp
    tile, one of :data:`ROWS_PER_TILE`.  Launches on the current stream
    and does not wait; adds one to ``raw_crc_cuda.launches`` and to
    ``raw_crc_cuda.launches_by[rows]`` for each launch, and keeps the
    largest ``(N, L)`` launched in ``raw_crc_cuda.largest``."""
    if rows not in ROWS_PER_TILE:
        raise ValueError(f"raw_crc_cuda runs {ROWS_PER_TILE} rows per "
                         f"tile, not {rows!r}")
    if buf.dtype != torch.uint8:
        raise ValueError(f"raw_crc_cuda needs uint8 rows, got {buf.dtype}")
    if buf.dim() != 2:
        raise ValueError(f"raw_crc_cuda needs [N, L] rows, got shape "
                         f"{tuple(buf.shape)}")
    if buf.device.type != "cuda":
        raise ValueError(f"raw_crc_cuda needs a CUDA tensor, got "
                         f"{buf.device}")
    if not buf.is_contiguous():
        raise ValueError("raw_crc_cuda needs contiguous rows")
    n, length = buf.shape
    if not 1 <= length <= MAX_LENGTH:
        raise ValueError(f"raw_crc_cuda takes rows of 1 to {MAX_LENGTH} "
                         f"bytes, not {length}")
    out = torch.empty(n, dtype=torch.int64, device=buf.device)
    if n == 0:
        return out
    cols = _columns_on(length, buf.device)
    lib = _library()
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        err = lib.raw_crc_launch_rows(buf.data_ptr(), cols.data_ptr(),
                                      out.data_ptr(), n, length, rows,
                                      stream)
    if err != 0:
        raise RuntimeError(f"raw_crc kernel launch failed: cudaError {err}")
    raw_crc_cuda.launches += 1
    raw_crc_cuda.launches_by[rows] += 1
    if n * length > raw_crc_cuda.largest[0] * raw_crc_cuda.largest[1]:
        raw_crc_cuda.largest = (n, length)
    return out


raw_crc_cuda.launches = 0
raw_crc_cuda.launches_by = dict.fromkeys(ROWS_PER_TILE, 0)
raw_crc_cuda.largest = (0, 0)


def raw_crc_plain(buf: torch.Tensor) -> torch.Tensor:
    """The plain torch version of :func:`raw_crc_cuda`: int64 [N].

    Unpack each row's bits, multiply by the contribution matrix in
    float32 (exact: sums of at most 8L <= 32768 ones), take parity,
    pack.  Works in row chunks so the unpacked bits stay near 256 MB."""
    n, length = buf.shape
    c = _contribution_f32(length, buf.device)
    step = max(1, _PLAIN_CHUNK_BYTES // (32 * length))
    out = torch.empty(n, dtype=torch.int64, device=buf.device)
    for r0 in range(0, n, step):
        bits = _unpack_bits(buf[r0:r0 + step]).to(torch.float32)
        out[r0:r0 + step] = _from_bits32(torch.remainder(bits @ c, 2))
    return out
