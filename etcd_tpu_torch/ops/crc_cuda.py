"""The raw-CRC kernel for NVIDIA Hopper, its build, binding and plain
torch version, and the nvcc build that every kernel of the port shares.

``raw_crc_cuda`` replaces the TPU kernel ``etcd_tpu/ops/crc_pallas.py:
_kernel`` (via ``raw_crc_pallas``): uint8 ``[N, L]`` right-aligned rows
in, their raw CRC32C states out.  The kernel is CUDA C++ in
``etcd_tpu_torch/csrc/raw_crc.cu`` (its header comment gives the design
and its bound on the card), compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C entry point, loaded with ``ctypes``.
Its ``rows`` argument (rows per block: 128, 256 or 512) is the tile
that ``scripts/pallas_sweep.py:make_pallas_concat`` swept on the TPU;
the main path runs 256.

``library_path``/``build``/``library`` serve every ``.cu`` file under
``csrc/``: each source is built at first use into
``etcd_tpu_torch/build/``, named by a hash of that source and the
flags, with nvcc's report kept beside it as ``.log``; a failed build
raises with nvcc's stderr.

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

#: rows per block that raw_crc.cu is instantiated for; 256 is the main
#: path's
ROWS_PER_BLOCK = (128, 256, 512)

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


def library_path(source: Path = SOURCE) -> Path:
    """Where the library built from ``source`` lives, keyed by the
    source's bytes and the flags."""
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}_{h.hexdigest()[:16]}.so"


def build(source: Path = SOURCE) -> Path:
    """Compile ``source`` unless the library for its bytes exists.

    nvcc's report (``-Xptxas -v``: registers, shared memory, spills) is
    kept beside the library with the suffix ``.log``.  Builds of two
    sources may run at once (each writes its own temporary file)."""
    so = library_path(source)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
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


# -- the kernel's tables -----------------------------------------------------


@functools.lru_cache(maxsize=16)
def nibble_tables(length: int) -> np.ndarray:
    """uint32 ``[2L * 16]``: entry ``(2i + h) * 16 + v`` is the raw-CRC
    contribution of value ``v`` in nibble ``h`` (0 low, 1 high) of byte
    ``i``, the XOR of the packed contribution-matrix rows of its set
    bits.  The kernel folds each byte as two lookups in this table."""
    c = contribution_matrix(length).astype(np.uint32)  # [8L, 32]
    words = (c << np.arange(32, dtype=np.uint32)).sum(axis=1,
                                                      dtype=np.uint32)
    w = words.reshape(2 * length, 4)  # nibble q holds bits 4q .. 4q+3
    v = np.arange(16)
    tab = np.zeros((2 * length, 16), np.uint32)
    for k in range(4):
        tab ^= np.where(((v >> k) & 1).astype(bool)[None, :],
                        w[:, k:k + 1], np.uint32(0))
    return tab.reshape(-1)


@functools.lru_cache(maxsize=32)
def _tables_on(length: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(nibble_tables(length).view(np.int32)).to(device)


# -- the wrapper and its plain version ---------------------------------------


def raw_crc_cuda(buf: torch.Tensor, rows: int = 256) -> torch.Tensor:
    """Raw CRC states of the right-aligned rows of ``buf``: int64 [N].

    ``buf`` must be a contiguous uint8 ``[N, L]`` CUDA tensor with
    ``L >= 1``; ``rows`` is the kernel's rows per block, one of
    :data:`ROWS_PER_BLOCK`.  Launches on the current stream and does
    not wait; adds one to ``raw_crc_cuda.launches`` and to
    ``raw_crc_cuda.launches_by[rows]`` for each launch."""
    if rows not in ROWS_PER_BLOCK:
        raise ValueError(f"raw_crc_cuda runs {ROWS_PER_BLOCK} rows per "
                         f"block, not {rows!r}")
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
    if length < 1:
        raise ValueError("raw_crc_cuda needs rows of at least one byte")
    out = torch.empty(n, dtype=torch.int64, device=buf.device)
    if n == 0:
        return out
    tab = _tables_on(length, buf.device)
    lib = _library()
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        err = lib.raw_crc_launch_rows(buf.data_ptr(), tab.data_ptr(),
                                      out.data_ptr(), n, length, rows,
                                      stream)
    if err != 0:
        raise RuntimeError(f"raw_crc kernel launch failed: cudaError {err}")
    raw_crc_cuda.launches += 1
    raw_crc_cuda.launches_by[rows] += 1
    return out


raw_crc_cuda.launches = 0
raw_crc_cuda.launches_by = dict.fromkeys(ROWS_PER_BLOCK, 0)


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
