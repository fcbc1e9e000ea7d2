"""Whole-blob CRC32C on the card (BASELINE config 3, the snapshot hash).

The port of ``etcd_tpu/ops/crc_kernel.py``.  The reference hashes
snapshot blobs with one sequential pass (snap/snapshotter.go:53,98).
Here the blob is split into fixed chunks and the sequential dependency
collapses via linearity over GF(2):

    raw(c_0 ++ ... ++ c_{K-1}) = XOR_k  Z^suffix_k @ raw(c_k)

where ``suffix_k`` is the byte count after chunk k.  Every chunk's raw
CRC state is one row of the raw-CRC kernel (``raw_crc_batch``, rows of
``CHUNK`` = 4096 bytes), the ``Z^suffix`` shifts run as batched masked
products (``shift_crc_batch``) and the XOR-reduce is a bit-parity sum,
all on ``default_device(device)``; only the final 32-bit fix-up happens
on the host.

:func:`auto_crc32c` races this against the host CRC once per process on
the first large blob and keeps the winner.  A device path that fails,
in the race or in a hash, raises: the host CRC is chosen only by
the blob's size or by the race's times.  The host side of that race
is ``native.crc32c_update`` (one SSE4.2 sweep where the CPU has it),
not the pure-Python ``crc/crc32c.py``: without ``google_crc32c`` that
would take seconds for the 8 MiB sample and decide nothing.
"""

from __future__ import annotations

import logging
import threading
import time
import warnings

import numpy as np
import torch

from .. import default_device, native
from ..crc import gf2
from .crc_device import _xor_rows, raw_crc_batch, shift_crc_batch

log = logging.getLogger(__name__)

_MASK32 = 0xFFFFFFFF

# Below this size the sequential host path wins (dispatch + transfer
# latency); above it the batched path amortizes.
DEVICE_MIN_BYTES = 4 << 20
# Chunk width: the raw-CRC kernel's widest row (its packed contribution
# matrix stays in shared memory).
CHUNK = 1 << 12
# Rows per kernel launch: bounds the H2D staging and the plain version's
# unpacked bits.
ROW_BATCH = 1 << 15


def _rows(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """``a`` on ``device``.  The rows are only read, so a read-only
    array (the view of a ``bytes`` blob) is taken without a copy and
    without torch's warning about writing to it."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "The given NumPy array is not "
                                "writable")
        return torch.from_numpy(a).to(device)


def _host_crc32c(data) -> int:
    """The host CRC: small blobs, and large ones when the race picks
    the host."""
    return native.crc32c_update(0, data)


def device_crc32c(data, chunk: int = CHUNK, device=None) -> int:
    """``crc32.Update(0, castagnoli, data)`` via batched chunks on
    ``default_device(device)`` (CUDA unless ``device="cpu"``; raises
    without CUDA).

    Bit-identical to the host path for any length, including zero and
    non-chunk-multiple tails.  The suffix shifts take int64 lengths
    (``shift_crc_batch`` walks their bits up to the highest set one), so
    blobs of 4 GiB and more need no second level.
    """
    dev = default_device(device)
    buf = np.frombuffer(memoryview(data), dtype=np.uint8) \
        if not isinstance(data, np.ndarray) else data.reshape(-1)
    n = int(buf.size)
    if n == 0:
        return 0
    k = -(-n // chunk)
    rem = n - (k - 1) * chunk
    # Chunk 0 is the (possibly short) head; right-alignment makes its
    # leading zero-padding free for a zero raw state.
    head = np.zeros((1, chunk), np.uint8)
    head[0, chunk - rem:] = buf[:rem]
    body = buf[rem:].reshape(k - 1, chunk)
    raws = torch.empty(k, dtype=torch.int64, device=dev)
    raws[:1] = raw_crc_batch(_rows(head, dev))
    for lo in range(0, k - 1, ROW_BATCH):
        part = _rows(body[lo:lo + ROW_BATCH], dev)
        raws[1 + lo:1 + lo + part.shape[0]] = raw_crc_batch(part)
    suffix = torch.arange(k - 1, -1, -1, dtype=torch.int64,
                          device=dev) * chunk
    shifted = shift_crc_batch(raws, suffix,
                              nbits=max(1, ((k - 1) * chunk).bit_length()))
    total = int(_xor_rows(shifted[None, :])[0])

    # Go convention: update(0, m) = Z^n @ ~0 ^ raw(m) ^ ~0
    inv = gf2.matvec(gf2.zero_operator(n), _MASK32)
    return (total ^ inv ^ _MASK32) & _MASK32


def warm_device(device=None) -> None:
    """The card's first use, made now: its context, the raw-CRC
    kernel's load and one hash of a one-chunk blob on
    ``default_device(device)``.  A server calls it at start, so that
    :func:`auto_crc32c`'s first race, run under its apply loop at the
    first large snapshot, pays none of that.  A device that fails
    raises."""
    device_crc32c(bytes(CHUNK), device=device)


# Measured backend policy: the device hash must never be the slowest
# available path.  Snapshot blobs are built host-side, so the device
# path pays a full H2D transfer; whether that amortizes depends on the
# link and the card, so both paths race once per process on the first
# large blob's head.
_CALIBRATE_BYTES = 8 << 20
_CALIBRATE_REPS = 3        # best-of-N: one stall must not pin policy
_device_wins: bool | None = None
_calibrate_lock = threading.Lock()


def device_hash_wins() -> bool | None:
    """The calibrated policy (None = no race has finished yet)."""
    return _device_wins


def _best_of(fn, sample, reps=_CALIBRATE_REPS) -> float:
    """Minimum wall time over reps runs: a transient stall inflates one
    run, not the minimum."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(sample)
        best = min(best, time.perf_counter() - t0)
    return best


def _calibrate(buf: np.ndarray, device) -> bool:
    """Race both paths on the blob's head: True when the device path
    is faster.  A device path that fails raises."""
    sample = np.ascontiguousarray(buf[:_CALIBRATE_BYTES])

    def on_device(s):
        return device_crc32c(s, device=device)

    on_device(sample)  # build/load/warm outside the timing
    t_dev = _best_of(on_device, sample)
    t_host = _best_of(_host_crc32c, sample)
    log.info("snapshot-hash calibration: device %.0f MB/s vs host %.0f "
             "MB/s -> %s", sample.size / t_dev / 1e6,
             sample.size / t_host / 1e6,
             "device" if t_dev < t_host else "host")
    return t_dev < t_host


def auto_crc32c(data, device=None) -> int:
    """Measured-policy CRC, the drop-in ``crc_fn`` for a snapshotter:
    host path for small blobs, and for large blobs whichever path a
    one-time race on this process's card and link won.

    The device is ``default_device(device)``: without CUDA a large blob
    raises unless the caller passes ``device="cpu"``.  A device path
    that fails, in the race or in the hash, raises; the race is run
    again on the next large blob when it did not finish.  Concurrent
    callers wait for the one race.
    """
    global _device_wins
    n = data.size if isinstance(data, np.ndarray) else len(data)
    if n < DEVICE_MIN_BYTES:
        return _host_crc32c(data)
    device = default_device(device)
    if _device_wins is None:
        with _calibrate_lock:
            if _device_wins is None:       # double-checked: one racer
                buf = np.frombuffer(memoryview(data), dtype=np.uint8) \
                    if not isinstance(data, np.ndarray) else data
                _device_wins = _calibrate(buf, device)
    if not _device_wins:
        return _host_crc32c(data)
    return device_crc32c(data, device=device)
