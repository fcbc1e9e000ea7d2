"""The port's snapshot hash and chunk verifier (etcd_tpu_torch.ops.
crc_kernel, etcd_tpu_torch.snap) on the CPU against the JAX package's
``device_crc32c`` and ``ChunkVerifier`` and the host CRC, exactly."""

import numpy as np
import pytest
import torch

from etcd_tpu.crc import crc32c as jcrc32c
from etcd_tpu.crc import gf2 as jgf2
from etcd_tpu.ops import crc_kernel as jcrc_kernel
from etcd_tpu.snap.stream import ChunkVerifier as JChunkVerifier
from etcd_tpu.snap.stream import chunk_crcs

from etcd_tpu_torch import native
from etcd_tpu_torch.ops import crc_cuda, crc_kernel
from etcd_tpu_torch.ops.crc_device import shift_crc_batch
from etcd_tpu_torch.ops.crc_kernel import auto_crc32c, device_crc32c
from etcd_tpu_torch.snap import ChunkVerifier


@pytest.fixture(autouse=True)
def _fresh_policy(monkeypatch):
    """auto_crc32c's race verdict is module state: every test starts
    uncalibrated."""
    monkeypatch.setattr(crc_kernel, "_device_wins", None)


def _data(n, seed=None):
    rng = np.random.default_rng(n if seed is None else seed)
    return rng.integers(0, 256, size=n).astype(np.uint8)


@pytest.mark.parametrize("n", [0, 1, 7, 4095, 4096, 4097, 3 * 4096 + 17,
                               70000])
def test_device_crc_parity(n):
    data = _data(n)
    want = jcrc32c.value(data)
    assert jcrc_kernel.device_crc32c(data, chunk=4096) == want
    assert device_crc32c(data, device="cpu") == want
    assert device_crc32c(data.tobytes(), device="cpu") == want
    assert native.crc32c_update(0, data) == want


@pytest.mark.parametrize("chunk", [64, 512, 1000])
def test_small_chunks_many_batches(monkeypatch, chunk):
    data = _data(50000, seed=1)
    monkeypatch.setattr(crc_kernel, "ROW_BATCH", 4)
    monkeypatch.setattr(jcrc_kernel, "ROW_BATCH", 4)
    want = jcrc32c.value(data)
    assert device_crc32c(data, chunk=chunk, device="cpu") == want
    assert jcrc_kernel.device_crc32c(data, chunk=chunk) == want


def test_chunks_reach_raw_crc_at_the_chunk_width(monkeypatch):
    widths = []
    real = crc_kernel.raw_crc_batch
    monkeypatch.setattr(crc_kernel, "raw_crc_batch",
                        lambda b: widths.append(tuple(b.shape)) or real(b))
    monkeypatch.setattr(crc_kernel, "ROW_BATCH", 3)
    device_crc32c(_data(10 * 4096 + 5), device="cpu")
    assert widths == [(1, 4096), (3, 4096), (3, 4096), (3, 4096),
                      (1, 4096)]
    assert crc_kernel.CHUNK == crc_cuda.MAX_LENGTH


def test_device_crc_needs_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_crc32c(_data(100))
    big = _data(crc_kernel.DEVICE_MIN_BYTES)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        auto_crc32c(big)
    assert crc_kernel.device_hash_wins() is None


def test_auto_small_blob_takes_the_host():
    small = b"abc" * 100
    assert auto_crc32c(small) == jcrc32c.value(small) == \
        jcrc_kernel.auto_crc32c(small)
    assert crc_kernel.device_hash_wins() is None


def test_auto_calibrates_once_and_stays_correct(monkeypatch):
    monkeypatch.setattr(crc_kernel, "DEVICE_MIN_BYTES", 1 << 14)
    monkeypatch.setattr(crc_kernel, "_CALIBRATE_BYTES", 1 << 14)
    blob = _data(1 << 15, seed=9)
    assert crc_kernel.device_hash_wins() is None
    assert auto_crc32c(blob, device="cpu") == jcrc32c.value(blob)
    decided = crc_kernel.device_hash_wins()
    assert decided in (True, False)

    def boom(*_):
        raise AssertionError("re-calibrated")

    monkeypatch.setattr(crc_kernel, "_calibrate", boom)
    assert auto_crc32c(blob, device="cpu") == jcrc32c.value(blob)
    assert crc_kernel.device_hash_wins() is decided


def test_race_times_the_native_host_crc(monkeypatch):
    """The race's host side is one native CRC call on the sample, and
    a device path that fails raises, in the race (no verdict: the next
    large blob races again) and in a hash after a device verdict."""
    monkeypatch.setattr(crc_kernel, "DEVICE_MIN_BYTES", 1 << 14)
    monkeypatch.setattr(crc_kernel, "_CALIBRATE_BYTES", 1 << 14)
    host_calls = []
    real = native.crc32c_update
    monkeypatch.setattr(native, "crc32c_update",
                        lambda c, d: host_calls.append(len(d)) or real(c, d))
    blob = _data(1 << 15, seed=4)
    assert auto_crc32c(blob, device="cpu") == jcrc32c.value(blob)
    assert host_calls[:crc_kernel._CALIBRATE_REPS] == \
        [1 << 14] * crc_kernel._CALIBRATE_REPS

    def faulty(*a, **k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(crc_kernel, "_device_wins", None)
    monkeypatch.setattr(crc_kernel, "device_crc32c", faulty)
    host_calls.clear()
    for _ in range(2):
        with pytest.raises(RuntimeError, match="device lost"):
            auto_crc32c(blob, device="cpu")
        assert crc_kernel.device_hash_wins() is None
    monkeypatch.setattr(crc_kernel, "_device_wins", True)
    with pytest.raises(RuntimeError, match="device lost"):
        auto_crc32c(blob, device="cpu")
    assert host_calls == []


@pytest.mark.parametrize("nbits", [33, 40, 63])
def test_suffix_shifts_past_4_gib(nbits):
    """``device_crc32c`` shifts each chunk by an int64 suffix length, so
    a blob of 4 GiB or more folds in one level: the shifts hold against
    the JAX package's ``gf2.shift`` at lengths with bits above 2^32."""
    rng = np.random.default_rng(nbits)
    states = rng.integers(0, 1 << 32, size=6, dtype=np.uint64)
    lens = rng.integers(1 << (nbits - 1), 1 << nbits, size=6,
                        dtype=np.uint64)
    lens[0] = 1 << 32
    lens[1] = 5 << 30
    got = shift_crc_batch(torch.from_numpy(states.astype(np.int64)),
                          torch.from_numpy(lens.astype(np.int64)),
                          nbits=nbits)
    want = [jgf2.shift(int(s), int(n)) for s, n in zip(states, lens)]
    assert got.tolist() == want


def _chunks(n=4000, cb=512, seed=7):
    p = _data(n, seed=seed).tobytes()
    crcs = chunk_crcs(p, cb)
    chunks = [p[o:o + cb] for o in range(0, len(p), cb)]
    prevs = [crcs[k - 1] if k else 0 for k in range(len(chunks))]
    return chunks, prevs, crcs


@pytest.mark.parametrize("route", ["host", "device"])
@pytest.mark.parametrize("n,cb", [(4000, 512), (20000, 4096),
                                  (20000, 5000), (9, 1)])
def test_chunk_verifier_matches_reference(route, n, cb):
    chunks, prevs, crcs = _chunks(n, cb)
    mine = ChunkVerifier(route=route, device="cpu")
    ref = JChunkVerifier(route=route)
    assert mine.verify(chunks, prevs, crcs) == [True] * len(chunks)
    bad = list(chunks)
    k = len(chunks) // 2
    bad[k] = bytes(bad[k][:-1]) + bytes([bad[k][-1] ^ 1])
    got = mine.verify(bad, prevs, crcs)
    assert got == ref.verify(bad, prevs, crcs)
    assert got == [i != k for i in range(len(chunks))]
    assert mine.verify([], [], []) == []


def test_chunk_verifier_routes_and_devices():
    with pytest.raises(ValueError):
        ChunkVerifier(route="quantum", device="cpu")
    assert ChunkVerifier(device="cpu").route == "device"
    assert ChunkVerifier(route="host").device is None
    if not torch.cuda.is_available():
        for route in (None, "device"):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                ChunkVerifier(route=route)
