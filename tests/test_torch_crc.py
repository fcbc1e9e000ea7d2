"""The port's CRC ops (etcd_tpu_torch, on the CPU) against the JAX
package's on the same numpy inputs: exact equality everywhere.

On the CPU the port runs the raw CRC's plain torch version; the CUDA
kernel is held against that version on the card by chip_smoke.py.  Here
the JAX side is both its XLA path and its Pallas kernel in interpret
mode.  The kernel's operand layout is checked in
tests/test_torch_crc_layouts.py.
"""

import numpy as np
import pytest
import torch

from etcd_tpu.crc import crc32c as jcrc32c
from etcd_tpu.crc import gf2 as jgf2
from etcd_tpu.ops import crc_device as jdev
from etcd_tpu.ops.crc_pallas import raw_crc_pallas

from etcd_tpu_torch.crc import crc32c as tcrc32c
from etcd_tpu_torch.crc import gf2 as tgf2
from etcd_tpu_torch.ops import crc_cuda
from etcd_tpu_torch.ops import crc_device as tdev
from etcd_tpu_torch.ops.crc_device import u32_numpy, u32_tensor


def _records(seed, n, length, max_len=None):
    """Right-aligned random records, with an empty and a full-width one."""
    rng = np.random.default_rng(seed)
    max_len = length if max_len is None else max_len
    lens = rng.integers(0, max_len + 1, size=n)
    lens[0] = max_len
    if n > 1:
        lens[1] = 0
    buf = np.zeros((n, length), dtype=np.uint8)
    msgs = []
    for i, l in enumerate(lens):
        m = rng.integers(0, 256, size=l, dtype=np.uint8).tobytes()
        msgs.append(m)
        buf[i, length - l:] = np.frombuffer(m, dtype=np.uint8)
    return buf, lens, msgs


def test_host_constants_byte_equal():
    assert np.array_equal(tcrc32c.TABLE, jcrc32c.TABLE)
    assert np.array_equal(tgf2.Z1, jgf2.Z1)
    assert all(np.array_equal(a, b)
               for a, b in zip(tgf2._POWERS, jgf2._POWERS))
    for length in (1, 8, 64, 384):
        a = tdev.contribution_matrix(length)
        b = jdev.contribution_matrix(length)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert tdev._zpow_stack(32).tobytes() == jdev._zpow_stack(32).tobytes()
    assert tdev._invert_table(300).tobytes() == \
        jdev._invert_table(300).tobytes()
    assert tdev._z4inv_tables().tobytes() == jdev._z4inv_tables().tobytes()
    z = tgf2.zero_operator(1234)
    assert np.array_equal(z, jgf2.zero_operator(1234))
    assert np.array_equal(tgf2.inverse(z), jgf2.inverse(z))


@pytest.mark.parametrize("length", [8, 64, 256])
@pytest.mark.parametrize("n", [1, 200, 513])
def test_raw_crc_batch_parity(length, n):
    buf, _, msgs = _records(length * 7 + n, n, length)
    got = u32_numpy(tdev.raw_crc_batch(torch.from_numpy(buf)))
    xla = np.asarray(jdev.raw_crc_batch(buf, use_pallas=False))
    c = np.asarray(jdev.contribution_matrix(length))
    pallas = np.asarray(raw_crc_pallas(buf, c, interpret=True))
    assert np.array_equal(got, xla)
    assert np.array_equal(got, pallas)
    host = np.array([tcrc32c.raw_update(0, m) for m in msgs], np.uint32)
    assert np.array_equal(got, host)


def test_raw_crc_routes_by_device():
    """A CPU tensor takes the plain version and launches nothing; the
    kernel's wrapper refuses anything but a CUDA tensor."""
    buf = torch.zeros((4, 16), dtype=torch.uint8)
    before = crc_cuda.raw_crc_cuda.launches
    assert torch.equal(tdev.raw_crc_batch(buf), torch.zeros(4, dtype=torch.int64))
    assert crc_cuda.raw_crc_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        crc_cuda.raw_crc_cuda(buf)


def test_crc32c_batch_parity():
    buf, lens, msgs = _records(7, 200, 256)
    got = u32_numpy(tdev.crc32c_batch(torch.from_numpy(buf),
                                      torch.from_numpy(lens)))
    assert np.array_equal(
        got, np.asarray(jdev.crc32c_batch(buf, lens, use_pallas=False)))
    assert np.array_equal(
        got, np.array([jcrc32c.value(m) for m in msgs], np.uint32))


@pytest.mark.parametrize("nbits", [32, 17])
def test_shift_crc_batch_parity(nbits):
    rng = np.random.default_rng(3)
    states = rng.integers(0, 1 << 32, size=64, dtype=np.uint64).astype(
        np.uint32)
    lens = rng.integers(0, 100_000, size=64)
    got = u32_numpy(tdev.shift_crc_batch(u32_tensor(states),
                                         torch.from_numpy(lens), nbits))
    assert np.array_equal(
        got, np.asarray(jdev.shift_crc_batch(states, lens, nbits=nbits)))
    host = np.array([jgf2.shift(int(s), int(l)) for s, l in zip(states, lens)],
                    np.uint32)
    assert np.array_equal(got, host)


def _chain(msgs, seed):
    stored = np.empty(len(msgs), np.uint32)
    prev = seed
    for i, m in enumerate(msgs):
        prev = jcrc32c.update(prev, m)
        stored[i] = prev
    return stored


def _verify_both(seed, stored, buf, lens, max_len=None):
    raw_j = np.asarray(jdev.raw_crc_batch(buf, use_pallas=False))
    want = np.asarray(jdev.chain_verify_device(seed, stored, raw_j, lens,
                                               max_len=max_len))
    raw_t = tdev.raw_crc_batch(torch.from_numpy(buf))
    got = tdev.chain_verify_device(seed, u32_tensor(stored), raw_t,
                                   torch.from_numpy(lens), max_len=max_len)
    got = got.numpy()
    assert np.array_equal(got, want)
    return got


@pytest.mark.parametrize("max_len", [None, 256])
def test_chain_verify_parity_and_corruption(max_len):
    buf, lens, msgs = _records(7, 200, 256)
    seed = 0xDEADBEEF
    stored = _chain(msgs, seed)
    assert _verify_both(seed, stored, buf, lens, max_len).all()
    # a flipped stored CRC fails that link and the next
    bad = stored.copy()
    bad[50] ^= 1
    ok = _verify_both(seed, bad, buf, lens, max_len)
    assert not ok[50] and not ok[51] and ok[:50].all() and ok[52:].all()
    # a corrupted data row fails only its own link
    buf2 = buf.copy()
    row = int(np.flatnonzero(lens > 0)[2])
    buf2[row, -1] ^= 0x80
    ok = _verify_both(seed, stored, buf2, lens, max_len)
    assert not ok[row] and ok[:row].all() and ok[row + 1:].all()


def test_chain_verify_empty():
    e = torch.zeros(0, dtype=torch.int64)
    ok = tdev.chain_verify_device(0, e, e, e)
    assert ok.shape == (0,) and ok.dtype == torch.bool


def test_inject_seeds_and_injected_links_parity():
    rng = np.random.default_rng(11)
    length = 128
    rows, lens, msgs = _records(11, 150, length, max_len=length - 4)
    prev = rng.integers(0, 2**32, size=len(msgs), dtype=np.uint32)
    expect = np.array([jcrc32c.update(int(p), m) for p, m in zip(prev, msgs)],
                      np.uint32)
    rows_t = tdev.inject_seeds(rows.copy(), lens, prev)
    rows_j = jdev.inject_seeds(rows.copy(), lens, prev)
    assert np.array_equal(rows_t, rows_j)
    raw = tdev.raw_crc_batch(torch.from_numpy(rows_t))
    ok = tdev.chain_links_injected(raw, u32_tensor(expect)).numpy()
    assert ok.all()
    bad = rows_t.copy()
    bad[2, -1] ^= 0x40
    raw_bad = tdev.raw_crc_batch(torch.from_numpy(bad))
    ok = tdev.chain_links_injected(raw_bad, u32_tensor(expect)).numpy()
    ok_j = np.asarray(jdev.chain_links_injected(
        np.asarray(jdev.raw_crc_batch(bad, use_pallas=False)), expect))
    assert np.array_equal(ok, ok_j)
    assert not ok[2] and ok[3:].all()
    with pytest.raises(ValueError):
        tdev.inject_seeds(np.zeros((1, 8), np.uint8), np.asarray([5]),
                          np.asarray([0], np.uint32))
