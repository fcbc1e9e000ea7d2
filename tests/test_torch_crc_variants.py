"""The port's raw-CRC variants (etcd_tpu_torch.ops.crc_variants, on the
CPU) against the JAX package's on the same numpy inputs: exact equality.

The reference's Pallas planes kernels run in interpret mode, as
tests/test_crc_variants.py runs them.  On the CPU the port's planes
kernel wrappers take their plain version; the CUDA kernel is held
against that version on the card by chip_smoke.py.  The reference's
int4 variants are compared through ``raw_crc_batch(use_pallas=False)``,
the function they compute (their s4 jit compiles for minutes on a CPU).
"""

import numpy as np
import pytest
import torch

from etcd_tpu.crc import crc32c as jcrc32c
from etcd_tpu.ops import crc_device as jdev
from etcd_tpu.ops import crc_variants as jv

from etcd_tpu_torch.ops import crc_cuda, planes_cuda
from etcd_tpu_torch.ops import crc_device as tdev
from etcd_tpu_torch.ops import crc_variants as tv
from etcd_tpu_torch.ops.crc_device import u32_numpy, u32_tensor

SHAPES = [(1, 4), (7, 36), (64, 132), (130, 384)]


def _rows(seed, n, length):
    """Right-aligned records of random lengths."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 256, size=(n, length), dtype=np.uint8)
    lens = rng.integers(0, length + 1, size=n)
    rows[np.arange(length)[None, :] < (length - lens)[:, None]] = 0
    return rows


def _host_raw(rows):
    return np.array([jcrc32c.raw_update(0, r.tobytes()) for r in rows],
                    np.uint32)


@pytest.mark.parametrize("length", [4, 36, 384])
def test_plane_matrices_byte_equal(length):
    a, b = tv.plane_matrices(length), jv.plane_matrices(length)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_variant_names_match_the_reference():
    assert sorted(tv.VARIANTS) == sorted(jv.VARIANTS)
    assert sorted(tv.TPU_RACE_VARIANTS) == sorted(jv.TPU_RACE_VARIANTS)
    assert tv.PLANES_TILE == jv.PLANES_TILE


@pytest.mark.parametrize("name", sorted(jv.VARIANTS))
@pytest.mark.parametrize("n,length", SHAPES)
def test_variant_matches_reference_and_host(name, n, length):
    rows = _rows(n * 1000 + length, n, length)
    got = u32_numpy(tv.VARIANTS[name](torch.from_numpy(rows)))
    np.testing.assert_array_equal(got, np.asarray(jv.VARIANTS[name](rows)))
    np.testing.assert_array_equal(got, _host_raw(rows))


@pytest.mark.parametrize("name", sorted(jv.TPU_RACE_VARIANTS))
@pytest.mark.parametrize("n,length", SHAPES)
def test_int4_variants_match_reference_function(name, n, length):
    rows = _rows(n * 7 + length, n, length)
    got = u32_numpy(tv.TPU_RACE_VARIANTS[name](torch.from_numpy(rows)))
    np.testing.assert_array_equal(
        got, np.asarray(jdev.raw_crc_batch(rows, use_pallas=False)))


@pytest.mark.parametrize("name", sorted(jv.VARIANTS))
def test_variant_composes_with_seed_injection(name):
    rng = np.random.default_rng(5)
    n, width = 33, 68
    lens = rng.integers(1, width - 4, size=n)
    rows = np.zeros((n, width), np.uint8)
    stored = np.empty(n, np.uint32)
    prev = np.empty(n, np.uint32)
    chain = 17
    for i in range(n):
        data = rng.integers(0, 256, size=lens[i], dtype=np.uint8)
        rows[i, width - lens[i]:] = data
        prev[i] = chain
        chain = jcrc32c.update(chain, data.tobytes())
        stored[i] = chain
    rows_t = tdev.inject_seeds(rows.copy(), lens, prev)
    rows_j = jdev.inject_seeds(rows.copy(), lens, prev)
    np.testing.assert_array_equal(rows_t, rows_j)
    ok = tdev.chain_links_injected(
        tv.VARIANTS[name](torch.from_numpy(rows_t)), u32_tensor(stored))
    ok_j = jdev.chain_links_injected(jv.VARIANTS[name](rows_j), stored)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_j))
    assert ok.numpy().all()


@pytest.mark.parametrize("name", ["pallas_planes", "pallas_planes_t"])
def test_perturbed_kernel_matches_reference(name):
    rows = np.random.default_rng(11).integers(0, 256, size=(70, 132),
                                              dtype=np.uint8)
    fn_t = tv.pallas_planes_perturbed(name)
    fn_j = jv.pallas_planes_perturbed(name)
    for i in (0, 3, 255):
        got = u32_numpy(fn_t(torch.from_numpy(rows), i))
        np.testing.assert_array_equal(got, np.asarray(fn_j(rows, i)),
                                      err_msg=f"i={i}")
        np.testing.assert_array_equal(
            got, np.asarray(jdev.raw_crc_batch(rows ^ np.uint8(i),
                                               use_pallas=False)))


@pytest.mark.parametrize("name", [
    "xla", "pallas", "planes", "pallas_planes@512", "pallas_planes_t@2048",
    "int4", "nope", "planes@512", "pallas_planes@x"])
def test_parse_variant_agrees(name):
    try:
        want = jv.parse_variant(name)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tv.parse_variant(name)
        assert str(got.value) == str(e)
    else:
        assert tv.parse_variant(name) == want


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("operand", sorted(planes_cuda.OPERANDS))
def test_planes_plain_at_every_tile(transposed, operand):
    """The function TPU kernels 2-4 compute at every tile, orientation
    and operand type: the raw CRC of ``rows ^ p``."""
    rows = np.random.default_rng(13).integers(0, 256, size=(130, 36),
                                              dtype=np.uint8)
    x = torch.from_numpy(rows)
    for p in (0, 3, 255):
        want = np.asarray(jdev.raw_crc_batch(rows ^ np.uint8(p),
                                             use_pallas=False))
        for tile in planes_cuda.TILES:
            got = planes_cuda.planes_crc_plain(x, tile, transposed, p,
                                               operand)
            np.testing.assert_array_equal(u32_numpy(got), want,
                                          err_msg=f"tile={tile} p={p}")


def test_pallas_planes_takes_the_env_tile(monkeypatch):
    rows = _rows(3, 65, 36)
    want = np.asarray(jv.raw_crc_pallas_planes(rows))
    monkeypatch.setenv("ETCD_CRC_TILE", "128")
    assert tv._planes_env_tile() == 128
    np.testing.assert_array_equal(
        u32_numpy(tv.raw_crc_pallas_planes(torch.from_numpy(rows))), want)
    monkeypatch.setenv("ETCD_CRC_TILE", "100")
    with pytest.raises(ValueError, match="multiple of 64"):
        tv.raw_crc_pallas_planes(torch.from_numpy(rows))


def test_planes_wrapper_routes_by_device():
    """A CPU tensor takes the plain version and launches nothing."""
    x = torch.from_numpy(_rows(4, 9, 36))
    before = planes_cuda.planes_crc_cuda.launches
    got = tv.raw_crc_pallas_planes(x)
    assert planes_cuda.planes_crc_cuda.launches == before
    assert torch.equal(got, tdev.raw_crc_batch(x))


@pytest.mark.parametrize("kind", ["cpu", "dtype", "shape", "tile",
                                  "operand"])
def test_planes_cuda_argument_checks(kind):
    x = torch.zeros((4, 16), dtype=torch.uint8)
    args = {"cpu": (x, 1024, "int8", "CUDA tensor"),
            "dtype": (x.to(torch.int32), 1024, "int8", "uint8"),
            "shape": (x.reshape(-1), 1024, "int8", r"\[N, L\]"),
            "tile": (x, 100, "int8", "multiple of 64"),
            "operand": (x, 1024, "fp8", "operand")}[kind]
    buf, tile, operand, match = args
    with pytest.raises(ValueError, match=match):
        planes_cuda.planes_crc_cuda(buf, tile, operand=operand)
    if kind != "cpu":
        with pytest.raises(ValueError, match=match):
            planes_cuda.planes_crc_plain(buf, tile, operand=operand)
    for big in (0, 2112, 4096):
        with pytest.raises(ValueError, match="multiple of 64"):
            planes_cuda.planes_crc_cuda(x, big)


@pytest.mark.parametrize("kind", ["cpu", "dtype", "rows"])
def test_raw_crc_cuda_argument_checks(kind):
    x = torch.zeros((4, 16), dtype=torch.uint8)
    buf, rows, match = {"cpu": (x, 32, "CUDA tensor"),
                        "dtype": (x.to(torch.int16), 32, "uint8"),
                        "rows": (x, 1024, "rows per tile")}[kind]
    with pytest.raises(ValueError, match=match):
        crc_cuda.raw_crc_cuda(buf, rows)
    for bad in (128, 48, 0):
        with pytest.raises(ValueError, match="rows per tile"):
            crc_cuda.raw_crc_cuda(x, bad)
