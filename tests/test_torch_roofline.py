"""The port's roofline accounting against the JAX package's, and the
port's variant race, tile sweep and host WAL builder run on the CPU at
a small size.
"""

import json

import numpy as np
import pytest
import torch

from etcd_tpu.crc import crc32c as jcrc32c
from etcd_tpu.obs import roofline as jroof
from etcd_tpu.ops import crc_device as jdev

from etcd_tpu_torch.obs import roofline as troof
from etcd_tpu_torch.scripts import crc_variants_bench, kernel_sweep, walgen


@pytest.mark.parametrize("eps,width,ceilings", [
    (1.5e9, 384, {}),
    (3.1e7, 384, {"measured_tflops_bf16": 336.0}),
    (2.0e8, 68, {"measured_tflops_bf16": 700.0,
                 "measured_tops_int8": 1200.0}),
    # an impossible fraction: tagged ceiling_suspect with provenance
    (1.68e9, 384, {"measured_tflops_bf16": 336.0,
                   "measured_tops_int8": 101.0,
                   "provenance": {"probe": "x"}}),
    (1.68e9, 384, {"measured_tops_int8": 101.0}),
])
def test_mfu_fields_match_reference(eps, width, ceilings):
    got = troof.mfu_fields(eps, width, **ceilings)
    assert got == jroof.mfu_fields(eps, width, **ceilings)


def test_mfu_fields_ceiling_suspect_row():
    row = troof.mfu_fields(1.68e9, 384, measured_tops_int8=101.0)
    assert row["ceiling_suspect"] is True
    assert row["ceiling_provenance"] == "unspecified"


def test_flop_helpers_and_ceilings_match_reference():
    assert troof.FLOPS_PER_ROW_BYTE == jroof.FLOPS_PER_ROW_BYTE
    assert troof.HONEST_PAYLOAD_BYTES == jroof.HONEST_PAYLOAD_BYTES
    for w in (68, 256, 384):
        assert troof.flops_per_entry(w) == jroof.flops_per_entry(w)
    assert troof.flops_per_entry_honest() == jroof.flops_per_entry_honest()
    assert troof.SPEC_CEILINGS["v5e"] == jroof.SPEC_CEILINGS["v5e"]
    assert troof.SPEC_CEILINGS["h100_sxm"] == {
        "bf16_tflops": 989.0, "int8_tops": 1979.0, "hbm_tbps": 3.35}


def test_crc_bound_at_the_main_path_shape():
    b = troof.crc_bound(1 << 20, 384)
    assert b["bytes"] == 406_859_776
    assert b["ops"] == 2 * (1 << 20) * 8 * 384 * 32
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(406_859_776 / 3.35e12 * 1e3)
    bf16 = troof.crc_bound(1 << 20, 384, "bf16")
    assert bf16["bound_by"] == "operations"
    assert bf16["bound_ms"] == pytest.approx(b["ops"] / 989e12 * 1e3)


def test_probe_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA device"):
        troof.probe_matmul_ceiling("bf16", device="cpu")


def test_walgen_matches_reference():
    buf, lens, stored = walgen.make_wal(200, 68, 34, 63, 0, seed=3,
                                        n_check=200)
    np.testing.assert_array_equal(
        walgen.raw_crcs(buf),
        np.asarray(jdev.raw_crc_batch(buf, use_pallas=False)))
    prev = 0
    for i in range(len(lens)):
        prev = jcrc32c.update(prev, buf[i, 68 - lens[i]:].tobytes())
        assert int(stored[i]) == prev
    # the race's generator draws what the reference race draws
    rng = np.random.default_rng(3)
    want_lens = rng.integers(34, 64, size=200)
    np.testing.assert_array_equal(lens, want_lens)
    rows = walgen.injected(buf, lens, stored, 0)
    prev_j = np.concatenate([[0], stored[:-1]]).astype(np.uint32)
    np.testing.assert_array_equal(
        rows, jdev.inject_seeds(buf.copy(), lens, prev_j))


def test_race_runs_on_the_cpu(capsys):
    rows, stored = crc_variants_bench.make_data(256, 68)
    results = crc_variants_bench.main(rows, stored, 2, "cpu")
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    names = ["xla"] + sorted(crc_variants_bench.VARIANTS)
    assert [x["variant"] for x in lines[:-1]] == names
    assert sorted(results) == sorted(names)
    for name, row in results.items():
        assert "error" not in row, (name, row)
        assert row["entries_per_sec"] > 0 and row["bound_ms"] is None
    assert lines[-1]["best"] in names


def test_race_gate_reports_a_wrong_chain(capsys):
    rows, stored = crc_variants_bench.make_data(64, 68)
    stored = stored.copy()
    stored[5] ^= 1
    results = crc_variants_bench.main(rows, stored, 2, "cpu")
    assert all(r == {"error": "gate 63/64"} for r in results.values())
    capsys.readouterr()
    with pytest.raises(ValueError, match="iters >= 2"):
        crc_variants_bench.main(rows, stored, 1, "cpu")


def test_sweep_plain_rows_on_the_cpu(capsys):
    rows = kernel_sweep.main(2, 8, "cpu")
    assert [r["sweep"] for r in rows] == ["xla_int8", "xla_bf16"]
    assert all(r["bit_exact"] and r["gbps"] > 0 for r in rows)
    lines = capsys.readouterr().out.splitlines()
    assert [json.loads(x)["sweep"] for x in lines] == [
        "start", "xla_int8", "xla_bf16"]


def test_card_race_and_sweep_name_every_kernel():
    cuda = torch.device("cuda")
    names = crc_variants_bench.variant_names(cuda)
    assert names[:2] == ["xla", "pallas"]
    assert {crc_variants_bench.make_fn(n, cuda)[1] for n in names} == {
        "plain", "cuda:raw_crc", "cuda:planes_crc"}
    sweep = [name for name, _, _ in kernel_sweep.sweep_rows(cuda)]
    assert "pallas_current" in sweep and "pallas_bf16_t t1024" in sweep
