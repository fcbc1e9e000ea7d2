"""The co-hosted phases ``chip_smoke.py`` drives on the card
(``etcd_tpu_torch.scripts.cohosted_bench``), on the CPU at a small size:
the engine's call sequence and its checks (the engine itself is held
against the JAX package's in tests/test_torch_multiraft.py); the
serving phase's writes (with snapshots cutting the WAL under the load),
reads, CAS, DELETE and watch; and the restart
dir under the three backends, which must agree and read every window
key back; and the profiler-session probe.  Tolerance: exact."""

import os

import numpy as np
import pytest

from etcd_tpu_torch.scripts import cohosted_bench as cb, profiler_sessions


def test_engine_sequence_commits_every_round():
    got = cb.engine(g=64, m=5, cap=64, device="cpu")
    assert got["p50_ms"] > 0 and got["round_ms"] > 0
    assert got["profile"] is None
    # campaign + warm-up + 8 timed + 22 in the train + 4 profiled
    np.testing.assert_array_equal(got["commit"], 1 + 1 + 8 + 22 + 4)
    assert (got["leader"] == 0).all()


def test_engine_states_compare_field_by_field():
    a = cb.engine(g=16, device="cpu")
    b = cb.engine(g=16, device="cpu")
    assert cb.same_states(a, b) == []
    b["states"][2]["commit"] = b["states"][2]["commit"] + 1
    assert cb.same_states(a, b) == ["2.commit"]


def test_serving_phase_on_the_cpu(tmp_path):
    """A ``snap_count`` under the load's entries, so snapshots cut the
    WAL during the load, as the default does at 10,000 groups."""
    out = cb.serving(g=32, m=5, cap=128, puts=96, threads=4, profiled=16,
                     snap_count=40, device="cpu",
                     data_dir=str(tmp_path / "d"))
    assert out["acked_writes_per_s"] > 0
    assert out["max_ms"] >= out["p99_ms"] >= out["p50_ms"] > 0
    assert out["snapshots"] >= 1 and out["snapshot_s"] > 0
    assert out["rounds"] > 0 and out["crc_bytes"] > 0
    assert out["syncs_per_round"] >= 1
    assert out["wal_crc_s"] > 0 and out["persist_s"] > 0
    assert out["other_s"] < out["load_s"]
    assert out["profile"] is None


@pytest.fixture(scope="module")
def restart_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("restart") / "data")
    made = cb.write_restart_dir(d, g=32, k_per=6, window=64,
                                snap_keys=200, value_len=24)
    return d, made


def test_restart_dir_layout(restart_dir):
    d, made = restart_dir
    assert made["records"] == 32 * 6 + 2
    assert len(made["window_keys"]) == 64
    assert os.listdir(os.path.join(d, "snap"))


def test_restart_backends_agree(restart_dir):
    d, made = restart_dir
    outs = {b: cb.restart(d, b, g=32, m=5, device="cpu",
                          records=made["records"])
            for b in ("host", "tpu", "auto")}
    assert outs["host"]["lane"] == "host"
    assert outs["tpu"]["lane"] == "stream"
    assert outs["auto"]["lane"] == "host"   # under the device threshold
    for b in ("tpu", "auto"):
        assert outs[b]["raft_index"] == outs["host"]["raft_index"]
        np.testing.assert_array_equal(outs[b]["frontier"],
                                      outs["host"]["frontier"])
        assert outs[b]["store"] == outs["host"]["store"]
    store = outs["tpu"]["server"].store
    for k in made["window_keys"] + made["snap_key_sample"]:
        assert store.get(k, False, False).node.value
    assert outs["host"]["raft_index"] == 32 * 6


def test_snapshot_load_phase(restart_dir):
    d, made = restart_dir
    out = cb.snapshot_load(d, device="cpu")
    assert out["bytes"] > 200 * 24
    assert out["launches"] == 0  # the CPU never reaches the kernel


def test_profiler_sessions_probe_on_the_cpu():
    """The probe behind chip_smoke.py's TEARDOWN_CUPTI: sessions opened
    while a server thread serves writers; the CPU records no kernel."""
    out = profiler_sessions.main(sessions=2, g=8, m=3, cap=64,
                                 window_s=0.05, writers=2, device="cpu")
    assert out["sessions"] == 2
    assert out["without_kernels"] == 2 and out["kernels"] == [0, 0]
