"""The dist phase of ``chip_smoke.py`` (``scripts/dist_bench.run``) at a
small size on the CPU: three ``dist_node`` processes
(``ETCD_TORCH_DEVICE=cpu``), the load, every acked write read back from
all three hosts, SIGKILL of slot 2, more writes, its restart under
``--storage-backend tpu`` (the stream lane, the kernel's plain version
here) and its catch-up; and the numbers the phase prints, the windowed
rates and SLO verdict off the nodes' rings among them.  The role phase's
small-size run is in ``tests/test_torch_roles.py``."""

from etcd_tpu_torch.scripts import dist_bench

_CPU = {"ETCD_TORCH_DEVICE": "cpu", "OMP_NUM_THREADS": "1"}


def test_dist_phase_at_small_size(tmp_path):
    r = dist_bench.run(groups=16, cap=64, total=400, extra=60, conns=4,
                       window=32, env_extra=_CPU, tmp=str(tmp_path))
    assert r["device"] == "cpu"
    assert r["windowed"]["estimator"] == "bucket-le-upper-bound"
    assert r["slo"]["verdict"] in ("ok", "burning", "no_data")
    load, down, rs = r["load"], r["load_one_down"], r["restart"]
    assert load["proposals"] == 400 and down["proposals"] == 60
    assert 0 < load["acked"] <= 400 and 0 < down["acked"] <= 60
    # every acked write (and the warm-up write) read back everywhere
    assert r["read_back"] == load["acked"] + down["acked"] + 1
    assert rs["lane"] == "stream" and rs["raw_crc_launches"] == 0
    assert rs["seconds"] > 0 and rs["wal_bytes"] > 0
    leader = r["hosts_stats"][0]
    assert leader["lanes_led"] == 16 and leader["leader_rounds"] > 0
    assert leader["ack_rtt_count"] > 0 and leader["applied_per_s"] > 0
    for h in r["hosts_stats"][1:]:
        assert h["frames_handled"] > 0 and h["ack_rtt_p50_ms"] is None
    for h in r["hosts_stats"] + [r["restarted_host_stats"]]:
        assert h["reads_per_round"] > 0
        assert set(h["reads_by_stage"]) <= {
            "dist.view", "dist.propose", "dist.build_append",
            "dist.absorb", "dist.handle_append", "dist.vote", "dist.tick",
            "dist.install", "dist.compact", "dist.server",
            "dist.fsync_overlap"}

