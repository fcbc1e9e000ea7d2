"""``etcd_tpu_torch.scripts.classic_bench`` (the classic server's phase
of ``chip_smoke.py``) on the CPU at a small size: the restart dir
restarts equal under ``host``, ``tpu`` and ``auto`` (``device="cpu"``)
and in the JAX package, every key reads back, ``tpu`` takes the stream
lane and a flipped record raises under it; and the three-member CLI
cluster (``ETCD_TORCH_DEVICE=cpu``) passes every gate of the phase:
its load past a snapshot, every acked key read back from every member,
the 429 shed on the hot tenant, /metrics, the front door's stats,
/v2/machines, a watch, both proxies, and a follower's restart under
``tpu``.  Tolerance: exact."""

import os
import shutil

import pytest

from etcd_tpu.server import server as jserver
from etcd_tpu.server.cluster import Cluster as JCluster
from etcd_tpu.server.config import ServerConfig as JConfig
from etcd_tpu_torch.scripts import classic_bench as cb
from etcd_tpu_torch.scripts import cohosted_bench


@pytest.fixture(scope="module")
def restart_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("classic") / "data"
    made = cb.write_restart_dir(str(d), keys=400, dirs=8, tail=120)
    return str(d), made


def test_restart_dir_restarts_equal_under_every_backend(restart_dir):
    src, made = restart_dir
    assert made["last_index"] == 520 and made["records"] == 121
    outs = {b: cb.restart(src, b, device="cpu")
            for b in ("host", "tpu", "auto")}
    assert outs["tpu"]["lane"] == "stream"
    assert outs["host"]["lane"] == "host"
    for b in ("tpu", "auto"):
        for k in ("hard_state", "last", "store", "applied"):
            assert outs[b][k] == outs["host"][k], (b, k)
    assert outs["host"]["last"] == (520, 1)
    assert outs["host"]["applied"] == 120
    store = outs["tpu"]["server"].store
    for k in made["keys"]:
        assert store.get(k, False, False).node.value
    # the JAX package reads the same dir to the same state
    c = JCluster()
    c.set_from_string(f"{cb.NAME}={cb.PEER_URL}")
    shutil.copytree(src, os.path.dirname(src) + "/jax")
    js = jserver.new_server(JConfig(name=cb.NAME, cluster=c,
                                    data_dir=os.path.dirname(src) + "/jax",
                                    storage_backend="host"))
    rd = js.node.ready(timeout=0)
    with js.store.fanout_round():
        for e in rd.committed_entries:
            js.apply_request(jserver.Request.unmarshal(e.data))
    assert js.store.save() == outs["host"]["store"]
    assert js.node.r.hard_state().marshal() == outs["host"]["hard_state"]
    js.stop()
    js.storage.wal.close()


def test_replay_and_snapshot_load_alone(restart_dir):
    src, made = restart_dir
    r = cb.replay_alone(src, "tpu", 400, device="cpu")
    assert r["entries"] == 121
    s = cohosted_bench.snapshot_load(src, device="cpu", backend="tpu")
    assert s["bytes"] > 400 * cb.VALUE_LEN
    h = cohosted_bench.snapshot_load(src, device="cpu", backend="host")
    assert h["bytes"] == s["bytes"]


def test_flipped_record_raises_under_tpu(restart_dir, tmp_path):
    src, _ = restart_dir
    bad = tmp_path / "bad"
    shutil.copytree(src, bad)
    cb.flip_in_record(str(bad / "wal"))
    with pytest.raises(Exception) as e:
        cb.restart(str(bad), "tpu", device="cpu")
    assert "TornTail" not in type(e.value).__name__


def test_cluster_passes_every_gate_on_the_cpu(tmp_path):
    out = cb.cluster(puts=300, conns=4, namespaces=8, burst=150, extra=60,
                     snapshot_count=100, device="cpu",
                     tmp=str(tmp_path))
    assert out["read_back"] == 300
    assert out["leader_snapshots"] >= 1
    assert out["admission"]["shed"] > 0
    assert out["admission"]["shed_write_total"] > 0
    assert out["read_back_after_restart"] > 300
    assert "stream-route replay" in out["restart_replay"]
    # every number chip_smoke.py prints from the run
    for part in ("load", "load_one_down"):
        for k in ("acked", "seconds", "acked_writes_per_s", "p50_ms",
                  "p99_ms", "max_ms", "retries"):
            assert out[part][k] is not None, (part, k)
    assert out["load_one_down"]["acked"] == 60
    assert len(out["listen_s"]) == 3 and min(out["listen_s"]) > 0
    assert 0 < out["restart_listen_s"] < out["restart_catch_up_s"]
    assert "server.persist" in out["leader_spans"]
