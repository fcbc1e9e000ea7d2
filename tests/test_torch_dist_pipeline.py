"""The port's append pipeline (``server/distpipe.py``) and linearizable
read bookkeeping (``server/readindex.py``) against the JAX package's.

Each scenario of tests/test_dist_pipeline.py's pipeline units and of
tests/test_readindex.py's bookkeeping units runs on both packages with
the reference's assertions, and returns a trace of every value it
observed; the two packages' traces must be equal.  Tolerance: exact.
"""

import importlib

import numpy as np
import pytest


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


# -- distpipe ---------------------------------------------------------------


def sc_window_and_ack_matching(pkg):
    dp = mod(pkg, "server.distpipe")
    pipe = dp.AppendPipeline(m=3, slot=0, depth=2)
    tr = [pipe.can_send(1)]
    m1 = pipe.register(1, t0=0.0, nbytes=10, has_ents=True, stripe=0)
    m2 = pipe.register(1, t0=0.1, nbytes=10, has_ents=True, stripe=0)
    tr += [m1.seq, m2.seq, pipe.can_send(1), pipe.can_send(2)]
    assert not tr[3] and tr[4]
    disp, meta = pipe.ack(1, m2.seq, pipe.epoch)
    assert disp == "ok" and meta is m2
    tr += [disp, pipe.can_send(1)]
    disp, meta = pipe.ack(1, m2.seq, pipe.epoch)
    assert disp == "stale_seq" and meta is None
    tr.append(disp)
    disp, meta = pipe.ack(1, m1.seq, pipe.epoch - 1)
    assert disp == "stale_epoch" and meta is None
    tr.append(disp)
    disp, _ = pipe.ack(1, m1.seq, pipe.epoch)
    assert disp == "ok"
    return tr + [disp]


def sc_probe_and_epoch(pkg):
    dp = mod(pkg, "server.distpipe")
    pipe = dp.AppendPipeline(m=2, slot=0, depth=4)
    m1 = pipe.register(1, t0=0.0, nbytes=1, has_ents=True, stripe=0)
    pipe.register(1, t0=0.0, nbytes=1, has_ents=True, stripe=0)
    popped = pipe.fail(1, [m1.seq])
    assert [m.seq for m in popped] == [m1.seq]
    assert pipe.mode(1) == dp.PROBE
    tr = [pipe.mode(1), pipe.can_send(1)]
    epoch0 = pipe.epoch
    dropped = pipe.bump_epoch()
    assert dropped == 1 and pipe.epoch != epoch0
    assert pipe.inflight(1) == 0 and pipe.can_send(1)
    m3 = pipe.register(1, t0=0.0, nbytes=1, has_ents=True, stripe=0)
    assert not pipe.can_send(1)
    assert pipe.ack(1, m3.seq, pipe.epoch)[0] == "ok"
    pipe.note_ok(1)
    assert pipe.mode(1) == dp.REPLICATE
    return tr + [dropped, m3.seq, pipe.mode(1)]


def sc_expire_backstop(pkg):
    dp = mod(pkg, "server.distpipe")
    pipe = dp.AppendPipeline(m=2, slot=0, depth=4)
    pipe.register(1, t0=0.0, nbytes=1, has_ents=True, stripe=0)
    pipe.register(1, t0=5.0, nbytes=1, has_ents=True, stripe=0)
    out = pipe.expire(now=6.0, max_age=2.0)
    assert [m.t0 for m in out[1]] == [0.0]
    assert pipe.mode(1) == dp.PROBE and pipe.inflight(1) == 1
    return [[m.seq for m in out[1]], pipe.mode(1), pipe.inflight(1)]


def sc_snapshot_mode_single_frame_and_sticky(pkg):
    dp = mod(pkg, "server.distpipe")
    pipe = dp.AppendPipeline(m=3, slot=0, depth=8)
    pipe.note_snapshot(1)
    assert pipe.mode(1) == dp.SNAPSHOT and pipe.can_send(1)
    m1 = pipe.register(1, t0=0.0, nbytes=0, has_ents=False, stripe=0)
    assert not pipe.can_send(1)
    disp, _ = pipe.ack(1, m1.seq, pipe.epoch)
    assert disp == "ok"
    pipe.note_ok(1)
    tr = [pipe.mode(1)]
    pipe.note_reject(1)
    tr.append(pipe.mode(1))
    m2 = pipe.register(1, t0=0.0, nbytes=0, has_ents=False, stripe=0)
    pipe.fail(1, [m2.seq])
    tr.append(pipe.mode(1))
    pipe.register(1, t0=0.0, nbytes=0, has_ents=False, stripe=0)
    exp = pipe.expire(100.0, 1.0)
    tr += [sorted(exp), pipe.mode(1)]
    assert tr[:3] == [dp.SNAPSHOT] * 3 and tr[4] == dp.SNAPSHOT
    pipe.note_caught_up(1)
    assert pipe.mode(1) == dp.PROBE
    pipe.note_ok(1)
    assert pipe.mode(1) == dp.REPLICATE and pipe.mode(2) == dp.REPLICATE
    return tr + [pipe.mode(1), pipe.mode(2)]


def sc_snapshot_mode_epoch_bump_resets(pkg):
    dp = mod(pkg, "server.distpipe")
    pipe = dp.AppendPipeline(m=2, slot=0, depth=4)
    pipe.note_snapshot(1)
    pipe.register(1, t0=0.0, nbytes=0, has_ents=False, stripe=0)
    dropped = pipe.bump_epoch()
    assert dropped == 1 and pipe.mode(1) == dp.PROBE
    return [dropped, pipe.mode(1)]


# -- readindex --------------------------------------------------------------


def sc_lease_drift_margin(pkg):
    ri = mod(pkg, "server.readindex")
    out = [ri.lease_drift_ticks(t) for t in (10, 60, 5, 3, 1000)]
    assert out[:3] == [1, 6, 1]
    return out


def _release_inputs(g, **over):
    kw = dict(
        lead=np.ones(g, bool), read_ok=np.ones(g, bool),
        applied=np.full(g, 10), floor=np.zeros(g, np.int64),
        basis=np.full(g, 5.0), lease_until=np.full(g, -np.inf),
        now=100.0)
    kw.update(over)
    return kw


def sc_readqueue_releases_on_basis(pkg):
    ri, wt = mod(pkg, "server.readindex"), mod(pkg, "utils.wait")
    q = ri.ReadQueue(4)
    c1, c2 = wt.Chan(), wt.Chan()
    q.register(1, t0=3.0, required=7, ch=c1)
    q.register(1, t0=6.0, required=8, ch=c2)
    rel = q.release(**_release_inputs(4))
    assert [(r[0].ch, r[1]) for r in rel] == [(c1, "read_index")]
    assert rel[0][2] == 7 and q.pending == 1
    rel2 = q.release(**_release_inputs(4, basis=np.full(4, 6.5)))
    assert [r[0].ch for r in rel2] == [c2] and q.pending == 0
    return [[r[1:] for r in rel], [r[1:] for r in rel2], q.pending]


def sc_readqueue_lease_and_floor(pkg):
    ri, wt = mod(pkg, "server.readindex"), mod(pkg, "utils.wait")
    q = ri.ReadQueue(2)
    q.register(0, t0=50.0, required=3, ch=wt.Chan())
    rel = q.release(**_release_inputs(
        2, basis=np.full(2, 0.0), lease_until=np.full(2, 200.0),
        floor=np.full(2, 9, np.int64)))
    assert [(r[1], r[2]) for r in rel] == [("lease", 9)]
    return [r[1:] for r in rel]


def sc_readqueue_gates(pkg):
    ri, wt = mod(pkg, "server.readindex"), mod(pkg, "utils.wait")
    q = ri.ReadQueue(2)
    q.register(0, t0=1.0, required=0, ch=wt.Chan())
    base = _release_inputs(2)
    for bad in (dict(lead=np.zeros(2, bool)),
                dict(read_ok=np.zeros(2, bool)),
                dict(applied=np.zeros(2), floor=np.full(2, 5, np.int64))):
        assert q.release(**{**base, **bad}) == []
    rel = q.release(**base)
    assert rel != []
    return [r[1:] for r in rel]


def sc_readqueue_fail_lanes_and_expire(pkg):
    ri, wt = mod(pkg, "server.readindex"), mod(pkg, "utils.wait")
    q = ri.ReadQueue(4)
    a, b, c = wt.Chan(), wt.Chan(), wt.Chan()
    q.register(0, t0=1.0, required=0, ch=a)
    q.register(2, t0=2.0, required=0, ch=b)
    q.register(2, t0=90.0, required=0, ch=c)
    lanes = np.zeros(4, bool)
    lanes[0] = True
    failed = q.fail_lanes(lanes)
    assert [p.ch for p in failed] == [a]
    expired = q.expire(now=100.0, max_age=50.0)
    assert [p.ch for p in expired] == [b] and q.pending == 1
    return [len(failed), len(expired), q.pending]


def sc_waitpoints_release_in_order(pkg):
    ri, wt = mod(pkg, "server.readindex"), mod(pkg, "utils.wait")
    w = ri.WaitPoints(2)
    chans = [wt.Chan() for _ in range(3)]
    w.register(0, 5, chans[0])
    w.register(0, 3, chans[1])
    w.register(1, 4, chans[2])
    out = w.release(np.array([4, 2]))
    assert out == [chans[1]]
    out2 = w.release(np.array([5, 4]))
    assert set(map(id, out2)) == {id(chans[0]), id(chans[2])}
    assert w.pending == 0
    return [[chans.index(c) for c in out], sorted(chans.index(c)
                                                  for c in out2)]


def sc_waitpoints_expire(pkg):
    ri, wt = mod(pkg, "server.readindex"), mod(pkg, "utils.wait")
    w = ri.WaitPoints(2)
    old, fresh = wt.Chan(), wt.Chan()
    w.register(0, 50, old, t0=1.0)
    w.register(0, 40, fresh, t0=90.0)
    assert w.expire(now=100.0, max_age=50.0) == [old]
    assert w.pending == 1
    assert w.release(np.array([45, 0])) == [fresh]
    return [w.pending]


def sc_leaseclock_deposing_ack(pkg):
    ri = mod(pkg, "server.readindex")
    lc = ri.LeaseClock(2, 3, 0)
    members = np.ones((2, 3), bool)
    nm = np.full(2, 3)
    lc.note_ack(1, 8.0, np.array([True, False]))
    lc.note_ack(2, 4.0, np.array([True, True]))
    b = lc.basis(members, nm, now=10.0)
    assert list(b) == [8.0, 4.0]
    lc.note_ack(1, 2.0, np.array([True, True]))
    b2 = lc.basis(members, nm, now=10.0)
    assert list(b2) == [8.0, 4.0]
    return [list(b), list(b2)]


def sc_deposed_need_snap_ack_shape(pkg):
    dmm, msg = mod(pkg, "raft.distmember"), mod(pkg, "wire.distmsg")
    kw = {"device": "cpu"} if pkg == "etcd_tpu_torch" else {}
    m = dmm.DistMember(2, 2, 1, 8, **kw)
    m.handle_vote(msg.VoteReq(
        sender=0, term=np.full(2, 5, np.int32),
        last=np.zeros(2, np.int32), lterm=np.zeros(2, np.int32),
        active=np.ones(2, bool)))
    resp = m.handle_append(msg.AppendBatch(
        sender=0, term=np.ones(2, np.int32),
        prev_idx=np.zeros(2, np.int32), prev_term=np.zeros(2, np.int32),
        n_ents=np.zeros(2, np.int32), commit=np.zeros(2, np.int32),
        active=np.ones(2, bool), need_snap=np.array([True, False]),
        ent_terms=np.zeros((2, m.e), np.int32), payloads=[[], []]))
    assert bool(resp.active[0]) and not bool(resp.ok[0])
    assert not bool((np.asarray(resp.active) & np.asarray(resp.ok)).any())
    assert int(np.asarray(resp.term)[0]) == 5
    return [bytes(resp.marshal())]


def sc_stats_reads_by_path(pkg):
    st = mod(pkg, "store.stats")
    s = st.Stats()
    s.inc_read_path("lease")
    s.inc_read_path("lease", 3)
    s.inc_read_path("follower_wait")
    d = s.to_dict()
    assert d["readsByPath"]["lease"] == 4
    return [d["readsByPath"]]


SCENARIOS = [v for k, v in sorted(globals().items())
             if k.startswith("sc_")]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__[3:] for s in SCENARIOS])
def test_same_trace_in_both_packages(scenario):
    want = scenario("etcd_tpu")
    got = scenario("etcd_tpu_torch")
    assert got == want


def test_lease_band_enforced_at_construction(tmp_path):
    from etcd_tpu_torch.scripts.dist_bench import free_ports
    from etcd_tpu_torch.server.distserver import DistServer

    urls = [f"http://127.0.0.1:{p}" for p in free_ports(3)]
    with pytest.raises(ValueError, match="lease"):
        DistServer(str(tmp_path / "d"), slot=0, peer_urls=urls,
                   g=4, election=10, lease_ticks=9, device="cpu")


def test_dist_server_without_cuda_raises(tmp_path, monkeypatch):
    """No device named and no CUDA: construction raises naming CUDA,
    before any disk mutation."""
    import torch

    from etcd_tpu_torch.server.distserver import DistServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DistServer(str(tmp_path / "d"), slot=0,
                   peer_urls=["http://127.0.0.1:1", "http://127.0.0.1:2"],
                   g=4)
    assert not (tmp_path / "d").exists()


def test_dist_server_mesh_not_ported_yet(tmp_path):
    """``mesh=`` is ported now: a group count that does not split over
    the mesh's g-axis raises the reference's ValueError before any disk
    mutation."""
    from etcd_tpu_torch.parallel import group_mesh, local_devices
    from etcd_tpu_torch.server.distserver import DistServer

    with pytest.raises(ValueError, match="not divisible by mesh g-axis"):
        DistServer(str(tmp_path / "d"), slot=0,
                   peer_urls=["http://127.0.0.1:1", "http://127.0.0.1:2"],
                   g=6, mesh=group_mesh(8, devices=local_devices("cpu")),
                   device="cpu")
    assert not (tmp_path / "d").exists()
