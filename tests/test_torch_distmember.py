"""The port's DistMember (etcd_tpu_torch, on the CPU) against the JAX
package's, call for call.

Every scenario of tests/test_distmember.py runs on clusters of
:class:`PairMember`: each slot is one JAX engine and one port engine at
the same seed.  Every call goes to both; after EVERY call the two hold
equal every GroupState field (values and dtypes), ``payloads``,
``errors`` and the returned values, and every frame a call returns
marshals to the same bytes in both packages.  Each side then parses its
own package's bytes and carries on, so the exchange crosses the wire
exactly as between two hosts.  Tolerance: exact (integer state, bytes).
A seeded lossy random walk mixes every operation, and the frame
exchange is held equal to the port's own fused ``MultiRaft``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from etcd_tpu.raft.distmember import DistMember as JDistMember
from etcd_tpu.wire import distmsg as jdm

from etcd_tpu_torch.raft.batched import term_at as t_term_at
from etcd_tpu_torch.raft.distmember import DistMember as TDistMember
from etcd_tpu_torch.raft.multiraft import MultiRaft as TMultiRaft
from etcd_tpu_torch.wire import distmsg as tdm

G, M, CAP = 8, 3, 64


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


class Dual:
    """One value per package; attribute reads stay paired."""

    def __init__(self, j, t):
        self.j, self.t = j, t

    def __getattr__(self, name):
        return Dual(getattr(self.j, name), getattr(self.t, name))


def _side(x, k):
    if isinstance(x, Dual):
        return getattr(x, k)
    if isinstance(x, list):
        return [_side(v, k) for v in x]
    if isinstance(x, tuple):
        return tuple(_side(v, k) for v in x)
    return x


def same(rj, rt, what: str) -> None:
    """Equal results: frames byte for byte, arrays by value and dtype."""
    if rj is None:
        assert rt is None, what
    elif hasattr(rj, "marshal"):
        assert type(rj).__name__ == type(rt).__name__, what
        assert bytes(rt.marshal()) == bytes(rj.marshal()), what
    elif isinstance(rj, tuple):
        assert isinstance(rt, tuple) and len(rt) == len(rj), what
        for a, b in zip(rj, rt):
            same(a, b, what)
    else:
        a, b = np.asarray(rj), _np(rt)
        np.testing.assert_array_equal(b, a, err_msg=what)
        assert b.dtype == a.dtype, (what, a.dtype, b.dtype)


class PairMember:
    """Member ``slot`` on both engines, driven in lockstep."""

    def __init__(self, g, m, slot, cap, **kw):
        self.j = JDistMember(g, m, slot, cap, **kw)
        self.t = TDistMember(g, m, slot, cap, **kw, device="cpu")
        self.g, self.slot = g, slot
        self.calls = 0
        self.check()

    def __getattr__(self, name):
        fj, ft = getattr(self.j, name), getattr(self.t, name)
        if not callable(fj):
            same(fj, ft, name)
            return fj

        def both(*args, **kw):
            rj = fj(*_side(args, "j"), **_side(kw, "j"))
            rt = ft(*_side(args, "t"), **_side(kw, "t"))
            self.calls += 1
            same(rj, rt, name)
            self.check(name)
            if hasattr(rj, "marshal") or isinstance(rj, tuple):
                return Dual(rj, rt)
            return rj
        return both

    def field(self, name: str) -> np.ndarray:
        return np.asarray(getattr(self.j.state, name))

    def mutate(self, **fields) -> None:
        """Overwrite state fields on both engines."""
        self.j.state = self.j.state._replace(
            **{k: jnp.asarray(v) for k, v in fields.items()})
        self.t.state = self.t.state._replace(
            **{k: torch.as_tensor(np.asarray(v)) for k, v in
               fields.items()})
        self.check("mutate")

    def check(self, after: str = "init") -> None:
        j, t = self.j, self.t
        for f in j.state._fields:
            a = np.asarray(getattr(j.state, f))
            b = _np(getattr(t.state, f))
            np.testing.assert_array_equal(
                b, a, err_msg=f"after {after}: slot {self.slot} {f}")
            assert b.dtype == a.dtype, (after, f, a.dtype, b.dtype)
        assert t.payloads == j.payloads, after
        for k in ("overflow", "conflict"):
            np.testing.assert_array_equal(t.errors[k], j.errors[k],
                                          err_msg=f"{after}: {k}")
            assert t.errors[k].dtype == j.errors[k].dtype, (after, k)


def wire(frame: Dual) -> Dual:
    """Ship a paired frame: equal bytes, each side parses its own."""
    bj, bt = bytes(frame.j.marshal()), bytes(frame.t.marshal())
    assert bj == bt
    return Dual(jdm.unmarshal_any(bj), tdm.unmarshal_any(bt))


def make_cluster(g=G, m=M, cap=CAP, **kw):
    return [PairMember(g, m, s, cap, **kw) for s in range(m)]


def elect(ms, slot=0, mask=None):
    """One full campaign round-trip for member ``slot``."""
    mask = np.ones(ms[slot].g, bool) if mask is None else mask
    req = wire(ms[slot].begin_campaign(mask))
    votes = [wire(ms[peer].handle_vote(req))
             for peer in range(len(ms)) if peer != slot]
    return ms[slot].tally(req.active, votes)


def replicate(ms, lead=0, drop=()):
    """One append round-trip from ``lead`` to every peer; ``drop`` is
    a set of peer slots whose frames vanish (either direction)."""
    for peer in range(len(ms)):
        if peer == lead or peer in drop:
            continue
        b = ms[lead].build_append(peer)
        if b is None:
            continue
        resp = ms[peer].handle_append(wire(b))
        ms[lead].handle_append_resp(wire(resp))


def test_frame_roundtrip():
    def frames(dm):
        return [
            dm.AppendBatch(
                sender=1, term=np.arange(4, dtype=np.int32),
                prev_idx=np.arange(4, dtype=np.int32),
                prev_term=np.zeros(4, np.int32),
                n_ents=np.asarray([2, 0, 1, 0], np.int32),
                commit=np.zeros(4, np.int32),
                active=np.asarray([1, 1, 0, 0], bool),
                need_snap=np.zeros(4, bool),
                ent_terms=np.ones((4, 2), np.int32),
                payloads=[[b"aa", b"b"], [], [b"ccc"], []]),
            dm.AppendResp(sender=2, term=np.ones(4, np.int32),
                          ok=np.asarray([1, 0, 1, 0], bool),
                          acked=np.arange(4, dtype=np.int32),
                          hint=np.zeros(4, np.int32),
                          active=np.ones(4, bool)),
            dm.VoteReq(sender=0, term=np.ones(4, np.int32),
                       last=np.zeros(4, np.int32),
                       lterm=np.zeros(4, np.int32),
                       active=np.ones(4, bool)),
            dm.VoteResp(sender=1, term=np.ones(4, np.int32),
                        granted=np.ones(4, bool),
                        active=np.ones(4, bool)),
        ]

    for fj, ft in zip(frames(jdm), frames(tdm)):
        raw = bytes(fj.marshal())
        assert bytes(ft.marshal()) == raw
        got_j, got_t = jdm.unmarshal_any(raw), tdm.unmarshal_any(raw)
        assert type(got_t).__name__ == type(got_j).__name__ \
            == type(fj).__name__
        assert bytes(got_t.marshal()) == bytes(got_j.marshal()) == raw
    got = tdm.unmarshal_any(bytes(frames(jdm)[0].marshal()))
    assert got.payloads[0] == [b"aa", b"b"]
    assert got.payloads[2] == [b"ccc"]


def test_election_and_commit():
    ms = make_cluster()
    won = elect(ms, 0)
    assert won.all()
    assert ms[0].is_leader().all()
    ms[0].propose(np.ones(G, np.int32), data=[[b""] for _ in range(G)])
    valid, base = ms[0].propose(
        np.ones(G, np.int32), data=[[b"x"] for _ in range(G)]).j
    assert valid.all() and (base == 1).all()
    replicate(ms, 0)
    assert (ms[0].commit_index() == 2).all()
    replicate(ms, 0)
    assert (ms[1].commit_index() == 2).all()
    assert ms[1].committed_payload(0, 2) == b"x"


def test_split_vote_lockstep_breaks_via_timeout_redraw():
    """Two survivors whose lanes drew EQUAL election timeouts fire in
    lockstep; begin_campaign's re-draw must break the split."""
    g, m, cap = 8, 3, 16
    a = PairMember(g, m, 1, cap, election=5, seed=11)
    b = PairMember(g, m, 2, cap, election=5, seed=22)
    same7 = np.full(g, 7, np.int32)
    a.mutate(timeout=same7)
    b.mutate(timeout=same7)

    def campaign_pair(fired_a, fired_b):
        reqs = {}
        if fired_a.any():
            reqs["a"] = wire(a.begin_campaign(fired_a))
        if fired_b.any():
            reqs["b"] = wire(b.begin_campaign(fired_b))
        votes_a = [wire(b.handle_vote(reqs["a"]))] if "a" in reqs else []
        votes_b = [wire(a.handle_vote(reqs["b"]))] if "b" in reqs else []
        if "a" in reqs:
            a.tally(reqs["a"].active, votes_a)
        if "b" in reqs:
            b.tally(reqs["b"].active, votes_b)

    led_at = np.full(g, -1)
    for t in range(200):
        fa, fb = a.tick(), b.tick()
        if fa.any() or fb.any():
            campaign_pair(fa, fb)
        led = a.is_leader() | b.is_leader()
        led_at[(led_at < 0) & led] = t
        if led.all():
            break
    assert (led_at >= 0).all()
    assert led_at.max() <= 50, led_at


def test_reject_repair_jumps_forward_past_compacted_probe():
    """Response loss leaves the leader's next_[f] below the follower's
    commit+1 while the follower lane-compacted to its commit: the
    repair must SET next_ = hint+1, jumping forward."""
    ms = make_cluster()
    elect(ms, 0)
    ms[0].propose(np.ones(G, np.int32), data=[[b""] for _ in range(G)])
    for i in range(6):
        ms[0].propose(np.ones(G, np.int32),
                      data=[[bytes([i])] for _ in range(G)])
        replicate(ms, 0)
    replicate(ms, 0)
    lead, fol = ms[0], ms[1]
    assert (fol.commit_index() >= 6).all()
    fol.mark_applied(fol.commit_index())
    fol.compact()
    assert (fol.field("offset") == fol.field("commit")).all()
    next_ = lead.field("next_").copy()
    next_[:, 1] = fol.field("commit")
    lead.mutate(next_=next_)
    lead.propose(np.ones(G, np.int32), data=[[b"new"] for _ in range(G)])
    before = fol.commit_index().copy()
    for _ in range(4):
        replicate(ms, 0, drop={2})
    assert (fol.commit_index() > before).all()
    assert fol.committed_payload(0, int(fol.commit_index()[0])) \
        in (b"new", b"")


def test_quorum_commits_with_one_peer_down():
    ms = make_cluster()
    elect(ms, 0)
    ms[0].propose(np.ones(G, np.int32), data=[[b""] for _ in range(G)])
    replicate(ms, 0)
    before = ms[0].commit_index().copy()
    ms[0].propose(np.ones(G, np.int32), data=[[b"y"] for _ in range(G)])
    replicate(ms, 0, drop={2})
    assert (ms[0].commit_index() == before + 1).all()


def test_reject_repairs_next_from_hint():
    ms = make_cluster()
    elect(ms, 0)
    ms[0].propose(np.ones(G, np.int32), data=[[b""] for _ in range(G)])
    for i in range(3):
        ms[0].propose(np.ones(G, np.int32),
                      data=[[bytes([i])] for _ in range(G)])
        replicate(ms, 0, drop={2})
    replicate(ms, 0)
    replicate(ms, 0)
    assert (ms[2].commit_index() >= 3).all()


def test_higher_term_deposes_leader():
    ms = make_cluster()
    elect(ms, 0)
    ms[0].propose(np.ones(G, np.int32), data=[[b""] for _ in range(G)])
    replicate(ms, 0)
    assert elect(ms, 1).all()
    b = ms[0].build_append(1)
    if b is not None:
        resp = ms[1].handle_append(wire(b))
        ms[0].handle_append_resp(wire(resp))
    assert not ms[0].is_leader().any()


def test_vote_durability_shape():
    ms = make_cluster()
    t0 = ms[0].terms().copy()
    req = ms[0].begin_campaign(np.ones(G, bool))
    assert (ms[0].terms() == t0 + 1).all()
    assert (req.j.term == t0 + 1).all()


def test_need_snap_flag_past_compaction():
    ms = make_cluster(cap=16)
    elect(ms, 0)
    ms[0].propose(np.ones(G, np.int32), data=[[b""] for _ in range(G)])
    for i in range(6):
        ms[0].propose(np.ones(G, np.int32),
                      data=[[bytes([i])] for _ in range(G)])
        replicate(ms, 0, drop={2})
    ms[0].mark_applied(ms[0].commit_index())
    ms[0].compact()
    b = ms[0].build_append(2)
    assert b is not None and b.j.need_snap.all()
    frontier = ms[0].commit_index()
    terms = ms[0].commit_terms()
    assert ms[2].install_snapshot(frontier, terms).all()
    replicate(ms, 0)
    assert (ms[0].field("match")[:, 2] >= frontier).all()
    b = ms[0].build_append(2)
    assert b is None or not b.j.need_snap.any()
    ms[0].propose(np.ones(G, np.int32),
                  data=[[b"post"] for _ in range(G)])
    replicate(ms, 0)
    replicate(ms, 0)
    assert (ms[2].commit_index() > frontier).all()
    assert ms[2].committed_payload(0, int(frontier[0]) + 1) == b"post"


def test_partial_mask_campaign():
    ms = make_cluster()
    mask = np.zeros(G, bool)
    mask[:3] = True
    won = elect(ms, 1, mask)
    assert won[:3].all() and not won[3:].any()
    assert ms[1].is_leader()[:3].all()
    assert not ms[1].is_leader()[3:].any()


def test_dist_frames_match_fused_multiraft():
    """The same proposal schedule through the port's fused MultiRaft
    and through three paired DistMembers exchanging wire frames lands
    identical commit vectors, per-entry log terms and payloads."""
    rng = np.random.default_rng(42)
    g, m, cap, rounds = 6, 3, 64, 12
    fused = TMultiRaft(g=g, m=m, cap=cap, device="cpu")
    fused.campaign(0)
    dist = make_cluster(g=g, m=m, cap=cap)
    elect(dist, 0)
    dist[0].propose(np.ones(g, np.int32), data=[[b""] for _ in range(g)])
    replicate(dist, 0)
    for r in range(rounds):
        n_new = rng.integers(0, 3, size=g).astype(np.int32)
        payloads = [[bytes([r, j]) for j in range(int(n_new[gi]))]
                    for gi in range(g)]
        fused.propose(n_new, data=payloads)
        dist[0].propose(n_new, data=payloads)
        replicate(dist, 0)
    fused.replicate()
    replicate(dist, 0)
    np.testing.assert_array_equal(fused.commit_index(),
                                  dist[0].commit_index())
    st = fused.states[0]
    for gi in range(g):
        hi = int(fused.commit_index()[gi])
        for idx in range(1, hi + 1):
            ft = int(t_term_at(st.log_term, st.offset, st.last,
                               torch.full((g,), idx,
                                          dtype=torch.int32))[gi])
            dt = int(dist[0].terms_at(np.full(g, idx))[gi])
            assert ft == dt, (gi, idx, ft, dt)
            assert (fused.committed_payload(gi, idx) or b"") == \
                (dist[0].committed_payload(gi, idx) or b"")


@pytest.mark.parametrize("seed,m,steps", [(1234, 3, 120),
                                          (777, 5, 150)])
def test_randomized_lossy_exchange_log_matching(seed, m, steps):
    """The seeded lossy random walk: proposals, per-edge drops,
    competing campaigns, compactions, held equal after every call;
    then Log Matching across every pair of members."""
    rng = np.random.default_rng(seed)
    g, cap = 4, 96
    ms = make_cluster(g=g, m=m, cap=cap)
    elect(ms, 0)
    ms[0].propose(np.ones(g, np.int32), data=[[b""]] * g)

    def rand_drop():
        if rng.random() < 0.5:
            return set()
        return set(rng.choice(m, size=rng.integers(1, m),
                              replace=False).tolist())

    leader = 0
    for step in range(steps):
        act = rng.random()
        if act < 0.55:
            n = rng.integers(0, 3, size=g).astype(np.int32)
            data = [[bytes([step % 256, j]) for j in range(int(n[gi]))]
                    for gi in range(g)]
            ms[leader].propose(n, data=data)
            replicate(ms, leader, drop=rand_drop() - {leader})
        elif act < 0.75:
            replicate(ms, leader, drop=rand_drop() - {leader})
        elif act < 0.9:
            cand = int(rng.integers(0, m))
            won = elect(ms, cand)
            if won.any():
                leader = cand
                ms[cand].propose(
                    won.astype(np.int32),
                    data=[[b"L"] if won[gi] else [] for gi in range(g)])
        else:
            slot = int(rng.integers(0, m))
            ms[slot].mark_applied(ms[slot].commit_index())
            ms[slot].compact()
    for _ in range(6):
        replicate(ms, leader)
    assert sum(p.calls for p in ms) > steps
    for a in range(m):
        for b in range(a + 1, m):
            ca, cb = ms[a].commit_index(), ms[b].commit_index()
            oa, ob = ms[a].field("offset"), ms[b].field("offset")
            for gi in range(g):
                for idx in range(int(max(oa[gi], ob[gi])) + 1,
                                 int(min(ca[gi], cb[gi])) + 1):
                    v = np.full(g, idx)
                    assert ms[a].terms_at(v)[gi] == ms[b].terms_at(v)[gi]
                    pa = ms[a].committed_payload(gi, idx)
                    pb = ms[b].committed_payload(gi, idx)
                    if pa is not None and pb is not None:
                        assert pa == pb, (gi, idx, pa, pb)


@pytest.mark.parametrize("election,m", [(10, 3), (3, 8), (5, 5),
                                        (16, 4)])
def test_timeout_bands_are_disjoint_across_slots(election, m):
    """Stratified election timeouts: the same draws in both packages,
    each slot's band disjoint from every other's, all within
    [election, 2*election) after the clamp election >= m."""
    g, cap = 64, 16
    eff = max(election, m)
    ranges = []
    for s in range(m):
        mm = PairMember(g, m, s, cap, election=election, seed=s)
        assert mm.election == eff
        draws = np.concatenate([mm._draw_timeouts() for _ in range(50)])
        assert (draws >= eff).all() and (draws < 2 * eff).all()
        ranges.append((int(draws.min()), int(draws.max())))
    for i in range(m):
        for j in range(i + 1, m):
            assert ranges[i][1] < ranges[j][0] or \
                ranges[j][1] < ranges[i][0], (ranges[i], ranges[j])


def test_lost_campaign_backs_off_beyond_band():
    g, m, cap, election = 8, 3, 16, 10
    a = PairMember(g, m, 1, cap, election=election, seed=7)
    mask = np.ones(g, bool)
    a.begin_campaign(mask)
    band_hi = election + 2 * max(1, election // m)
    assert not a.tally(mask, []).any()
    t = a.field("timeout")
    assert (t >= band_hi).all() and (t > election).all()
    b = PairMember(g, 1, 0, cap, election=election, seed=8, live=1)
    b.begin_campaign(np.ones(g, bool))
    assert b.tally(np.ones(g, bool), []).all()
    tb = b.field("timeout")
    assert (tb >= election).all() and (tb < election + election).all()


def test_port_step_functions_never_alias_inputs():
    """Every engine step returns new tensors: a state read before a
    call still holds its old values after it (the server keeps field
    references across calls)."""
    ms = make_cluster()
    held = [ms[s].t.state for s in range(M)]
    before = [{f: _np(getattr(st, f)).copy() for f in st._fields}
              for st in held]
    elect(ms, 0)
    ms[0].propose(np.ones(G, np.int32), data=[[b"a"] for _ in range(G)])
    replicate(ms, 0)
    ms[1].mark_applied(ms[1].commit_index())
    ms[1].compact()
    ms[2].tick()
    ms[0].step_down(np.ones(G, bool))
    for st, snap in zip(held, before):
        for f in st._fields:
            np.testing.assert_array_equal(_np(getattr(st, f)), snap[f],
                                          err_msg=f)


def test_port_views_count_device_reads():
    """Each view is one counted host read of device state."""
    from etcd_tpu_torch.obs.devledger import ledger

    mm = TDistMember(G, M, 0, CAP, device="cpu")
    n0 = ledger.snapshot().get("dist.view", {}).get("fetches", 0)
    mm.is_leader()
    mm.leader_hint()
    mm.commit_index()
    mm.terms()
    mm.commit_terms()
    mm.terms_at(np.zeros(G, np.int32))
    assert ledger.snapshot()["dist.view"]["fetches"] == n0 + 6


def test_port_shard_not_ported_yet():
    """``shard`` is ported now: a mesh whose g-axis does not divide G
    raises the reference's ValueError, and a dividing one splits the
    state into g-blocks that read back as the same whole state."""
    from etcd_tpu_torch.parallel import group_mesh, local_devices

    mm = TDistMember(G, M, 0, CAP, device="cpu")
    with pytest.raises(ValueError, match="not divisible by mesh g-axis"):
        mm.shard(group_mesh(3, devices=local_devices("cpu")))
    before = {f: _np(getattr(mm.state, f)).copy() for f in mm.state._fields}
    mm.shard(group_mesh(8, devices=local_devices("cpu")))
    assert len(mm._blocks) == 4
    for f, v in before.items():
        np.testing.assert_array_equal(_np(getattr(mm.state, f)), v)
