"""The port's co-hosted MultiRaft (etcd_tpu_torch, on the CPU) against the
JAX package's, call for call.

Every scenario of tests/test_multiraft.py runs on both engines at the
same seed through :class:`Pair`, which calls each method on both and,
after EVERY call, holds equal: every GroupState field of every member
slot, ``leader``, the hot-slot route, ``payloads``, the three ``errors``
lanes, the payload keying of the last round and the returned values.
Every scenario of tests/test_multiraft_hot.py runs the same way (the
hot-slot round against the general one, mixed routing, reject repair,
overflow lanes).  Tolerance: exact (integer state).  The scenarios
share two shapes (M=3: G=8, cap 64; M=5: G=16, cap 32, the walk's)
and one train length (3), so the JAX side compiles each program once.  A
seeded random walk mixes every operation, and the port's round, whose
snapshot install is masked, is held equal to the reference's round,
whose install is a branch on ``needs_snap.any()``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from etcd_tpu.raft import multiraft as jmr
from etcd_tpu.raft.batched import LEADER, GroupState as JGroupState
from etcd_tpu.raft.multiraft import MultiRaft as JMultiRaft

from etcd_tpu_torch.raft import multiraft as tmr
from etcd_tpu_torch.raft.batched import group_state_from_numpy
from etcd_tpu_torch.raft.multiraft import MultiRaft as TMultiRaft


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


class Pair:
    """One JAX engine and one port engine, driven in lockstep."""

    def __init__(self, **kw):
        self.j = JMultiRaft(**kw)
        self.t = TMultiRaft(**kw, device="cpu")
        self.calls = 0
        self.check()

    def __getattr__(self, name):
        fj, ft = getattr(self.j, name), getattr(self.t, name)
        if not callable(fj):
            return fj

        def both(*args, **kw):
            rj = fj(*args, **kw)
            rt = ft(*args, **kw)
            self.calls += 1
            if rj is None:
                assert rt is None, name
            else:
                np.testing.assert_array_equal(_np(rt), _np(rj),
                                              err_msg=name)
                assert _np(rt).dtype == _np(rj).dtype, name
            self.check(name)
            return rj
        return both

    def force_general(self) -> None:
        """Pin both engines to the general M-slot round."""
        for mr in (self.j, self.t):
            mr._recompute_hot = lambda: None
            mr._route_hot = None

    def mutate(self, slot: int, **fields) -> None:
        """Overwrite state fields of one member slot on both engines."""
        sj = self.j.states[slot]
        self.j.states[slot] = sj._replace(
            **{k: jnp.asarray(v) for k, v in fields.items()})
        st = self.t.states[slot]
        self.t.states[slot] = st._replace(
            **{k: torch.as_tensor(np.asarray(v)) for k, v in
               fields.items()})
        self.check("mutate")

    def field(self, slot: int, name: str) -> np.ndarray:
        return np.asarray(getattr(self.j.states[slot], name))

    def check(self, after: str = "init") -> None:
        j, t = self.j, self.t
        for s in range(j.m):
            for f in j.states[s]._fields:
                a = np.asarray(getattr(j.states[s], f))
                b = _np(getattr(t.states[s], f))
                np.testing.assert_array_equal(
                    b, a, err_msg=f"after {after}: slot {s} field {f}")
                assert b.dtype == a.dtype, (after, s, f)
        np.testing.assert_array_equal(t.leader, j.leader)
        assert t._route_hot == j._route_hot, after
        assert t.payloads == j.payloads, after
        for k in ("overflow", "conflict", "compact_oob"):
            np.testing.assert_array_equal(
                _np(t.errors[k]), np.asarray(j.errors[k]),
                err_msg=f"after {after}: errors[{k}]")
        for k in ("last_valid", "last_base"):
            if hasattr(j, k):
                np.testing.assert_array_equal(getattr(t, k), getattr(j, k))


def _ones(g):
    return np.ones(g, bool)


# -- scenarios of tests/test_multiraft.py ---------------------------------

def sc_campaign_elects_all_groups():
    mr = Pair(g=8, m=3, cap=64)
    assert mr.campaign(0).all()
    np.testing.assert_array_equal(mr.commit_index(), 1)
    return mr


def sc_propose_commits_across_groups():
    mr = Pair(g=16, m=5, cap=32)
    mr.campaign(0)
    np.testing.assert_array_equal(mr.propose(np.full(16, 3, np.int32)), 3)
    np.testing.assert_array_equal(mr.commit_index(), 4)
    return mr


def sc_payload_store_roundtrip():
    mr = Pair(g=8, m=3, cap=64)
    mr.campaign(0)
    data = [[f"g{g}-v{j}".encode() for j in range(2)] for g in range(8)]
    mr.propose(np.full(8, 2, np.int32), data=data)
    assert mr.committed_payload(2, 2) == b"g2-v0"
    return mr


def sc_leader_change_and_log_repair():
    mr = Pair(g=8, m=3, cap=64)
    mr.campaign(0)
    mr.propose(np.full(8, 2, np.int32))
    mask = np.zeros(8, bool)
    mask[::2] = True
    won = mr.campaign(1, mask)
    assert won[::2].all() and not won[1::2].any()
    mr.propose(np.full(8, 1, np.int32))
    for _ in range(4):
        mr.replicate()
    assert (mr.commit_index() >= 4).all()
    return mr


def sc_tick_triggers_election():
    mr = Pair(g=8, m=3, cap=64, election=4)
    for _ in range(10):
        mr.tick()
        if (mr.leader >= 0).all():
            break
    assert (mr.leader >= 0).all()
    mr.propose(np.full(8, 1, np.int32))
    for _ in range(3):
        mr.replicate()
    return mr


def sc_backlog_replicates_in_windows():
    mr = Pair(g=8, m=3, cap=64)
    mr.campaign(0)
    mr.propose(np.full(8, 20, np.int32))
    for _ in range(8):
        mr.replicate()
    np.testing.assert_array_equal(mr.commit_index(), 21)
    return mr


def sc_minority_cannot_commit():
    mr = Pair(g=16, m=5, cap=32)
    mr.campaign(0)
    base = mr.commit_index().copy()
    for peer in (2, 3, 4):
        mr.mutate(peer, term=mr.field(peer, "term") + 100)
    mr.propose(np.full(16, 1, np.int32))
    for _ in range(3):
        mr.replicate()
    np.testing.assert_array_equal(mr.commit_index(), base)
    return mr


def sc_steady_state_no_churn():
    mr = Pair(g=8, m=3, cap=64, election=3)
    for _ in range(10):
        mr.tick()
        if (mr.leader >= 0).all():
            break
    lead0 = mr.leader.copy()
    for _ in range(12):
        mr.tick()
        mr.replicate()
    np.testing.assert_array_equal(mr.leader, lead0)
    return mr


def sc_deposed_leader_propose_stores_nothing():
    mr = Pair(g=8, m=3, cap=64)
    mr.campaign(0)
    mr.mutate(0, role=np.zeros(8, np.int32))
    mr.propose(np.full(8, 1, np.int32), data=[[b"stale"] for _ in range(8)])
    return mr


def sc_drop_mask_delays_but_converges():
    mr = Pair(g=8, m=3, cap=64)
    mr.campaign(0)
    drop = {(0, 2): _ones(8)}
    mr.propose(np.full(8, 3, np.int32), drop=drop)
    for _ in range(3):
        mr.replicate(drop=drop)
    np.testing.assert_array_equal(mr.commit_index(), 4)
    for _ in range(3):
        mr.replicate()
    assert (mr.field(2, "last") == 4).all()
    return mr


def sc_drop_both_followers_blocks_commit():
    mr = Pair(g=8, m=3, cap=64)
    mr.campaign(0)
    drop = {(0, 1): _ones(8), (0, 2): _ones(8)}
    mr.propose(np.full(8, 2, np.int32), drop=drop)
    for _ in range(3):
        mr.replicate(drop=drop)
    mr.replicate()
    np.testing.assert_array_equal(mr.commit_index(), 3)
    return mr


def sc_lost_ack_resends_idempotently():
    mr = Pair(g=8, m=3, cap=64)
    mr.campaign(0)
    drop = {(1, 0): _ones(8)}
    mr.propose(np.full(8, 2, np.int32), drop=drop)
    for _ in range(2):
        mr.replicate(drop=drop)
    mr.replicate()
    np.testing.assert_array_equal(mr.commit_index(), 3)
    return mr


def sc_truncated_payload_invalidated():
    mr = Pair(g=8, m=3, cap=64)
    mr.campaign(0)
    drop = {(0, 1): _ones(8), (0, 2): _ones(8)}
    mr.propose(np.full(8, 1, np.int32),
               data=[[b"STALE"] for _ in range(8)], drop=drop)
    mr.campaign(1)
    for _ in range(3):
        mr.replicate()
    assert mr.committed_payload(0, 2) is None
    return mr


def sc_compact_and_snapshot_catchup():
    mr = Pair(g=8, m=3, cap=64)
    mr.campaign(0)
    drop = {(0, 2): _ones(8)}
    mr.propose(np.full(8, 6, np.int32), drop=drop)
    for _ in range(3):
        mr.replicate(drop=drop)
    mr.mark_applied(mr.commit_index())
    mr.compact()
    for _ in range(3):
        mr.replicate()
    assert (mr.field(2, "offset") == 7).all()
    mr.propose(np.full(8, 2, np.int32))
    for _ in range(2):
        mr.replicate()
    np.testing.assert_array_equal(mr.commit_index(), 9)
    return mr


def sc_per_group_overflow_isolated():
    mr = Pair(g=8, m=3, cap=64)
    mr.campaign(0)
    n = np.array([63, 1, 1, 1, 1, 1, 1, 1], np.int32)  # group 0: 1+63 = cap
    newly = mr.propose(n, data=[[b"p%d" % j for j in range(63)]]
                       + [[b"x"]] * 7)
    assert newly[0] == 0 and bool(mr.t.errors["overflow"][0])
    mr.mark_applied(mr.commit_index())
    mr.compact()
    assert mr.propose(np.array([5] + [0] * 7, np.int32))[0] == 5
    return mr


def sc_split_vote_then_retry_converges():
    mr = Pair(g=16, m=5, cap=32)
    o = _ones(16)
    assert not mr.campaign(0, drop={(0, 3): o, (0, 4): o, (1, 0): o,
                                    (2, 0): o}).any()
    assert not mr.campaign(4).any()
    assert mr.campaign(0).all()
    return mr


def sc_partitioned_candidate_cannot_win():
    mr = Pair(g=8, m=3, cap=64)
    o = _ones(8)
    part = {(0, 1): o, (0, 2): o, (1, 0): o, (2, 0): o}
    assert not mr.campaign(0, drop=part).any()
    assert mr.campaign(1, drop=part).all()
    mr.propose(np.full(8, 2, np.int32), drop=part)
    for _ in range(3):
        mr.replicate(drop=part)
    for _ in range(4):
        mr.replicate()
    assert (mr.field(0, "role") != LEADER).all()
    return mr


def sc_vote_request_drop_vs_response_drop():
    mr = Pair(g=8, m=3, cap=64)
    o = _ones(8)
    assert not mr.campaign(0, drop={(0, 1): o, (2, 0): o}).any()
    assert not mr.campaign(1).any()
    assert mr.campaign(1).all()
    return mr


def sc_shrink_5_to_3_under_load():
    mr = Pair(g=16, m=5, cap=32)
    mr.campaign(0)
    mr.propose(np.full(16, 2, np.int32))
    mr.apply_conf_change(add=False, slot=4)
    mr.propose(np.full(16, 2, np.int32))
    mr.apply_conf_change(add=False, slot=3)
    mr.propose(np.full(16, 2, np.int32), drop={(0, 2): _ones(16)})
    assert (mr.commit_index() == 7).all()
    return mr


def sc_grow_3_to_5_under_load():
    mr = Pair(g=16, m=5, cap=32, live=3)
    mr.campaign(0)
    mr.propose(np.full(16, 2, np.int32))
    mr.apply_conf_change(add=True, slot=3)
    mr.propose(np.full(16, 1, np.int32))
    for _ in range(3):
        mr.replicate()
    mr.apply_conf_change(add=True, slot=4)
    mr.propose(np.full(16, 1, np.int32))
    for _ in range(6):
        mr.replicate()
    assert (mr.commit_index() == 5).all()
    return mr


def sc_removed_leader_group_reelects():
    mr = Pair(g=8, m=3, cap=64)
    mr.campaign(0)
    mr.propose(np.full(8, 1, np.int32))
    mr.apply_conf_change(add=False, slot=0)
    assert (mr.leader == -1).all()
    assert mr.campaign(1).all()
    mr.propose(np.full(8, 1, np.int32))
    for _ in range(2):
        mr.replicate()
    return mr


def sc_removed_member_cannot_campaign_or_vote():
    mr = Pair(g=8, m=3, cap=64)
    mr.apply_conf_change(add=False, slot=2)
    assert not mr.campaign(2).any()
    assert mr.campaign(0).all()
    return mr


def sc_snapshot_carries_membership():
    mr = Pair(g=16, m=5, cap=32)
    mr.campaign(0)
    drop = {(0, 2): _ones(16)}
    mr.propose(np.full(16, 5, np.int32), drop=drop)
    for _ in range(2):
        mr.replicate(drop=drop)
    mr.apply_conf_change(add=False, slot=4)
    mr.mutate(2, members=np.ones((16, 5), bool),
              nmembers=np.full(16, 5, np.int32))
    mr.mark_applied(mr.commit_index())
    mr.compact()
    for _ in range(3):
        mr.replicate()
    assert not mr.field(2, "members")[:, 4].any()
    return mr


def sc_compact_prunes_payloads():
    mr = Pair(g=8, m=3, cap=64)
    mr.campaign(0)
    mr.propose(np.full(8, 3, np.int32),
               data=[[b"a", b"b", b"c"], [b"x", b"y", b"z"]] * 4)
    mr.replicate()
    mr.mark_applied(mr.commit_index())
    mr.compact()
    assert mr.committed_payload(0, 2) is None
    return mr


def sc_propose_rounds_matches_serial():
    mr = Pair(g=8, m=3, cap=64)
    mr.campaign(0)
    one = np.ones(8, np.int32)
    np.testing.assert_array_equal(mr.propose_rounds(one, 3), 3)
    for _ in range(22):  # cap 64 overflows; the lanes surface identically
        mr.propose_rounds(one, 3)
    assert mr.t.errors["overflow"].any()
    return mr


# -- scenarios of tests/test_multiraft_hot.py ------------------------------

HG = 8


def _hot_pair(force_general: bool) -> Pair:
    mr = Pair(g=HG, m=3, cap=64, seed=3)
    if force_general:
        mr.force_general()
    mr.campaign(0)
    return mr


def _hot_rounds(mr: Pair, with_drops: bool) -> None:
    rng = np.random.default_rng(7)
    for step in range(6):
        drop = None
        if with_drops and step % 2:
            drop = {(0, 1): rng.random(HG) < 0.5,
                    (2, 0): rng.random(HG) < 0.5}
        mr.propose(rng.integers(0, 3, size=HG).astype(np.int32), drop=drop)
    mr.mark_applied(mr.commit_index())
    mr.compact()
    mr.propose_rounds(np.ones(HG, np.int32), 3)


def sc_hot_rounds():
    mr = _hot_pair(False)
    assert mr.t._route_hot == 0
    _hot_rounds(mr, False)
    return mr


def sc_hot_rounds_with_drops():
    mr = _hot_pair(False)
    _hot_rounds(mr, True)
    return mr


def sc_general_rounds():
    mr = _hot_pair(True)
    _hot_rounds(mr, False)
    return mr


def sc_general_rounds_with_drops():
    mr = _hot_pair(True)
    _hot_rounds(mr, True)
    return mr


def sc_mixed_routing_falls_back_to_general():
    mr = _hot_pair(False)
    half = np.zeros(HG, bool)
    half[: HG // 2] = True
    assert mr.campaign(1, half).any()
    assert mr.t._route_hot is None
    for _ in range(3):
        mr.propose(np.ones(HG, np.int32))
    return mr


def sc_lagging_member_catches_up_bandwidth_bound():
    mr = Pair(g=8, m=3, cap=64, seed=2)
    mr.campaign(0)
    mr.propose(np.ones(8, np.int32), data=[[b""] for _ in range(8)])
    for i in range(24):
        mr.propose(np.ones(8, np.int32),
                   data=[[bytes([i])] for _ in range(8)],
                   drop={(0, 2): _ones(8), (2, 0): _ones(8)})
    assert mr.campaign(1).all()
    for _ in range(2 + 24 // 8):
        mr.replicate()
    assert (mr.field(2, "commit") >= mr.field(1, "commit")).all()
    return mr


def sc_overflow_lane_parity():
    mr = _hot_pair(False)
    for _ in range(16):  # cap 64 fills up without compaction
        mr.propose(np.full(HG, 4, np.int32))
    assert mr.t.errors["overflow"].any()
    return mr


# -- a seeded random walk over every operation ------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_random_walk_equal(seed):
    """About 40 mixed operations at G=16, M=5, cap=32: campaigns with
    dropped edges, proposals with random counts, payloads and drop
    masks, ticks, applies, compactions and conf changes.  Two bursts
    overflow logs; the walk must also install a snapshot on a lagging
    follower (an offset that moves outside a compaction)."""
    g, m = 16, 5
    rng = np.random.default_rng(100 + seed)
    mr = Pair(g=g, m=m, cap=32, election=3, seed=seed, live=4)
    seen = {"overflow": False, "snap": False}

    def drop_mask():
        if rng.random() < 0.4:
            return None
        return {(int(a), int(b)): rng.random(g) < 0.5
                for a, b in rng.integers(0, m, size=(2, 2)) if a != b}

    def offsets():
        return np.stack([mr.field(s, "offset") for s in range(m)])

    mr.campaign(0)
    for step in range(40):
        op = "burst" if step in (12, 30) else rng.choice(
            ["campaign", "propose", "propose", "propose", "tick",
             "compact", "compact", "conf", "rounds"])
        before = offsets()
        if op == "campaign":
            mr.campaign(int(rng.integers(0, m)), rng.random(g) < 0.5,
                        drop=drop_mask())
        elif op in ("propose", "burst"):
            n = rng.integers(0, 6, size=g).astype(np.int32)
            if op == "burst":
                n += 24
            data = [[bytes([step, j]) for j in range(int(n[gi]))]
                    for gi in range(g)]
            mr.propose(n, data=data, drop=drop_mask())
        elif op == "tick":
            mr.tick(drop=drop_mask())
        elif op == "compact":
            mr.mark_applied(mr.commit_index())
            mr.compact()
            before = offsets()
            mr.replicate()
        elif op == "conf":
            mr.apply_conf_change(add=bool(rng.random() < 0.5),
                                 slot=int(rng.integers(1, m)),
                                 mask=rng.random(g) < 0.5)
        else:
            mr.propose_rounds(rng.integers(0, 3, size=g).astype(np.int32),
                              3)
        seen["snap"] |= bool((offsets() > before).any())
        seen["overflow"] |= bool(mr.t.errors["overflow"].any())
    assert seen["overflow"], "the walk never overflowed a log"
    assert seen["snap"], "the walk never installed a snapshot"
    assert mr.calls >= 40


# -- the masked snapshot install equals the reference's branch -------------

def _lagging_states(install: bool):
    """A port engine, compacted once, where follower 2 lags leader 0 by
    more than one append window on the even lanes; with ``install`` the
    leader has compacted again, past the lagging follower, so those
    lanes need a snapshot in the next round."""
    mr = TMultiRaft(g=8, m=3, cap=64, device="cpu")
    mr.campaign(0)
    mr.propose(np.full(8, 10, np.int32))
    mr.replicate()
    mr.mark_applied(mr.commit_index())
    mr.compact()
    drop = {(0, 2): np.arange(8) % 2 == 0}
    mr.propose(np.full(8, 12, np.int32), drop=drop)
    mr.replicate(drop=drop)
    if install:
        mr.mark_applied(mr.commit_index())
        mr.compact()
    return mr


def _to_jax(st):
    return JGroupState(**{f: jnp.asarray(getattr(st, f).numpy())
                          for f in st._fields})


@pytest.mark.parametrize("acks_dropped", [False, True])
@pytest.mark.parametrize("install", [False, True])
@pytest.mark.parametrize("general", [False, True])
def test_masked_install_equals_branch(install, general, acks_dropped):
    """The port's round, which runs the install masked every time, equals
    the reference's ``_round_core`` (the install under ``lax.cond`` on
    ``needs_snap.any()``) on the same lagging states, field for field,
    in a round that installs a snapshot and in one that does not, with
    and without follower 2's acks dropped on some lanes."""
    mr = _lagging_states(install)
    lst, fol = mr.states[0], mr.states[2]
    nxt = lst.next_[:, 2]
    needs = (nxt <= lst.offset) & (lst.offset > 0)
    assert bool(needs.any()) == install
    sel = torch.as_tensor(mr.leader == 0)
    slots = (0, 1, 2) if general else (0,)
    sels = [sel, torch.zeros_like(sel), torch.zeros_like(sel)] \
        if general else [sel]
    n_new = torch.ones(8, dtype=torch.int32)
    drop = mr._drop({(2, 0): np.arange(8) % 4 == 0} if acks_dropped
                    else None)
    st, *rest = tmr._round_core(tuple(mr.states), sels, n_new, drop,
                                mr.e, slots)
    jst, *jrest = jmr._round_core(
        tuple(_to_jax(x) for x in mr.states),
        [jnp.asarray(x.numpy()) for x in sels], jnp.asarray(n_new.numpy()),
        jnp.asarray(drop.numpy()), mr.e, slots)
    for name, x, y in zip(("newly", "valid", "base", "overflow",
                           "conflict"), rest, jrest):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y),
                                      err_msg=name)
    for s, (a, b) in enumerate(zip(st, jst)):
        for f in a._fields:
            np.testing.assert_array_equal(
                getattr(a, f).numpy(), np.asarray(getattr(b, f)),
                err_msg=f"slot {s} field {f}")
    if install:
        assert not torch.equal(st[2].offset, fol.offset)


SCENARIOS = {name[3:]: fn for name, fn in sorted(globals().items())
             if name.startswith("sc_")}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_equal_call_for_call(name):
    mr = SCENARIOS[name]()
    assert mr.calls > 0


def test_restart_seeded_states_round_trip():
    """``group_state_from_numpy`` carries a JAX engine's state into the
    port's; both then run the same round to the same state."""
    pair = Pair(g=8, m=3, cap=64)
    pair.campaign(0)
    for s in range(3):
        pair.t.states[s] = group_state_from_numpy(
            {f: np.asarray(getattr(pair.j.states[s], f))
             for f in pair.j.states[s]._fields}, "cpu")
    pair.propose(np.full(8, 2, np.int32))
    pair.check()


def test_engine_raises_without_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        TMultiRaft(g=2, m=3, cap=8)
