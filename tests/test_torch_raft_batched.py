"""The port's batched Raft engine and quorum ops (etcd_tpu_torch, on the
CPU) against the JAX package's on the same numpy inputs: every
GroupState field and every error lane must be equal, dtype included.

States are random (seeded numpy) and carried into the port with
``group_state_from_numpy``; the cases of tests/test_raft_batched.py
(capacity overflow, conflict below commit, compaction err lanes, both
maybe_append write modes, tick firing) are among them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from etcd_tpu.ops import quorum as jq
from etcd_tpu.raft import batched as jb

from etcd_tpu_torch.ops import quorum as tq
from etcd_tpu_torch.raft import batched as tb

G, M, CAP, E = 32, 5, 64, 8


def _random_fields(rng, g=G, m=M, cap=CAP):
    """A random but well-formed GroupState as numpy arrays."""
    offset = rng.integers(0, 4, size=g).astype(np.int32)
    last = offset + rng.integers(0, 20, size=g).astype(np.int32)
    log_term = np.zeros((g, cap), np.int32)
    for i in range(g):
        n = int(last[i] - offset[i]) + 1
        log_term[i, :n] = np.sort(rng.integers(0, 5, size=n))
    commit = (offset + rng.integers(0, 1 << 20, size=g)
              % (last - offset + 1)).astype(np.int32)
    applied = (offset + rng.integers(0, 1 << 20, size=g)
               % (commit - offset + 1)).astype(np.int32)
    members = rng.random((g, m)) < 0.85
    members[:, 0] = True
    match = (rng.integers(0, 1 << 20, size=(g, m))
             % (last[:, None] + 1)).astype(np.int32)
    return {
        "term": rng.integers(0, 6, size=g).astype(np.int32),
        "vote": rng.integers(-1, m, size=g).astype(np.int32),
        "role": rng.integers(0, 3, size=g).astype(np.int32),
        "lead": rng.integers(-1, m, size=g).astype(np.int32),
        "commit": commit, "applied": applied, "log_term": log_term,
        "offset": offset, "last": last, "match": match,
        "next_": match + rng.integers(1, 3, size=(g, m)).astype(np.int32),
        "nmembers": members.sum(axis=1).astype(np.int32),
        "elapsed": rng.integers(0, 12, size=g).astype(np.int32),
        "timeout": rng.integers(5, 12, size=g).astype(np.int32),
        "members": members,
    }


def _states(fields):
    return (jb.GroupState(**{k: jnp.asarray(v) for k, v in fields.items()}),
            tb.group_state_from_numpy(fields, "cpu"))


def _np(x):
    if isinstance(x, (jb.GroupState, tb.GroupState)):
        x = x._asdict()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_np(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _assert_same(want, got, where=""):
    want, got = _np(want), _np(got)
    if isinstance(want, dict):
        assert want.keys() == got.keys()
        for k in want:
            _assert_same(want[k], got[k], f"{where}.{k}")
    elif isinstance(want, tuple):
        assert len(want) == len(got), where
        for i, (a, b) in enumerate(zip(want, got)):
            _assert_same(a, b, f"{where}[{i}]")
    else:
        assert want.dtype == got.dtype, (where, want.dtype, got.dtype)
        np.testing.assert_array_equal(got, want, err_msg=where)


def _run(name, fields, *args, **kw):
    """Run batched.<name> in both packages on the same inputs; numpy
    arguments are converted, anything else is passed as it is."""
    js, ts = _states(fields)

    def conv(a, f):
        return f(a) if isinstance(a, np.ndarray) else a

    jout = getattr(jb, name)(js, *[conv(a, jnp.asarray) for a in args],
                             **{k: conv(v, jnp.asarray) for k, v in kw.items()})
    tout = getattr(tb, name)(ts, *[conv(a, torch.from_numpy) for a in args],
                             **{k: conv(v, torch.from_numpy)
                                for k, v in kw.items()})
    _assert_same(jout, tout, name)
    return _np(tout)


def _i32(a):
    return np.asarray(a, np.int32)


@pytest.mark.parametrize("g,m,cap,election,live",
                         [(32, 5, 64, 10, None), (7, 3, 16, 4, 2)])
def test_init_groups_parity(g, m, cap, election, live):
    _assert_same(jb.init_groups(g, m, cap, election, live),
                 tb.init_groups(g, m, cap, election, live, device="cpu"))


def test_group_state_numpy_round_trip():
    fields = _random_fields(np.random.default_rng(0))
    back = tb.group_state_to_numpy(tb.group_state_from_numpy(fields, "cpu"))
    _assert_same(fields, back)
    assert tb.group_state_from_numpy(fields, "cpu").cap == CAP


def test_log_primitives_parity():
    rng = np.random.default_rng(1)
    f = _random_fields(rng)
    js, ts = _states(f)
    idx2 = _i32(rng.integers(-2, 25, size=(G, 4)))
    idx1 = _i32(rng.integers(-2, 25, size=G))
    term = _i32(rng.integers(0, 5, size=G))
    for args in [(idx2,), (idx1,)]:
        _assert_same(
            jb.term_at(js.log_term, js.offset, js.last, jnp.asarray(args[0])),
            tb.term_at(ts.log_term, ts.offset, ts.last,
                       torch.from_numpy(args[0])))
    _assert_same(
        jb.match_term(js.log_term, js.offset, js.last, jnp.asarray(idx1),
                      jnp.asarray(term)),
        tb.match_term(ts.log_term, ts.offset, ts.last,
                      torch.from_numpy(idx1), torch.from_numpy(term)))
    _assert_same(
        jb.is_up_to_date(js.log_term, js.offset, js.last, jnp.asarray(idx1),
                         jnp.asarray(term)),
        tb.is_up_to_date(ts.log_term, ts.offset, ts.last,
                         torch.from_numpy(idx1), torch.from_numpy(term)))


@pytest.mark.parametrize("mode,env", [("dense", None), ("scatter", None),
                                      (None, "dense"), (None, "scatter")])
def test_maybe_append_parity(mode, env, monkeypatch):
    if env is None:
        monkeypatch.delenv("ETCD_APPEND_WRITE", raising=False)
    else:
        monkeypatch.setenv("ETCD_APPEND_WRITE", env)
    rng = np.random.default_rng(2)
    seen = np.zeros(3, bool)  # ok, err_conflict, err_overflow
    for trial in range(4):
        f = _random_fields(rng, cap=24 if trial % 2 else CAP)
        prev_idx = _i32(rng.integers(0, 22, size=G))
        prev_term = _i32(rng.integers(0, 5, size=G))
        n_ents = _i32(rng.integers(0, E + 1, size=G))
        ent_terms = np.sort(_i32(rng.integers(1, 5, size=(G, E))), axis=1)
        leader_commit = _i32(rng.integers(0, 30, size=G))
        active = None if trial < 2 else rng.random(G) < 0.8
        # lanes whose prev entry matches, so appends are accepted
        lt = f["log_term"][np.arange(G),
                           np.clip(prev_idx - f["offset"], 0, None)]
        take = rng.random(G) < 0.7
        prev_term = np.where(take, lt, prev_term).astype(np.int32)
        _, ok, errc, erro = _run("maybe_append", f, prev_idx, prev_term,
                                 ent_terms, n_ents, leader_commit,
                                 active=active, write_mode=mode)
        seen |= [ok.any(), errc.any(), erro.any()]
    assert seen.all(), seen  # accepted, conflict and overflow lanes all ran


def test_maybe_append_bad_env_raises(monkeypatch):
    monkeypatch.setenv("ETCD_APPEND_WRITE", "sparse")
    f = _random_fields(np.random.default_rng(3))
    _, ts = _states(f)
    z = torch.zeros(G, dtype=torch.int32)
    with pytest.raises(ValueError):
        tb.maybe_append(ts, z, z, torch.zeros((G, E), dtype=torch.int32),
                        z, z)


@pytest.mark.parametrize("self_ack", [True, False])
def test_leader_append_parity(self_ack):
    rng = np.random.default_rng(4)
    f = _random_fields(rng)
    f["role"][: G // 2] = tb.LEADER
    n_new = _i32(rng.integers(0, CAP, size=G))  # some lanes overflow
    self_slot = _i32(rng.integers(0, M, size=G))
    active = rng.random(G) < 0.9
    _, err = _run("leader_append", f, n_new, self_slot, active=active,
                  self_ack=self_ack)
    assert err.any() and not err.all()


def test_capacity_overflow_err_lane_parity():
    f = tb.group_state_to_numpy(tb.init_groups(4, 3, 8, device="cpu"))
    f["role"][:] = tb.LEADER
    f["term"][:] = 1
    _, err = _run("leader_append", f, _i32([1, 9, 2, 30]), _i32([0] * 4))
    np.testing.assert_array_equal(err, [False, True, False, True])


@pytest.mark.parametrize("name", ["progress_update", "progress_optimistic"])
def test_progress_parity(name):
    rng = np.random.default_rng(5)
    f = _random_fields(rng)
    slot = _i32(rng.integers(-1, M + 1, size=G))  # out of range included
    idx = _i32(rng.integers(0, 30, size=G))
    _run(name, f, slot, idx)
    _run(name, f, slot, idx, active=rng.random(G) < 0.5)


def test_progress_probe_and_repair_parity():
    rng = np.random.default_rng(6)
    f = _random_fields(rng)
    slot = _i32(rng.integers(0, M, size=G))
    _run("progress_probe", f, slot)
    _run("progress_probe", f, slot, active=rng.random(G) < 0.5)
    hint = _i32(rng.integers(-3, 30, size=G))
    _run("progress_repair", f, slot, hint, rng.random(G) < 0.7)


def test_maybe_commit_parity():
    rng = np.random.default_rng(7)
    for _ in range(3):
        f = _random_fields(rng)
        f["role"][:] = np.where(rng.random(G) < 0.8, tb.LEADER, f["role"])
        f["term"] = f["log_term"].max(axis=1).astype(np.int32)
        _run("maybe_commit", f)


def test_replication_round_parity():
    rng = np.random.default_rng(8)
    f = _random_fields(rng)
    f["role"][:] = tb.LEADER
    f["term"] = (f["log_term"].max(axis=1) + 1).astype(np.int32)
    n_new = _i32(rng.integers(0, 6, size=G))
    resp_slots = _i32(rng.integers(0, M, size=(G, 3)))
    resp_idx = (f["last"] + n_new)[:, None] - _i32(
        rng.integers(0, 3, size=(G, 3)))
    resp_mask = rng.random((G, 3)) < 0.8
    out = _run("replication_round", f, n_new, _i32(np.zeros(G)),
               resp_slots, resp_idx.astype(np.int32), resp_mask)
    assert (out[2] > 0).any()


@pytest.mark.parametrize("active", [False, True])
def test_compact_parity(active):
    rng = np.random.default_rng(9)
    f = _random_fields(rng)
    idx = _i32(f["offset"] + rng.integers(-1, 6, size=G))  # err lanes too
    _, err = _run("compact", f, idx,
                  active=(rng.random(G) < 0.7) if active else None)
    assert err.any() and not err.all()


def test_compact_err_lanes_parity():
    f = tb.group_state_to_numpy(tb.init_groups(3, 3, 16, device="cpu"))
    f.update(last=_i32([5, 5, 5]), applied=_i32([3, 3, 3]),
             offset=_i32([2, 0, 0]))
    _, err = _run("compact", f, _i32([1, 4, 2]))
    np.testing.assert_array_equal(err, [True, True, False])


@pytest.mark.parametrize("with_members,with_commit",
                         [(False, False), (True, True)])
def test_restore_snapshot_parity(with_members, with_commit):
    rng = np.random.default_rng(10)
    f = _random_fields(rng)
    idx = _i32(f["commit"] + rng.integers(-2, 5, size=G))
    term = _i32(rng.integers(1, 6, size=G))
    kw = {"active": rng.random(G) < 0.8}
    if with_commit:
        kw["commit"] = idx - _i32(rng.integers(0, 2, size=G))
    if with_members:
        kw["members"] = rng.random((G, M)) < 0.7
    _, installed = _run("restore_snapshot", f, idx, term, **kw)
    assert installed.any() and not installed.all()


def test_apply_conf_change_parity():
    rng = np.random.default_rng(11)
    f = _random_fields(rng)
    add = rng.random(G) < 0.5
    slot = _i32(rng.integers(0, M, size=G))
    self_slot = np.where(rng.random(G) < 0.3, slot,
                         _i32(rng.integers(0, M, size=G))).astype(np.int32)
    _run("apply_conf_change", f, add, slot, self_slot)
    _run("apply_conf_change", f, add, slot, self_slot,
         active=rng.random(G) < 0.6)


@pytest.mark.parametrize("heartbeat", [1, 3])
def test_tick_parity(heartbeat):
    f = _random_fields(np.random.default_rng(12))
    js, ts = _states(f)
    for _ in range(4):  # carry the state across ticks in both packages
        js, je, jbeat = jb.tick(js, heartbeat)
        ts, te, tbeat = tb.tick(ts, heartbeat)
        _assert_same((js, je, jbeat), (ts, te, tbeat))


def test_grant_vote_parity():
    rng = np.random.default_rng(13)
    f = _random_fields(rng)
    cand_idx = _i32(rng.integers(0, 25, size=G))
    cand_term = _i32(rng.integers(0, 6, size=G))
    msg_term = _i32(rng.integers(0, 7, size=G))
    cand_slot = _i32(rng.integers(0, M, size=G))
    _, grant = _run("grant_vote", f, cand_idx, cand_term, msg_term,
                    cand_slot)
    assert grant.any() and not grant.all()
    _run("grant_vote", f, cand_idx, cand_term, msg_term, cand_slot,
         active=rng.random(G) < 0.5)


def test_quorum_ops_parity():
    rng = np.random.default_rng(14)
    match = _i32(rng.integers(0, 20, size=(G, M)))
    nmembers = _i32(rng.integers(1, M + 1, size=G))
    _assert_same(jq.commit_index_batch(jnp.asarray(match),
                                       jnp.asarray(nmembers)),
                 tq.commit_index_batch(torch.from_numpy(match),
                                       torch.from_numpy(nmembers)))
    committed = _i32(rng.integers(0, 10, size=G))
    term = _i32(rng.integers(1, 4, size=G))
    log_terms = _i32(rng.integers(1, 4, size=(G, CAP)))
    offset = _i32(rng.integers(0, 3, size=G))
    args = (match, nmembers, committed, term, log_terms, offset)
    _assert_same(jq.maybe_commit_batch(*map(jnp.asarray, args)),
                 tq.maybe_commit_batch(*map(torch.from_numpy, args)))
    ack_t0 = rng.random((M, G)) * 10
    members = rng.random((G, M)) < 0.8
    members[:, 2] = True
    nm = members.sum(axis=1)
    np.testing.assert_array_equal(
        tq.quorum_basis(ack_t0, members, nm, 2, 11.0),
        jq.quorum_basis(ack_t0, members, nm, 2, 11.0))
