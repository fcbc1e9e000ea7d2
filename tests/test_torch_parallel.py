"""The port's mesh layer (etcd_tpu_torch.parallel, on the CPU's 8 virtual
devices) against the JAX package's (on its 8 virtual XLA CPU devices).

Every case of tests/test_parallel.py runs on both packages: the mesh
shapes for 1, 2, 3, 4, 6 and 8 devices, the sharded replay-commit step
against the local one, a corrupted record, placement, and the sharded
data-plane step against ``data_plane_step`` and against the JAX
package's sharded step.  A seeded random walk covers the mesh shapes
(1, 1), (2, 1), (4, 2) and (8, 1) with rows shorter and longer than one
byte-block.  ``MultiRaft.shard`` and ``DistMember.shard`` run the
scenarios of tests/test_torch_multiraft.py and tests/test_torch_distmember.py
(drops included) against the unsharded port engine and the sharded JAX
engine, held equal after every call; the views' host reads do not grow
with the block count.  Tolerance: exact (CRC states, link verdicts and
every GroupState field compared as numpy arrays of the reference dtype).
"""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from etcd_tpu.parallel import mesh as jmesh
from etcd_tpu.raft.batched import init_groups as j_init_groups
from etcd_tpu.raft.distmember import DistMember as JDistMember
from etcd_tpu.raft.multiraft import MultiRaft as JMultiRaft

from etcd_tpu_torch.entry import dryrun_multichip, example_args
from etcd_tpu_torch.obs.devledger import ledger
from etcd_tpu_torch.ops.crc_device import u32_numpy
from etcd_tpu_torch.parallel import (
    GroupMesh,
    check_group_divisible,
    data_plane_step,
    group_mesh,
    leading_placer,
    local_devices,
    make_replay_commit_step,
    make_sharded_step,
    place_step_inputs,
    replay_commit_local,
    shard_grid,
    shard_leading,
)
from etcd_tpu_torch.raft.distmember import DistMember as TDistMember
from etcd_tpu_torch.raft.multiraft import MultiRaft as TMultiRaft

import test_parallel as ref_cases
import test_torch_distmember as tdm_cases
import test_torch_multiraft as tmr_cases

CPU = local_devices("cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _cat(blocks):
    return torch.cat(list(blocks))


def _meshes(ng: int, ns: int):
    """The same (g, s) mesh in both packages."""
    jm = Mesh(np.asarray(jax.devices()[:ng * ns]).reshape(ng, ns),
              ("g", "s"))
    tm = GroupMesh([CPU[i * ns:(i + 1) * ns] for i in range(ng)])
    return jm, tm


def _groups_t(groups):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in groups)


# -- mesh shape, placement ----------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_mesh_shape(n):
    assert group_mesh(n, devices=CPU).shape == dict(jmesh.group_mesh(n).shape)
    assert group_mesh(n, devices=CPU).size == n


def test_mesh_errors_and_defaults():
    assert group_mesh(devices=CPU).shape == {"g": 4, "s": 2}
    assert len(local_devices("cpu")) == 8 == len(jax.devices())
    for n in (0, -1):
        with pytest.raises(ValueError, match="must be positive"):
            group_mesh(n, devices=CPU)
    with pytest.raises(ValueError, match="9 mesh devices requested but "
                       "only 8 available"):
        group_mesh(9, devices=CPU)
    mesh = group_mesh(8, devices=CPU)
    for g in (6, 10):
        with pytest.raises(ValueError) as te:
            check_group_divisible(mesh, g)
        with pytest.raises(ValueError) as je:
            jmesh.check_group_divisible(jmesh.group_mesh(8), g)
        assert str(te.value) == str(je.value)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            group_mesh(1)
    with pytest.raises(ValueError, match="split"):
        shard_leading(mesh, np.zeros((6, 2)))
    with pytest.raises(ValueError, match="split"):
        shard_grid(mesh, np.zeros((8, 5), np.uint8))


def test_shard_leading_placement():
    mesh = group_mesh(8, devices=CPU)
    x = np.arange(32, dtype=np.int32).reshape(8, 4)
    blocks = shard_leading(mesh, x)
    assert len(blocks) == mesh.shape["g"]
    assert all(b.is_contiguous() and b.shape == (2, 4) for b in blocks)
    np.testing.assert_array_equal(_np(_cat(blocks)), x)
    # copies: writing a block leaves the caller's tensor alone
    t = torch.from_numpy(x.copy())
    blocks = shard_leading(mesh, t)
    blocks[0][0, 0] = 99
    assert int(t[0, 0]) == 0
    grid = shard_grid(mesh, np.arange(64, dtype=np.uint8).reshape(8, 8))
    assert [len(r) for r in grid] == [2] * 4
    assert all(b.is_contiguous() and b.shape == (2, 4)
               for r in grid for b in r)
    put = leading_placer(mesh)
    assert [b.dtype for b in put([1, 2, 3, 4], np.int32)] == [torch.int32] * 4
    assert put(np.int32(3)).shape == ()


def test_dryrun_multichip_on_cpu_shards():
    for n in (1, 2, 3, 4, 6, 8):
        dryrun_multichip(n, device="cpu")


# -- the sharded steps against the local ones and the JAX package's ---------

def test_sharded_matches_local():
    rng = np.random.default_rng(7)
    n, max_len = 16, 24
    g, m, cap = 8, 5, 16
    buf, lens, stored, seed = ref_cases._mk_records(n, max_len, rng)
    groups = ref_cases._mk_groups(g, m, cap, rng)
    buf_t, lens_t = torch.from_numpy(buf), torch.from_numpy(lens)
    stored_t = torch.from_numpy(stored.astype(np.int64))
    ok_local, committed_local = replay_commit_local(
        buf_t, lens_t, stored_t, seed, *_groups_t(groups))
    assert bool(ok_local.all())
    mesh = group_mesh(8, devices=CPU)
    ok_sh, committed_sh = make_replay_commit_step(mesh)(
        shard_grid(mesh, buf), shard_leading(mesh, lens_t),
        shard_leading(mesh, stored_t), seed,
        *(shard_leading(mesh, x) for x in groups))
    ok_j, committed_j = jmesh.make_replay_commit_step(jmesh.group_mesh(8))(
        buf, lens, stored, seed, *groups)
    np.testing.assert_array_equal(_np(_cat(ok_sh)), _np(ok_local))
    np.testing.assert_array_equal(_np(_cat(ok_sh)), np.asarray(ok_j))
    np.testing.assert_array_equal(_np(committed_sh), _np(committed_local))
    np.testing.assert_array_equal(_np(committed_sh), np.asarray(committed_j))
    assert _np(committed_sh).dtype == np.asarray(committed_j).dtype


def test_sharded_detects_corruption():
    rng = np.random.default_rng(8)
    n, max_len = 16, 24
    buf, lens, stored, seed = ref_cases._mk_records(n, max_len, rng)
    groups = ref_cases._mk_groups(8, 3, 16, rng)
    buf = buf.copy()
    buf[5, max_len - 1] ^= 0xFF
    mesh = group_mesh(8, devices=CPU)
    ok, _ = make_replay_commit_step(mesh)(
        shard_grid(mesh, buf), shard_leading(mesh, lens),
        shard_leading(mesh, stored.astype(np.int64)), seed,
        *(shard_leading(mesh, x) for x in groups))
    ok = _np(_cat(ok))
    assert not ok[5]
    assert ok[[i for i in range(16) if i != 5]].all()


def _jax_state(state):
    base = j_init_groups(state.term.shape[0], state.match.shape[1],
                         state.log_term.shape[1])
    return base._replace(**{f: jnp.asarray(_np(getattr(state, f)))
                            for f in state._fields})


def _three_steps(args, jm, tm):
    """The port's unsharded and sharded steps and the JAX package's
    sharded step on the same inputs, held equal."""
    (buf, lens, stored, seed, state, *raft) = args
    local = data_plane_step(*args)
    sh = make_sharded_step(tm)(*place_step_inputs(tm, args))
    ref = jmesh.make_sharded_step(jm)(
        _np(buf), _np(lens), u32_numpy(stored), np.uint32(seed),
        _jax_state(state), *(_np(x) for x in raft))
    links, st, err, ncomm, commit_all = sh
    for name, a, b, c in (("links", links, local[0], ref[0]),
                          ("err", err, local[2], ref[2]),
                          ("ncomm", ncomm, local[3], ref[3])):
        np.testing.assert_array_equal(_np(_cat(a)), _np(b), err_msg=name)
        np.testing.assert_array_equal(_np(_cat(a)), np.asarray(c),
                                      err_msg=name)
    for f, a, b, c in zip(st._fields, st, local[1], ref[1]):
        np.testing.assert_array_equal(_np(_cat(a)), _np(b), err_msg=f)
        np.testing.assert_array_equal(_np(_cat(a)), np.asarray(c),
                                      err_msg=f)
        assert _np(_cat(a)).dtype == np.asarray(c).dtype, f
    np.testing.assert_array_equal(_np(commit_all), _np(local[1].commit))
    np.testing.assert_array_equal(_np(commit_all), np.asarray(ref[4]))
    return _np(_cat(links))


def test_sharded_data_plane_step_matches_local():
    jm, tm = _meshes(4, 2)
    links = _three_steps(example_args(n=16, max_len=24, g=8, m=3, cap=16,
                                      device="cpu"), jm, tm)
    assert links.all()


def _walk_args(rng, n, width, g, m, cap, corrupt):
    """``example_args``-shaped inputs with random record lengths (some
    shorter, some longer than one byte-block), random group state and
    responses, and optionally one flipped data byte."""
    args = list(example_args(n=n, max_len=width, g=g, m=m, cap=cap,
                             seed_val=int(rng.integers(0, 2**32)),
                             device="cpu"))
    if corrupt:
        row = int(rng.integers(0, n))
        col = width - 1 - int(rng.integers(0, int(args[1][row])))
        args[0][row, col] ^= 0x40
    st = args[4]
    args[4] = st._replace(
        term=torch.from_numpy(rng.integers(1, 4, g).astype(np.int32)),
        commit=torch.zeros(g, dtype=torch.int32))
    args[5] = torch.from_numpy(rng.integers(0, 3, g).astype(np.int32))
    args[7] = torch.from_numpy(rng.integers(0, m, (g, 2)).astype(np.int32))
    args[8] = torch.from_numpy(rng.integers(0, 4, (g, 2)).astype(np.int32))
    args[9] = torch.from_numpy(rng.random((g, 2)) < 0.7)
    return tuple(args)


@pytest.mark.parametrize("ng,ns", [(1, 1), (2, 1), (4, 2), (8, 1)])
def test_random_walk_over_mesh_shapes(ng, ns):
    """Seeded steps on each mesh shape: widths where a byte-block is
    shorter than most records and where it is longer, N a multiple of g,
    one step with a corrupted byte; all three steps equal."""
    rng = np.random.default_rng(1000 + 10 * ng + ns)
    jm, tm = _meshes(ng, ns)
    flagged = 0
    for k, width in enumerate((8 * ns, 40 * ns, 2 * ns + 2 * (ns - 1))):
        n = ng * int(rng.integers(1, 5))
        links = _three_steps(_walk_args(rng, n, width, 2 * ng, 3, 16,
                                        corrupt=k == 1), jm, tm)
        flagged += int((~links).sum())
    assert flagged == 1


# -- the sharded engines ---------------------------------------------------

_JM, _TM = _meshes(4, 2)


class ShardedMultiRaft(tmr_cases.Pair):
    """The JAX engine sharded over its (4, 2) mesh, the port's sharded
    over the same shape of virtual CPU devices (``t``), and the port's
    unsharded (``u``), driven in lockstep."""

    def __init__(self, **kw):
        self.j = JMultiRaft(**kw)
        self.j.shard(_JM)
        self.t = TMultiRaft(**kw, device="cpu")
        self.t.shard(_TM)
        self.u = TMultiRaft(**kw, device="cpu")
        self.calls = 0
        self.check()

    def __getattr__(self, name):
        fj, ft, fu = (getattr(x, name) for x in (self.j, self.t, self.u))
        if not callable(fj):
            return fj

        def all3(*args, **kw):
            rj, rt, ru = fj(*args, **kw), ft(*args, **kw), fu(*args, **kw)
            self.calls += 1
            for r in (rt, ru):
                if rj is None:
                    assert r is None, name
                else:
                    np.testing.assert_array_equal(_np(r), _np(rj),
                                                  err_msg=name)
            self.check(name)
            return rj
        return all3

    def force_general(self) -> None:
        for mr in (self.j, self.t, self.u):
            mr._recompute_hot = lambda: None
            mr._route_hot = None

    def mutate(self, slot: int, **fields) -> None:
        sj = list(self.j.states)
        sj[slot] = sj[slot]._replace(
            **{k: jnp.asarray(v) for k, v in fields.items()})
        self.j.states = sj
        self.j.shard(_JM)
        for mr in (self.t, self.u):
            sts = list(mr.states)
            sts[slot] = sts[slot]._replace(
                **{k: torch.as_tensor(np.asarray(v))
                   for k, v in fields.items()})
            mr.states = sts
        self.check("mutate")

    def check(self, after: str = "init") -> None:
        assert len(self.t._blocks) == _TM.shape["g"], after
        saved = self.t
        try:
            for other in (self.u, saved):
                self.t = other
                super().check(after)
        finally:
            self.t = saved


@pytest.mark.parametrize("name", sorted(tmr_cases.SCENARIOS))
def test_sharded_multiraft_scenarios(name, monkeypatch):
    monkeypatch.setattr(tmr_cases, "Pair", ShardedMultiRaft)
    mr = tmr_cases.SCENARIOS[name]()
    assert isinstance(mr, ShardedMultiRaft) and mr.calls > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_sharded_multiraft_random_walk(seed, monkeypatch):
    monkeypatch.setattr(tmr_cases, "Pair", ShardedMultiRaft)
    tmr_cases.test_random_walk_equal(seed)


class ShardedMember(tdm_cases.PairMember):
    """Member ``slot`` as the JAX engine sharded over its mesh, the
    port's sharded (``t``) and unsharded (``u``); frames cross as in
    ``PairMember`` (each side parses its own package's bytes)."""

    def __init__(self, g, m, slot, cap, **kw):
        self.mesh = (_JM, _TM) if g % 4 == 0 else _meshes(2, 1)
        self.j = JDistMember(g, m, slot, cap, **kw)
        self.j.shard(self.mesh[0])
        self.t = TDistMember(g, m, slot, cap, **kw, device="cpu")
        self.t.shard(self.mesh[1])
        self.u = TDistMember(g, m, slot, cap, **kw, device="cpu")
        self.g, self.slot = g, slot
        self.calls = 0
        self.check()

    def __getattr__(self, name):
        fj, ft, fu = (getattr(x, name) for x in (self.j, self.t, self.u))
        if not callable(fj):
            tdm_cases.same(fj, ft, name)
            tdm_cases.same(fj, fu, name)
            return fj

        def all3(*args, **kw):
            rj = fj(*tdm_cases._side(args, "j"), **tdm_cases._side(kw, "j"))
            rt = ft(*tdm_cases._side(args, "t"), **tdm_cases._side(kw, "t"))
            ru = fu(*tdm_cases._side(args, "t"), **tdm_cases._side(kw, "t"))
            self.calls += 1
            tdm_cases.same(rj, rt, name)
            tdm_cases.same(rj, ru, name)
            self.check(name)
            if hasattr(rj, "marshal") or isinstance(rj, tuple):
                return tdm_cases.Dual(rj, rt)
            return rj
        return all3

    def mutate(self, **fields) -> None:
        self.j.state = self.j.state._replace(
            **{k: jnp.asarray(v) for k, v in fields.items()})
        self.j.shard(self.mesh[0])
        for x in (self.t, self.u):
            x.state = x.state._replace(
                **{k: torch.as_tensor(np.asarray(v))
                   for k, v in fields.items()})
        self.check("mutate")

    def check(self, after: str = "init") -> None:
        assert len(self.t._blocks) == self.mesh[1].shape["g"], after
        saved = self.t
        try:
            for other in (self.u, saved):
                self.t = other
                super().check(after)
        finally:
            self.t = saved


#: the scenario tests of tests/test_torch_distmember.py that build their
#: members through ``PairMember`` / ``make_cluster`` (a G that 4 does not
#: divide runs on a (2, 1) mesh)
DIST_SCENARIOS = {
    name: fn for name, fn in vars(tdm_cases).items()
    if name.startswith("test_") and not name.startswith("test_port_")
    and name not in ("test_frame_roundtrip",
                     "test_timeout_bands_are_disjoint_across_slots",
                     "test_randomized_lossy_exchange_log_matching")}


@pytest.mark.parametrize("name", sorted(DIST_SCENARIOS))
def test_sharded_distmember_scenarios(name, monkeypatch):
    monkeypatch.setattr(tdm_cases, "PairMember", ShardedMember)
    fn = DIST_SCENARIOS[name]
    assert not inspect.signature(fn).parameters, name
    fn()


def test_sharded_distmember_lossy_walk(monkeypatch):
    monkeypatch.setattr(tdm_cases, "PairMember", ShardedMember)
    tdm_cases.test_randomized_lossy_exchange_log_matching(1234, 3, 60)


def test_host_reads_do_not_grow_with_blocks():
    """The same calls on a sharded and an unsharded engine cost the same
    counted host reads, stage by stage."""
    def reads(shard: bool) -> dict:
        before = ledger.snapshot()
        mr = TMultiRaft(g=16, m=3, cap=32, device="cpu")
        dm = TDistMember(16, 3, 0, 32, device="cpu")
        if shard:
            mr.shard(_TM)
            dm.shard(_TM)
        mr.campaign(0)
        mr.propose(np.ones(16, np.int32), data=[[b"x"]] * 16)
        mr.propose_rounds(np.ones(16, np.int32), 3)
        mr.tick()
        mr.mark_applied(mr.commit_index())
        mr.compact()
        mr.max_terms()
        mr.log_terms(1)
        dm.begin_campaign(np.ones(16, bool))
        dm.tally(np.ones(16, bool), [])
        dm.propose(np.ones(16, np.int32))
        dm.build_append(1)
        dm.is_leader(), dm.commit_terms(), dm.terms_at(np.ones(16))
        dm.tick()
        dm.compact()
        after = ledger.snapshot()
        return {k: v["fetches"] - before.get(k, {}).get("fetches", 0)
                for k, v in after.items()}

    one, four = reads(False), reads(True)
    assert sum(one.values()) > 20
    assert one == four
