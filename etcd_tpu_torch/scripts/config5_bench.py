"""Config 5 (BASELINE configs[4]): G raft groups split over a device mesh,
the port of ``scripts/config5_bench.py``.

One card holds the whole mesh here: ``n_devices`` virtual shards of one
device (``group_mesh(n, devices=[dev] * n)``), the counterpart of the
virtual CPU devices the reference measures on.  The numbers are those
of the g x s decomposition on one card, not of n cards.

Phases, each a function that ``chip_smoke.py`` (their only driver) calls
and holds, and that the tests run on the CPU at a small size:

- :func:`main`: the reference's two parts and JSON keys.  The sharded
  step (``parallel.make_sharded_step``) at G groups x 5 members, cap 32,
  on ``8 g`` records of ``8 s`` bytes (first call, then ``iters`` timed
  calls); then the serving form, :func:`serving` on the mesh.
- :func:`serving`: ``MultiRaft(g, m=5, cap=32, max_batch_ents=4)``,
  ``shard`` (or not, for ``mesh=None``), ``campaign(0)``, then trains of
  ``propose_rounds(ones, 4)`` with ``mark_applied`` + ``compact``
  between them: ms a round, commits/s, host reads a round (devledger
  fetches) and, on CUDA, kernel launches a round (``torch.profiler``);
  the final states, so that a sharded and an unsharded run compare.
- :func:`served`: ``MultiGroupServer(mesh=...)`` serving PUTs from
  client threads, stopped, restarted on its data dir with
  ``storage_backend="tpu"`` (re-sharded, replaying the WAL through the
  raw-CRC kernel on CUDA) and every key read back.
- :func:`dist_engine`: three ``DistMember`` slots on the mesh and three
  unsharded, driven with the same frame exchange (elections, proposals
  with payloads, a dropped peer, compaction, ticks, a second leader) and
  held equal field for field, frame for frame, after every call.
"""

from __future__ import annotations

import shutil
import tempfile
import time

import numpy as np
import torch

from .. import default_device
from ..entry import example_args
from ..obs.devledger import ledger
from ..ops import crc_cuda
from ..parallel import group_mesh, make_sharded_step, place_step_inputs
from ..raft.batched import GroupState
from ..raft.distmember import DistMember
from ..raft.multiraft import MultiRaft
from ..server.multigroup import MultiGroupServer
from ..wire.requests import Request
from . import cohosted_bench as cb


def virtual_mesh(n_devices: int, device=None):
    """``n_devices`` virtual shards of one device as a ``(g, s)`` mesh."""
    dev = default_device(device)
    return group_mesh(n_devices, devices=[dev] * n_devices)


def _fetches() -> int:
    return sum(v["fetches"] for v in ledger.snapshot().values())


def serving(g: int, mesh=None, trains: int = 4, train: int = 4,
            device=None) -> dict:
    """The serving form of config 5 (module docstring).  Raises if a
    train commits other than ``train`` entries per group."""
    dev = mesh.home if mesh is not None else default_device(device)
    mr = MultiRaft(g=g, m=5, cap=32, max_batch_ents=4, device=dev)
    if mesh is not None:
        mr.shard(mesh)
    mr.campaign(0)
    one = np.ones(g, np.int32)

    def run_train() -> float:
        """One train (its seconds), then the compaction between trains,
        outside the timed region as in the reference."""
        t0 = time.perf_counter()
        newly = mr.propose_rounds(one, train)
        secs = time.perf_counter() - t0
        if int(newly.sum()) != g * train:
            raise RuntimeError(f"config5 serving: a train committed "
                               f"{int(newly.sum())}, not {g * train}")
        mr.mark_applied(mr.commit_index())
        mr.compact()
        return secs

    run_train()  # warm-up, as the reference's compile train
    f0 = _fetches()
    times = [run_train() for _ in range(trains)]
    reads = (_fetches() - f0) / (trains * train)
    prof = None
    if dev.type == "cuda":
        prof = cb.profile_calls(run_train, 1, dev)
        prof["launches_per_round"] = prof["launches_per_call"] / train
    round_s = sum(times) / len(times) / train
    return {"g": g, "blocks": len(mr._blocks), "round_ms": round_s * 1e3,
            "commits_per_s": g / round_s, "reads_per_round": reads,
            "profile": prof, "states": cb._states(mr),
            "leader": mr.leader.copy(), "commit": mr.commit_index()}


def main(groups: int = 100_000, iters: int = 8, n_devices: int = 8,
         device=None) -> dict:
    """The reference's ``config5_bench.main`` on ``n_devices`` virtual
    shards of one device: its JSON keys, numbers unrounded
    (``first_call_s`` stands where the reference has ``compile_s``)."""
    dev = default_device(device)
    mesh = virtual_mesh(n_devices, dev)
    ng, ns = mesh.shape["g"], mesh.shape["s"]
    g = max(1, groups // ng) * ng
    args = place_step_inputs(mesh, example_args(
        n=8 * ng, max_len=8 * ns, g=g, m=5, cap=32, device=dev))
    step = make_sharded_step(mesh)

    def once():
        out = step(*args)
        cb._sync(dev)
        return out

    t0 = time.perf_counter()
    out = once()
    first_s = time.perf_counter() - t0
    if not all(bool((x == 2).all()) for x in out[3]):
        raise RuntimeError("config5: commit stalled")
    t0 = time.perf_counter()
    for _ in range(iters):
        once()
    dt = (time.perf_counter() - t0) / iters
    sv = serving(g, mesh, trains=max(2, iters // 2))
    distinct = len(mesh.distinct_devices())
    return {
        "groups": g, "members": 5,
        "mesh": f"{ng}x{ns} ({n_devices} virtual shards of {distinct} "
                f"{dev.type} device{'s' if distinct > 1 else ''})",
        "backend": f"virtual-{dev.type}-mesh/{distinct}",
        "step_ms": dt * 1e3, "first_call_s": first_s,
        "group_commits_per_sec": 2 * g / dt,
        "serving_sharded_round_ms": sv["round_ms"],
        "serving_sharded_commits_per_sec": sv["commits_per_s"],
        "serving_reads_per_round": sv["reads_per_round"],
        "serving_launches_per_round": (sv["profile"] or {}).get(
            "launches_per_round"),
        "serving": sv}


# -- the sharded co-hosted server ---------------------------------------------

def served(g: int, mesh, puts: int = 400, threads: int = 8, m: int = 5,
           cap: int = 1024, timeout: float = 120.0) -> dict:
    """``MultiGroupServer(g, m, mesh=mesh)`` serves ``puts`` PUTs from
    ``threads`` threads, stops, restarts on its data dir with
    ``storage_backend="tpu"`` and reads every key back.  Raises on a
    failed write or read, and where the restarted engine is not split
    over the mesh."""
    dev = mesh.home
    d = tempfile.mkdtemp(prefix="config5_served_")
    try:
        s = MultiGroupServer(d, g=g, m=m, cap=cap, mesh=mesh, device=dev)
        s.start()
        keys = [f"/c5ns{i}/k" for i in range(puts)]
        try:
            wall, lats = cb._load(s, keys, threads, timeout)
        finally:
            s.stop()
        cb._sync(dev)
        cb.reset_launches()
        t0 = time.perf_counter()
        s2 = MultiGroupServer(d, g=g, m=m, cap=cap, mesh=mesh,
                              storage_backend="tpu", device=dev)
        cb._sync(dev)
        restart_s = time.perf_counter() - t0
        launches = crc_cuda.raw_crc_cuda.launches
        try:
            blocks = len(s2.mr._blocks)
            if blocks != mesh.shape["g"]:
                raise RuntimeError(f"served: the restarted engine holds "
                                   f"{blocks} blocks, not "
                                   f"{mesh.shape['g']}")
            for k in keys:
                ev = s2.do(Request(id=1 + len(k), method="GET",
                                   path=k)).event
                if ev.node.value != k:
                    raise RuntimeError(f"served: {k} read back "
                                       f"{ev.node.value!r}")
        finally:
            s2.stop()
        lats.sort()
        return {"g": g, "puts": puts, "threads": threads, "load_s": wall,
                "acked_writes_per_s": puts / wall,
                "p50_ms": lats[len(lats) // 2], "max_ms": lats[-1],
                "restart_s": restart_s, "restart_launches": launches,
                "blocks": blocks, "read_back": len(keys)}
    finally:
        shutil.rmtree(d, ignore_errors=True)


# -- the sharded dist engine --------------------------------------------------

def _same_member(a: DistMember, b: DistMember, what: str) -> None:
    sa, sb = a.state, b.state
    for f in GroupState._fields:
        x, y = getattr(sa, f), getattr(sb, f)
        if x.dtype != y.dtype or not torch.equal(x.to(y.device), y):
            raise RuntimeError(f"dist_engine: after {what}: slot "
                               f"{a.slot} field {f} differs")
    if a.payloads != b.payloads:
        raise RuntimeError(f"dist_engine: after {what}: payloads differ")
    for k in ("overflow", "conflict"):
        if not np.array_equal(a.errors[k], b.errors[k]):
            raise RuntimeError(f"dist_engine: after {what}: errors[{k}]")


def _same(x, y, what: str) -> None:
    if hasattr(x, "marshal"):
        ok = bytes(x.marshal()) == bytes(y.marshal())
    elif isinstance(x, tuple):
        ok = all(np.array_equal(a, b) for a, b in zip(x, y))
    else:
        ok = x is None and y is None or np.array_equal(x, y)
    if not ok:
        raise RuntimeError(f"dist_engine: {what} returned different "
                           f"results")


def dist_engine(g: int, mesh, m: int = 3, cap: int = 64,
                rounds: int = 6) -> dict:
    """Member slots 0..m-1 of ``g`` groups, sharded over ``mesh`` and
    unsharded, driven through the same calls (module docstring) and
    held equal after every one.  Returns the calls made and the host
    reads of each side."""
    dev = mesh.home
    sh = [DistMember(g, m, s, cap, device=dev) for s in range(m)]
    for x in sh:
        x.shard(mesh)
    ref = [DistMember(g, m, s, cap, device=dev) for s in range(m)]
    calls = {"n": 0}
    reads = {"sharded": 0, "unsharded": 0}

    def both(slot, name, *args, **kw):
        f0 = _fetches()
        ra = getattr(sh[slot], name)(*args, **kw)
        f1 = _fetches()
        rb = getattr(ref[slot], name)(*args, **kw)
        reads["sharded"] += f1 - f0
        reads["unsharded"] += _fetches() - f1
        calls["n"] += 1
        _same(ra, rb, name)
        _same_member(sh[slot], ref[slot], name)
        return ra, rb

    def elect(slot, mask=None):
        mask = np.ones(g, bool) if mask is None else mask
        req, _ = both(slot, "begin_campaign", mask)
        votes = [both(p, "handle_vote", req)[0]
                 for p in range(m) if p != slot]
        won, _ = both(slot, "tally", req.active, votes)
        return won

    def replicate(lead, drop=()):
        for peer in range(m):
            if peer == lead or peer in drop:
                continue
            b, _ = both(lead, "build_append", peer)
            if b is None:
                continue
            resp, _ = both(peer, "handle_append", b)
            both(lead, "handle_append_resp", resp)

    if not elect(0).all():
        raise RuntimeError("dist_engine: the bootstrap election lost "
                           "groups")
    both(0, "propose", np.ones(g, np.int32), data=[[b""]] * g)
    for r in range(rounds):
        n = (np.arange(g) + r) % 3
        both(0, "propose", n.astype(np.int32),
             data=[[bytes([r, j]) for j in range(int(n[gi]))]
                   for gi in range(g)])
        replicate(0, drop={2} if r % 3 == 1 else ())
    for s in range(m):
        both(s, "mark_applied", ref[s].commit_index())
        both(s, "compact")
        both(s, "tick")
    won = elect(1, np.arange(g) % 2 == 0)
    both(1, "propose", won.astype(np.int32),
         data=[[b"L"] if won[gi] else [] for gi in range(g)])
    replicate(1)
    replicate(1)
    commit = ref[1].commit_index()
    if not (commit[won] > 0).all():
        raise RuntimeError("dist_engine: the second leader's lanes did "
                           "not commit")
    return {"g": g, "m": m, "blocks": len(sh[0]._blocks),
            "calls": calls["n"], "reads": reads}
