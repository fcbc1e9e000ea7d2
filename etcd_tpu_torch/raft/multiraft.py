"""Co-hosted multi-raft runtime: G groups x M members, batched.

The port of ``etcd_tpu/raft/multiraft.py``.  Member ``m`` of *every*
group lives in one ``GroupState`` batch (tensors [G]), so a full
M-member cluster of G co-hosted groups is M state tuples, and "message
delivery" between co-hosted members is tensor exchange: no
serialization, no sockets.

The hot path (propose -> replicate -> respond -> commit) is one call of
plain torch ops per round (:func:`_fused_round`): all M^2 member-pair
exchanges and the quorum commit run on the card and the host syncs once
per round, for the commit delta and the payload keying.  The reference
jit-compiles the same body into one XLA program; here each op is its
own launch, so a 5-member round is about 900 launches (PERF.md §5
has the count and what it costs).  Elections are
batched too, decomposed into droppable vote-request / vote-response
phases sharing the per-edge fault mask machinery of replication.

Error lanes are per-group: an overflowing or conflicted group stalls
alone (its lanes surface in :attr:`MultiRaft.errors`) while the rest of
the batch keeps committing.

Payload bytes stay host-side (a per-group dict keyed by log index): the
card owns index/term/commit math, the host owns opaque blobs.

:meth:`MultiRaft.shard` splits the groups over a device mesh's ``g``
axis.  Torch has no SPMD program for one process to run across devices,
so the engine holds its state as g-blocks and runs every fused round,
campaign, tick, compaction and conf change once per block, on that
block's device (an unsharded engine is one block); host inputs are
split by block and host reads gather the blocks first, so a round's
host reads do not grow with the block count while its launches do.

Two translations differ in form from the reference, not in result:

- The snapshot install of a lagging follower runs under
  ``jax.lax.cond(needs_snap.any(), ...)`` in the reference.  A Python
  ``if`` on a CUDA tensor would sync the host once per (leader, peer)
  pair per round, so the install is evaluated every round, masked:
  every write in it is masked by ``needs_snap`` or by the lanes that
  installed, so a round where no lane needs a snapshot leaves the state
  as the skipped branch would (given the engine's invariant that
  ``nmembers`` counts ``members``).  The tests hold it equal to the
  reference's branch.
- ``jax.lax.fori_loop`` over rounds becomes a Python loop whose carries
  (the commit total and the error lanes) stay on the card; only the
  commit total is read back, once, at the end of the train.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import default_device
from ..obs.devledger import ledger as _ledger
from ..parallel.mesh import BlockLayout
from .batched import (
    CANDIDATE,
    FOLLOWER,
    LEADER,
    GroupState,
    apply_conf_change as conf_change_batch,
    compact as compact_batch,
    grant_vote,
    init_groups,
    leader_append,
    maybe_append,
    maybe_commit,
    progress_repair,
    progress_update,
    restore_snapshot,
    term_at,
    tick as tick_batch,
)


def _drop_dense(drop, m: int, g: int) -> np.ndarray:
    """Per-edge fault dict {(a, b): [G] bool} -> dense [M, M, G]."""
    dense = np.zeros((m, m, g), bool)
    for (a, b), mask in (drop or {}).items():
        dense[a, b] |= np.asarray(mask, bool)
    return dense


def _full(g: int, v: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full((g,), v, dtype=torch.int32, device=like.device)


def _install_snapshot(lst: GroupState, pst: GroupState, nxt, needs_snap,
                      drop, slot: int, peer: int):
    """Leader ``slot`` sends its snapshot to ``peer`` in the lanes of
    ``needs_snap`` (raft.go:207-209, needSnapshot :556): the follower's
    log collapses to the leader's offset entry and normal appends
    resume.  Returns ``(pst', nxt', lst')``; lanes outside
    ``needs_snap`` come back unchanged."""
    g = nxt.shape[0]
    peer_v = _full(g, peer, nxt)
    snap_term = term_at(lst.log_term, lst.offset, lst.last, lst.offset)
    follower_commit = pst.commit
    pst, installed = restore_snapshot(
        pst, lst.offset, snap_term,
        commit=torch.minimum(lst.commit, lst.offset),
        active=needs_snap, members=lst.members)
    # installed lanes ack the snapshot index; lanes that rejected
    # (commit already past it) reply with their commit, repairing the
    # leader's stale next_ without any truncation (raft.go:419-424).
    # Both acks ride the response edge, droppable like any msgAppResp.
    snap_ack = ~drop[peer, slot]
    upd = progress_update(lst, peer_v, lst.offset,
                          active=installed & snap_ack)
    rejected = needs_snap & ~installed
    upd = progress_update(upd, peer_v, follower_commit,
                          active=rejected & snap_ack)
    nxt = torch.where(
        installed & snap_ack, lst.offset + 1,
        torch.where(rejected & snap_ack, follower_commit + 1, nxt))
    return pst, nxt, lst._replace(next_=upd.next_, match=upd.match)


def _round_core(states, sels, n_new, drop, e: int, slots):
    """The propose->replicate->respond->commit round body, parametric in
    which member slots participate as leaders.

    ``sels[i]``: [G] bool router mask for ``slots[i]`` (which groups
    address that slot as leader).  The general round passes every slot;
    the hot-slot specialization passes exactly one, which runs 1/M of
    the append work and (M-1) of the M(M-1) pair exchanges and is
    exactly equivalent whenever the router addresses a single slot (a
    slot with an all-False ``sel`` contributes nothing: every
    send/append/response in its pair iterations is masked by ``sel``,
    and ``maybe_commit`` on a non-addressed state is a fixed point).
    """
    states = list(states)
    m = len(states)
    g = n_new.shape[0]
    dev = n_new.device

    commits0 = states[0].commit
    for st in states[1:]:
        commits0 = torch.maximum(commits0, st.commit)

    valid = torch.zeros((g,), dtype=torch.bool, device=dev)
    base = torch.zeros((g,), dtype=torch.int32, device=dev)
    overflow = torch.zeros((g,), dtype=torch.bool, device=dev)
    conflict = torch.zeros((g,), dtype=torch.bool, device=dev)

    # -- leader appends (raft.go:279-286), masked per slot -------------
    for sel, slot in zip(sels, slots):
        st = states[slot]
        is_lead = sel & (st.role == LEADER)
        valid = valid | is_lead
        base = torch.where(is_lead, st.last, base)
        st, err = leader_append(st, torch.where(sel, n_new, 0),
                                _full(g, slot, n_new), active=sel)
        overflow = overflow | err
        states[slot] = st
    # groups whose append was refused (overflow) must not key host
    # payloads: their log never advanced past base
    valid = valid & ~overflow

    ent_off = torch.arange(e, dtype=torch.int32, device=dev)
    # -- replication: leaders send, followers respond, quorum commits --
    for sel, slot in zip(sels, slots):
        lst = states[slot]
        for peer in range(m):
            if peer == slot:
                continue
            pst = states[peer]
            # window: follower's next.. min(next+E-1, leader last)
            nxt = lst.next_[:, peer]
            # followers at a lower term adopt the leader's
            # (raft.go:388-396); stale leaders don't send; removed /
            # not-yet-added slots are masked edges on both ends
            send = sel & (lst.term >= pst.term) & \
                (lst.role == LEADER) & ~drop[slot, peer] & \
                lst.members[:, slot] & lst.members[:, peer]
            adopt = send & (lst.term > pst.term)
            pst = pst._replace(
                term=torch.where(adopt, lst.term, pst.term),
                vote=torch.where(adopt, -1, pst.vote),
                role=torch.where(send, FOLLOWER, pst.role),
                lead=torch.where(send, slot, pst.lead))
            # slow follower fell behind the leader's compaction point:
            # send a snapshot instead (module docstring: masked, not
            # branched)
            needs_snap = send & (nxt <= lst.offset) & (lst.offset > 0)
            pst, nxt, lst = _install_snapshot(
                lst, pst, nxt, needs_snap, drop, slot, peer)

            prev_idx = nxt - 1
            prev_term = term_at(lst.log_term, lst.offset, lst.last,
                                prev_idx)
            n_send = torch.clamp(lst.last - prev_idx, 0, e)
            ent_idx = prev_idx[:, None] + 1 + ent_off
            ent_terms = term_at(lst.log_term, lst.offset, lst.last,
                                ent_idx)
            pst, ok, e_conf, e_over = maybe_append(
                pst, prev_idx, prev_term, ent_terms, n_send,
                lst.commit, active=send)
            conflict = conflict | e_conf
            overflow = overflow | e_over
            # any append from the legitimate leader resets the
            # follower's election timer
            pst = pst._replace(elapsed=torch.where(send, 0, pst.elapsed))
            states[peer] = pst
            # msgAppResp: success -> progress update; reject ->
            # progress_repair jumps next_ to the follower's commit+1
            resp_ok = send & ~drop[peer, slot]
            acked = prev_idx + n_send
            peer_v = _full(g, peer, n_new)
            lst = progress_update(lst, peer_v, acked, active=resp_ok & ok)
            lst = progress_repair(lst, peer_v, pst.commit,
                                  active=resp_ok & ~ok)
        lst = maybe_commit(lst)
        states[slot] = lst

    commits1 = states[0].commit
    for st in states[1:]:
        commits1 = torch.maximum(commits1, st.commit)
    return (tuple(states), commits1 - commits0, valid, base,
            overflow, conflict)


def _fused_round(states, leader, n_new, drop, e: int):
    """One full propose->replicate->respond->commit round on the card.

    ``states``: tuple of M GroupState; ``leader``: [G] i32 member slot
    per group (-1 none); ``n_new``: [G] i32 proposals to append at each
    group's leader; ``drop``: [M, M, G] bool per-edge fault mask
    (drop[a, b, g] kills a->b messages of group g).

    Returns ``(states', newly_committed, valid, base, overflow,
    conflict)``: valid/base key the host payload store (which groups
    had a real leader, and its pre-append last index); overflow /
    conflict are the per-group error lanes.
    """
    m = len(states)
    sels = [leader == s for s in range(m)]
    return _round_core(states, sels, n_new, drop, e, tuple(range(m)))


def _fused_round_hot(states, sel, n_new, drop, e: int, slot: int):
    """The single-addressed-slot round (serving steady state: every
    group routes to one member slot).  Runs 1/M of the append work and
    1/M of the pair exchanges; exactly equivalent to
    :func:`_fused_round` under that routing (see _round_core)."""
    return _round_core(states, [sel], n_new, drop, e, (slot,))


def _train(round_fn, states, n_new, k: int):
    """``k`` rounds of ``round_fn`` with the commit total and the error
    lanes carried on the card."""
    g = n_new.shape[0]
    dev = n_new.device
    total = torch.zeros((g,), dtype=torch.int32, device=dev)
    overflow = torch.zeros((g,), dtype=torch.bool, device=dev)
    conflict = torch.zeros((g,), dtype=torch.bool, device=dev)
    for _ in range(k):
        states, newly, _v, _b, o, c = round_fn(states)
        total = total + newly
        overflow = overflow | o
        conflict = conflict | c
    return states, total, overflow, conflict


def _fused_multi_round_hot(states, sel, n_new, drop, e: int, k: int,
                           slot: int):
    """``k`` hot-slot rounds in one call (propose_rounds')."""
    return _train(lambda st: _round_core(st, [sel], n_new, drop, e,
                                         (slot,)), states, n_new, k)


def _fused_multi_round(states, leader, n_new, drop, e: int, k: int):
    """``k`` consecutive rounds in one call, with a single commit-delta
    readback at the end (by the caller): payload-less callers
    (benchmarks, idle heartbeat trains, catch-up bursts) don't need
    the per-round keying arrays.

    Returns ``(states', newly_committed_total, overflow, conflict)``.
    """
    return _train(lambda st: _fused_round(st, leader, n_new, drop, e),
                  states, n_new, k)


def _fused_campaign(states, mask, drop, slot: int):
    """Batched campaign for member ``slot`` (raft.go:358-370).

    Vote requests and vote responses are separate droppable phases:
    ``drop[slot, peer]`` kills the request (peer never votes),
    ``drop[peer, slot]`` kills the response (peer's vote is RECORDED
    but the candidate never learns of it).

    Returns ``(states', won)``; quorum uses each group's live member
    count (nmembers), not the static member-slot count.
    """
    states = list(states)
    m = len(states)
    g = mask.shape[0]

    cand = states[slot]
    mj = mask & cand.members[:, slot]  # a non-member cannot campaign
    cand = cand._replace(
        term=cand.term + mj.to(torch.int32),
        role=torch.where(mj, CANDIDATE, cand.role),
        vote=torch.where(mj, slot, cand.vote))

    votes = mj.to(torch.int32)  # own vote
    cand_last = cand.last
    cand_lterm = term_at(cand.log_term, cand.offset, cand.last,
                         cand.last)
    slot_v = _full(g, slot, mask)
    for peer in range(m):
        if peer == slot:
            continue
        st = states[peer]
        req = mj & ~drop[slot, peer] & cand.members[:, peer]
        # msgVote carries the candidate term; peers at a lower term
        # adopt it and forget the deposed leader (raft.go:388-396)
        adopt = req & (cand.term > st.term)
        st = st._replace(
            term=torch.where(adopt, cand.term, st.term),
            vote=torch.where(adopt, -1, st.vote),
            role=torch.where(adopt, FOLLOWER, st.role),
            lead=torch.where(adopt, -1, st.lead))
        st, granted = grant_vote(st, cand_last, cand_lterm, cand.term,
                                 slot_v, active=req)
        # granting a vote resets the election timer
        st = st._replace(elapsed=torch.where(granted, 0, st.elapsed))
        states[peer] = st
        votes = votes + (granted & ~drop[peer, slot]).to(torch.int32)

    won = mj & (votes >= cand.nmembers // 2 + 1)
    # winners become leader; the reference appends an empty entry on
    # becoming leader (raft.go:329-348) so the new term has a
    # committable entry, replicated via the normal path
    cand = cand._replace(
        role=torch.where(won, LEADER, cand.role),
        lead=torch.where(won, slot, cand.lead),
        match=torch.where(won[:, None], 0, cand.match),
        next_=torch.where(won[:, None], cand.last[:, None] + 1,
                          cand.next_))
    states[slot] = cand
    return tuple(states), won


class MultiRaft:
    """G co-hosted groups, M members each, batched across groups, on
    ``default_device(device)`` (CUDA unless the caller passes
    ``device="cpu"``).

    :attr:`errors` holds the per-group error lanes, always as whole [G]
    bool tensors on the engine's device: ``overflow`` and ``conflict``
    of the most recent round, ``compact_oob`` of the most recent
    :meth:`compact`.  Consumers read them with ``.cpu().numpy()`` (or
    ``.any()``).  Overflowing groups stall (compact to resume) without
    blocking the batch; conflict lanes mark the reference's panic
    condition (append conflict below commit, log.go:57).

    The state is held as g-blocks (``_blocks[block][slot]``), one block
    until :meth:`shard` splits the groups over a mesh; every op runs
    once per block, on that block's device, and host reads gather the
    blocks first, so a round costs the same host reads at any block
    count.  :attr:`states` reads as M whole ``GroupState``s either way.

    At equal ``seed`` the engine draws the same randomized election
    timeouts as the reference's, so the two agree field for field.
    """

    def __init__(self, g: int, m: int, cap: int, election: int = 10,
                 max_batch_ents: int = 8, seed: int = 0,
                 live: int | None = None, device=None):
        self.device = default_device(device)
        self.g, self.m, self.cap = g, m, cap
        self.e = max_batch_ents
        self.mesh = None
        self._lay = BlockLayout(g, [self.device])
        rng = np.random.default_rng(seed)
        states = []
        for _ in range(m):
            st = init_groups(g, m, cap, election=election, live=live,
                             device=self.device)
            # randomized election timeouts (raft.go:611-617): each
            # member draws [election, 2*election) per group, on the
            # host and whole-G at any block count
            st = st._replace(timeout=self._put_g(
                rng.integers(election, 2 * election, size=g), np.int32))
            states.append(st)
        self._blocks: list[list[GroupState]] = [states]
        self.leader = np.full(g, -1, np.int32)  # member slot per group
        # cached single-addressed-slot routing (None = mixed): keyed
        # off self.leader, recomputed only where the routing changes
        # (campaign wins, conf-change removals); the round dispatch
        # picks the 1/M-work hot-slot program when it is set
        self._route_hot: int | None = None
        self._hot_sel = None  # cached per-block router masks
        # host-side payload store: per-group dict index -> bytes
        self.payloads: list[dict[int, bytes]] = [dict() for _ in range(g)]
        zb = torch.zeros((g,), dtype=torch.bool, device=self.device)
        self.errors = {"overflow": zb, "conflict": zb, "compact_oob": zb}
        # fault-free rounds reuse device-resident all-False masks
        self._no_drop = self._zero_drop()

    # -- the g-blocks ------------------------------------------------------

    @property
    def states(self):
        """The M member slots' ``GroupState``s.  Unsharded: the engine's
        own list (an item assigned is the engine's new state).
        Sharded: a tuple of whole states gathered onto the engine's
        device; assign the whole sequence to replace them, then call
        :meth:`shard` again, as in the reference."""
        if not self._lay.sharded:
            return self._blocks[0]
        return tuple(self._lay.gather_state([blk[s] for blk in self._blocks])
                     for s in range(self.m))

    @states.setter
    def states(self, sts) -> None:
        per_slot = [self._lay.split_state(st) for st in sts]
        self._blocks = [[per_slot[s][b] for s in range(len(per_slot))]
                        for b in range(len(self._lay.devices))]

    def _zero_drop(self) -> list[torch.Tensor]:
        return [torch.zeros((self.m, self.m, self._lay.block),
                            dtype=torch.bool, device=d)
                for d in self._lay.devices]

    def shard(self, mesh) -> None:
        """Split every member slot's [G]-leading state over the mesh's
        ``g`` axis (BASELINE config 5 in serving shape): group block
        ``i`` moves to ``mesh.devices[i][0]`` as a copy, and every later
        round, campaign, tick, compaction and conf change runs once per
        block with the [G] host inputs split alike (the [M, M, G] drop
        masks on their trailing axis).  Groups are independent, so no
        block reads another's.  Callers re-invoke after wholesale state
        replacement (restart seeding)."""
        lay = mesh.layout(self.g)
        states = list(self.states)
        self._lay = lay
        self.mesh = mesh
        self.device = lay.home
        self.states = states
        self.errors = {k: v.to(lay.home) for k, v in self.errors.items()}
        self._no_drop = self._zero_drop()
        self._hot_sel = None  # placement changed: rebuild the masks

    def _each(self, fn, *inputs, **static) -> list[list]:
        """``fn(block_states, *block_inputs, **static)`` once per
        g-block; keeps each block's new states (``fn``'s first output)
        and returns its other outputs, each as a per-block list."""
        outs = [fn(tuple(blk), *x, **static)
                for blk, *x in zip(self._blocks, *inputs)]
        self._blocks = [list(o[0]) for o in outs]
        return [list(v) for v in zip(*(o[1:] for o in outs))]

    def _put_g(self, arr, dtype=None) -> torch.Tensor:
        """[G] host array -> one whole tensor on the engine's device."""
        return torch.from_numpy(
            np.ascontiguousarray(np.asarray(arr, dtype))).to(self.device)

    def _put_b(self, arr, dtype=None) -> list[torch.Tensor]:
        """[G]-leading host array -> its g-blocks."""
        return self._lay.put(arr, dtype)

    def _drop_blocks(self, drop) -> list[torch.Tensor]:
        if not drop:
            return self._no_drop
        return self._lay.put(_drop_dense(drop, self.m, self.g), axis=2)

    def _drop(self, drop) -> torch.Tensor:
        """The whole [M, M, G] fault mask on the engine's device."""
        return self._lay.gather(self._drop_blocks(drop), axis=2)

    def _recompute_hot(self) -> None:
        mx = int(self.leader.max(initial=-1))
        self._route_hot = mx if mx >= 0 and bool(
            ((self.leader == mx) | (self.leader == -1)).all()) \
            else None
        self._hot_sel = None  # device router mask follows the routing

    def _hot_sel_dev(self, hot: int) -> list[torch.Tensor]:
        """Device-resident ``leader == hot`` router masks (per block),
        cached until the routing changes."""
        if self._hot_sel is None:
            self._hot_sel = self._put_b(self.leader == hot)
        return self._hot_sel

    def _stacked(self, stage: str, field: str) -> np.ndarray:
        """[M, G] host copy of one field of every member slot (one
        device read)."""
        return _ledger.fetch(stage, self._lay.gather(
            [torch.stack([getattr(st, field) for st in blk])
             for blk in self._blocks], axis=1))

    # -- elections (batched, fused, droppable) ---------------------------

    def campaign(self, slot: int, mask: np.ndarray | None = None,
                 drop=None) -> np.ndarray:
        """Member ``slot`` campaigns for the masked groups: term+1,
        vote self, request votes (droppable edges), count per-group
        quorums.  Returns the [G] bool mask of groups where it won.
        """
        g = self.g
        mask = np.ones(g, bool) if mask is None else np.asarray(mask, bool)
        dense = self._drop_blocks(drop)
        _ledger.h2d("multiraft.campaign", mask)
        with _ledger.dispatch("multiraft.campaign"):
            (won,) = self._each(_fused_campaign, self._put_b(mask), dense,
                                slot=slot)
        won_np = _ledger.fetch("multiraft.campaign", self._lay.gather(won))
        self.leader = np.where(won_np, slot, self.leader).astype(np.int32)
        self._recompute_hot()
        if won_np.any():
            # Entries beyond the winner's last were never committed
            # (Raft safety: committed entries survive elections), so a
            # deposed leader's payloads at those indices are garbage
            # the new term may overwrite: drop them.
            winner_last = _ledger.fetch("multiraft.campaign",
                                        self._lay.gather(
                                            [blk[slot].last
                                             for blk in self._blocks]))
            for gi in np.nonzero(won_np)[0]:
                p = self.payloads[gi]
                cut = int(winner_last[gi])
                if p and max(p) > cut:  # skip the common no-op case
                    self.payloads[gi] = {
                        k: v for k, v in p.items() if k <= cut}
            # the becoming-leader empty entry (raft.go:329-348)
            self.propose(np.where(won_np, 1, 0).astype(np.int32),
                         drop=drop)
        return won_np

    # -- the replication hot path (one call per round) -------------------

    def propose(self, n_new: np.ndarray,
                data: list[list[bytes]] | None = None,
                drop=None) -> np.ndarray:
        """Append ``n_new[g]`` proposals to each group's leader and run
        one full replicate->respond->commit round.  Returns the
        per-group count of newly committed entries."""
        n_new = np.asarray(n_new, np.int32)
        dense = self._drop_blocks(drop)
        _ledger.h2d("multiraft.round", n_new)
        with _ledger.dispatch("multiraft.round"):
            if self._route_hot is not None:
                hot = self._route_hot
                newly, valid, base, overflow, conflict = self._each(
                    _fused_round_hot, self._hot_sel_dev(hot),
                    self._put_b(n_new), dense, e=self.e, slot=hot)
            else:
                newly, valid, base, overflow, conflict = self._each(
                    _fused_round, self._put_b(self.leader),
                    self._put_b(n_new), dense, e=self.e)
        self.errors["overflow"] = self._lay.gather(overflow)
        self.errors["conflict"] = self._lay.gather(conflict)
        # one device read for the commit delta and the payload keying:
        # payloads are recorded only for groups whose addressed member
        # really IS leader (a deposed member may linger in
        # self.leader), keyed from its pre-append last index; the
        # keying arrays are kept for callers that key their own
        # bookkeeping (the multi-group server's wait registry)
        host = _ledger.fetch("multiraft.round", self._lay.gather(
            [torch.stack([n, v.to(torch.int32), b])
             for n, v, b in zip(newly, valid, base)], axis=1))
        self.last_valid = host[1].astype(bool)
        self.last_base = host[2]
        if data is not None:
            for gi in np.nonzero(self.last_valid)[0]:
                for j, blob in enumerate(data[gi][:int(n_new[gi])]):
                    self.payloads[gi][int(self.last_base[gi]) + 1 + j] \
                        = blob
        return host[0]

    def propose_rounds(self, n_new: np.ndarray, rounds: int,
                       drop=None) -> np.ndarray:
        """``rounds`` consecutive payload-less propose->commit rounds
        with one device read at the end (each round appends
        ``n_new[g]`` entries at the leader and completes a full
        replicate->respond->commit exchange).  Returns the per-group
        TOTAL of newly committed entries.

        For callers that track payloads use :meth:`propose`: this path
        skips the per-round valid/base keying in exchange for removing
        the per-round host sync."""
        dense = self._drop_blocks(drop)
        n_dev = self._put_b(n_new, np.int32)
        _ledger.h2d("multiraft.train", np.asarray(n_new, np.int32))
        with _ledger.dispatch("multiraft.train"):
            if self._route_hot is not None:
                hot = self._route_hot
                newly, overflow, conflict = self._each(
                    _fused_multi_round_hot, self._hot_sel_dev(hot),
                    n_dev, dense, e=self.e, k=rounds, slot=hot)
            else:
                newly, overflow, conflict = self._each(
                    _fused_multi_round, self._put_b(self.leader),
                    n_dev, dense, e=self.e, k=rounds)
        self.errors["overflow"] = self._lay.gather(overflow)
        self.errors["conflict"] = self._lay.gather(conflict)
        return _ledger.fetch("multiraft.train", self._lay.gather(newly))

    def replicate(self, drop=None) -> np.ndarray:
        """One replication round for every group: leaders send their
        pending window to every follower member, absorb the responses,
        advance the quorum commit.

        ``drop``: optional fault-injection mask: ``drop[(a, b)]`` is a
        [G] bool array dropping messages from member a to member b for
        the masked groups.  Dropped appends are simply retried on a
        later round (server.go:202-206)."""
        return self.propose(np.zeros(self.g, np.int32), drop=drop)

    # -- membership change (raft.go:376-387,431-435 batched) -------------

    def apply_conf_change(self, add: bool, slot: int,
                          mask: np.ndarray | None = None) -> None:
        """Apply a committed ConfChange to the masked groups: every
        co-hosted member adopts the new membership at once.

        Grow: the new slot starts empty (match 0, next last+1) and is
        caught up by normal replication, or the snapshot path if the
        leader already compacted.  Shrink: the removed slot's edges
        mask off, its stale match can't form quorums, and a removed
        leader steps down.  The CALLER proposes the change through the
        log and applies it only once committed."""
        g = self.g
        mask = np.ones(g, bool) if mask is None else np.asarray(mask, bool)
        n = self._lay.block
        for blk, mj in zip(self._blocks, self._put_b(mask)):
            addv = torch.full((n,), bool(add), dtype=torch.bool,
                              device=mj.device)
            slotv = _full(n, slot, mj)
            for s in range(self.m):
                blk[s] = conf_change_batch(
                    blk[s], addv, slotv, _full(n, s, mj), active=mj)
        if not add:
            # deposed-by-removal groups lose their routing entry too
            self.leader = np.where(mask & (self.leader == slot), -1,
                                   self.leader).astype(np.int32)
            self._recompute_hot()

    def mark_applied(self, upto: np.ndarray) -> None:
        """The host consumer declares it has applied entries up to
        ``upto[g]`` (clamped to each member's commit).  Compaction
        never slides past this point."""
        for blk, up in zip(self._blocks, self._put_b(upto, np.int32)):
            for slot in range(self.m):
                st = blk[slot]
                blk[slot] = st._replace(applied=torch.maximum(
                    st.applied, torch.minimum(up, st.commit)))

    def compact(self, upto: np.ndarray | None = None) -> None:
        """Compact every member's log at its applied index
        (server.go:313-316 + log.go:161); payloads below the
        compaction point are dropped from the host store.  Call
        :meth:`mark_applied` first.  Out-of-bounds lanes skip
        compaction (``errors["compact_oob"]``, never batch-fatal)."""
        ups = [None] * len(self._blocks) if upto is None \
            else self._put_b(upto, np.int32)
        oobs = []
        for blk, up, dev in zip(self._blocks, ups, self._lay.devices):
            oob = torch.zeros((self._lay.block,), dtype=torch.bool,
                              device=dev)
            for slot in range(self.m):
                st = blk[slot]
                idx = st.applied if up is None else torch.minimum(
                    st.applied, up)
                st, err = compact_batch(st, torch.maximum(idx, st.offset))
                oob = oob | err
                blk[slot] = st
            oobs.append(oob)
        self.errors["compact_oob"] = self._lay.gather(oobs)
        cut = self._stacked("multiraft.compact", "offset").min(axis=0)
        for gi in range(self.g):
            p = self.payloads[gi]
            c = int(cut[gi])
            if p and min(p) < c:
                self.payloads[gi] = {k: v for k, v in p.items()
                                     if k >= c}

    def tick(self, drop=None) -> None:
        """Advance every member's timers; campaign where they fire.
        ``drop`` faults apply to the resulting vote traffic too."""
        for slot in range(self.m):
            elects = []
            for blk in self._blocks:
                blk[slot], elect, _beat = tick_batch(blk[slot])
                elects.append(elect)
            fire = _ledger.fetch("multiraft.tick", self._lay.gather(elects))
            if fire.any():
                self.campaign(slot, fire, drop=drop)

    # -- views -----------------------------------------------------------

    def _commit_vector(self) -> np.ndarray:
        """Max commit across members per group (any member's commit is
        authoritative once set)."""
        return self._stacked("multiraft.view", "commit").max(axis=0)

    def commit_index(self) -> np.ndarray:
        return self._commit_vector()

    def max_terms(self) -> np.ndarray:
        """[G] i32 highest term across the member slots (one device
        read)."""
        return self._stacked("multiraft.view", "term").max(axis=0)

    def committed_payload(self, group: int, index: int) -> bytes | None:
        return self.payloads[group].get(index)

    def log_terms(self, slot: int) -> np.ndarray:
        return _ledger.fetch("multiraft.view", self._lay.gather(
            [blk[slot].log_term for blk in self._blocks]))
