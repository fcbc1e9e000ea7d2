"""One member slot of G co-hosted raft groups, for cross-host
replication (the port of ``etcd_tpu/raft/distmember.py``).

``MultiRaft`` (multiraft.py) fuses all M members of every group into
one process: maximal device batching, but the whole cluster shares
process fate.  This module is the other half: each HOST owns ONE
member slot of all G groups, rounds exchange batched [G] message
frames (wire/distmsg.py) over the host tier, and every device
transition reuses the batched engine ops (raft/batched.py) the fused
runtime uses: ``maybe_append``, ``leader_append``, ``progress_update``,
``maybe_commit``, ``grant_vote``, ``restore_snapshot``, applied to a
single slot's GroupState on ``default_device(device)`` (CUDA unless
the caller passes ``device="cpu"``).

Protocol parity: the exchange IS the reference's message protocol
(msgApp/msgAppResp/msgVote/msgVoteResp/msgSnap semantics,
raft/raft.go:372-520) with the group axis batched; drop tolerance is
the reference's fire-and-forget contract (server.go:202-206): any
frame may vanish, progress resumes on a later round.

Durability is the CALLER's job (the server layer persists entries,
ballots and frontiers to its WAL before acks/responses leave the
host: the Ready contract, node.go:41-60); this class is pure
consensus state.

Translation: the reference's eight jit'd step functions are plain
functions of torch ops here; their static arguments (``write_mode``,
``peer``, ``e``, ``slot``) are Python ints and strings.  Every function
returns new tensors and never writes into a state tensor in place (the
server holds references to state fields across calls).  Every host
read of device state goes through ``obs.devledger.fetch`` under a
``dist.*`` stage, so the reads a round costs are counted.  Timeouts are
drawn on the host with numpy's ``default_rng``, as in the reference, so
both engines draw the same timeouts from the same seed.

:meth:`DistMember.shard` splits the groups over a device mesh's ``g``
axis, as ``MultiRaft.shard`` does: the state is held as g-blocks, every
step runs once per block with the per-frame inputs split alike, and
each host read gathers the blocks first; the election draws stay
whole-G on the host.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import default_device
from ..obs.devledger import ledger as _ledger
from ..parallel.mesh import BlockLayout
from ..wire.distmsg import (
    AppendBatch,
    AppendResp,
    PackedPayloads,
    VoteReq,
    VoteResp,
    flat_entry_table,
)
from .batched import (
    CANDIDATE,
    FOLLOWER,
    LEADER,
    GroupState,
    _append_write_mode,
    apply_conf_change as conf_change_batch,
    compact as compact_batch,
    grant_vote,
    init_groups,
    leader_append,
    maybe_append,
    maybe_commit,
    progress_optimistic,
    progress_probe,
    progress_repair,
    progress_update,
    restore_snapshot,
    term_at,
    tick as tick_batch,
)


def _adopt_term(state: GroupState, msg_term, lead, active):
    """Higher-term message handling (raft.go:388-396): adopt the term,
    become follower, forget the vote; ``lead`` [G] i32 is the new
    leader slot to record (-1 for vote traffic)."""
    higher = active & (msg_term > state.term)
    return state._replace(
        term=torch.where(higher, msg_term, state.term),
        vote=torch.where(higher, -1, state.vote),
        role=torch.where(higher, FOLLOWER, state.role),
        lead=torch.where(higher, lead, state.lead))


def _absorb_resp(state: GroupState, peer: int, term, ok, acked, hint,
                 active):
    """Leader absorbing one peer's batched msgAppResp: step down on
    higher terms, progress-update ok lanes, repair next_ from the
    commit hint on rejects, then quorum-commit.

    The repair SETS next_ = hint + 1 in both directions.  The hint is
    the follower's commit, so prev = hint is always verifiable there
    (offset <= commit, and the compaction slot carries the offset
    entry's term) and everything <= hint is immutable.  Clamping with
    min(next_, hint+1) deadlocks the lane when response loss leaves
    the leader's next_ BELOW the follower's commit+1 while the
    follower has lane-compacted to its commit: the probe's prev sits
    below the follower's offset (term unknowable -> reject forever)
    and the min pins next_ there."""
    state = _adopt_term(state, term, torch.full_like(term, -1), active)
    g, _m = state.match.shape
    peer_v = torch.full((g,), peer, dtype=torch.int32,
                        device=term.device)
    state = progress_update(state, peer_v, acked, active=active & ok)
    state = progress_repair(state, peer_v, hint, active=active & ~ok)
    return maybe_commit(state)


def _handle_append_fused(state: GroupState, sender_v, term, prev_idx,
                         prev_term, ent_terms, n_ents, commit, active,
                         need_snap, write_mode: str):
    """The whole follower-side msgApp step: higher-term adoption,
    leadership + election-timer reset, maybe_append, and the response
    arrays packed into a single [G, 7] i32 block (ok | cur | conflict
    | overflow | acked | term | commit) so the host does one fetch
    instead of seven."""
    st = _adopt_term(state, term, sender_v, active)
    cur = active & (term == st.term)
    st = st._replace(
        role=torch.where(cur, FOLLOWER, st.role),
        lead=torch.where(cur, sender_v, st.lead),
        elapsed=torch.where(cur, 0, st.elapsed))
    do = cur & ~need_snap
    st, ok, e_conf, e_over = maybe_append(
        st, prev_idx, prev_term, ent_terms, n_ents, commit,
        active=do, write_mode=write_mode)
    need = need_snap & cur
    commit_i = st.commit.to(torch.int32)
    acked = torch.where(need, commit_i,
                        prev_idx + n_ents).to(torch.int32)
    i32 = torch.int32
    packed = torch.stack([
        ok.to(i32), cur.to(i32), e_conf.to(i32), e_over.to(i32),
        acked, st.term, commit_i], dim=1)
    return st, packed


def _ack_self_fused(state: GroupState, self_slot, upto):
    """Durable self-ack + quorum commit."""
    return maybe_commit(progress_update(state, self_slot, upto))


def _build_append_fused(state: GroupState, lane_mask, peer: int, e: int):
    """The msgApp window computation returning one packed
    [G, 6 + e + 1] i32 block: active | need_snap | prev_idx | n_ents |
    term | commit | terms2[e+1]; the host slices columns out of a
    single fetch."""
    i32 = torch.int32
    lead = state.role == LEADER
    member = state.members[:, peer]
    active = lead & member & lane_mask
    nxt = state.next_[:, peer]
    offset = state.offset
    need_snap = active & (nxt <= offset) & (offset > 0)
    sendable = active & ~need_snap
    prev_idx = torch.where(sendable, nxt - 1, 0).to(i32)
    n_ents = torch.where(
        sendable, torch.clamp(state.last - prev_idx, 0, e), 0).to(i32)
    idx = prev_idx[:, None] + 1 + torch.arange(e, dtype=i32,
                                               device=prev_idx.device)
    terms2 = term_at(state.log_term, state.offset, state.last,
                     torch.cat([prev_idx[:, None], idx], dim=1))
    return torch.cat([
        torch.stack([active.to(i32), need_snap.to(i32), prev_idx,
                     n_ents, state.term, state.commit], dim=1),
        terms2], dim=1)


def _begin_campaign(state: GroupState, mask, slot: int):
    """term+1, vote self, CANDIDATE (raft.go:358-362 batched)."""
    mask = mask & state.members[:, slot]
    lterm = term_at(state.log_term, state.offset, state.last,
                    state.last)
    return state._replace(
        term=state.term + mask.to(torch.int32),
        role=torch.where(mask, CANDIDATE, state.role),
        vote=torch.where(mask, slot, state.vote),
        elapsed=torch.where(mask, 0, state.elapsed)), mask, lterm


def _step_down(state: GroupState, mask):
    """Check-quorum abdication: masked LEADER lanes become followers
    with no known leader and a reset election timer.  The term is
    untouched (the reference's checkQuorum stepDown, raft.go
    becomeFollower(r.Term, None)): the deposed leader's peers will
    elect at term+1 on their own timers."""
    down = mask & (state.role == LEADER)
    return state._replace(
        role=torch.where(down, FOLLOWER, state.role),
        lead=torch.where(down, -1, state.lead),
        elapsed=torch.where(down, 0, state.elapsed))


def _become_leader(state: GroupState, won, slot: int):
    """Winner lanes become leader (raft.go:329-348 batched); the
    becoming-leader empty entry is appended by the caller via
    propose()."""
    return state._replace(
        role=torch.where(won, LEADER, state.role),
        lead=torch.where(won, slot, state.lead),
        match=torch.where(won[:, None], 0, state.match),
        next_=torch.where(won[:, None], state.last[:, None] + 1,
                          state.next_))


def _host(arr, dtype=None) -> np.ndarray:
    """Integer arrays of no stated dtype land as int32, as JAX's default
    (32-bit) mode puts them."""
    a = np.asarray(arr, dtype)
    if dtype is None and a.dtype.kind in "iu":
        a = a.astype(np.int32)
    return a


def _set_timeout(state: GroupState, mask, timeout):
    return state._replace(timeout=torch.where(mask, timeout, state.timeout))


def _handle_vote(state: GroupState, active, term, last, lterm, minus1,
                 sender):
    """msgVote receipt: adopt higher terms, grant where up to date and
    free, reset the election timer of granting lanes."""
    st = _adopt_term(state, term, minus1, active)
    st, granted = grant_vote(st, last, lterm, term, sender, active=active)
    return st._replace(elapsed=torch.where(granted, 0, st.elapsed)), granted


class DistMember:
    """Member ``slot`` of G co-hosted groups; peers live on other
    hosts and exchange wire/distmsg.py frames.

    The state is held as g-blocks, one until :meth:`shard` splits the
    groups over a mesh; every step runs once per block, on that block's
    device, with the per-frame host inputs split alike, and host reads
    gather the blocks first (the same reads a round at any block
    count).  :attr:`state` reads as one whole ``GroupState``."""

    def __init__(self, g: int, m: int, slot: int, cap: int,
                 election: int = 10, max_batch_ents: int = 8,
                 seed: int | None = None, live: int | None = None,
                 device=None):
        # (election is in ticks; the server layer's tick_interval
        # scales it to wall time: raft.go:611-617 randomization;
        # ``live`` < m leaves spare member slots for runtime
        # AddMember, batched state being static-shaped)
        self.device = default_device(device)
        self.g, self.m, self.slot, self.cap = g, m, slot, cap
        self.e = max_batch_ents
        self.mesh = None
        self._lay = BlockLayout(g, [self.device])
        # the stratified election bands (_draw_timeouts) carve m
        # disjoint width->=1 bands out of [election, 2*election);
        # with election < m that is impossible: w clamps to 1 and
        # high slots' bands spill past 2*election.  Clamp up so the
        # documented ``<= 2*election`` recovery bound holds on every
        # config.
        self.election = max(election, m)
        # kept: the timeout is re-drawn per campaign (see
        # begin_campaign), not fixed at init; draws stay whole-G on
        # the host at any block count
        self._rng = np.random.default_rng(
            slot if seed is None else seed)
        st = init_groups(g, m, cap, election=self.election,
                         live=live, device=self.device)
        st = st._replace(timeout=self._put(self._draw_timeouts(),
                                           np.int32))
        self.state = st
        # host-side payload ring: per-group {index: bytes}; a follower
        # keeps payloads too: it applies them at commit
        self.payloads: list[dict[int, bytes]] = [dict()
                                                 for _ in range(g)]
        self.errors = {"overflow": np.zeros(g, bool),
                       "conflict": np.zeros(g, bool)}
        # ship the FLAG_PACKED flat entry table on outgoing append
        # frames (receivers consume entries in one flat pass).
        # ETCD_DIST_PACKED=0 reverts to plain DGB2 frames: the
        # mixed-version lever the compat tests drive.
        self.packed_wire = \
            os.environ.get("ETCD_DIST_PACKED", "1") != "0"

    # -- the g-blocks and intra-host scale-out ------------------------------

    @property
    def state(self) -> GroupState:
        """The whole state (sharded: gathered onto the engine's
        device).  Assigning one replaces every block."""
        return self._lay.gather_state(self._blocks)

    @state.setter
    def state(self, st: GroupState) -> None:
        self._blocks = self._lay.split_state(st)

    def shard(self, mesh) -> None:
        """Split every [G]-leading state tensor over the mesh's ``g``
        axis (the intra-host tier composed under the cross-host one):
        block ``i`` moves to ``mesh.devices[i][0]`` as a copy, and every
        later step runs once per block with the per-frame [G]/[G, E]
        host inputs split alike; the frame exchange above is unchanged.
        Callers re-invoke after wholesale state replacement (restart
        seeding)."""
        lay = mesh.layout(self.g)
        st = self.state
        self._lay = lay
        self.mesh = mesh
        self.device = lay.home
        self.state = st

    def _step(self, fn, *inputs, **static):
        """``fn(block_state, *block_inputs, **static)`` once per g-block.
        ``fn`` returns the new state, or ``(state, *outputs)``; the
        blocks' states are kept and each output comes back whole (one
        output alone, several as a list)."""
        outs = [fn(st, *x, **static)
                for st, *x in zip(self._blocks, *inputs)]
        if isinstance(outs[0], GroupState):
            self._blocks = outs
            return None
        self._blocks = [o[0] for o in outs]
        rest = [self._lay.gather(list(v))
                for v in zip(*(o[1:] for o in outs))]
        return rest[0] if len(rest) == 1 else rest

    def _field(self, name: str) -> torch.Tensor:
        """One state field, whole."""
        return self._lay.gather([getattr(st, name) for st in self._blocks])

    def _put(self, arr, dtype=None) -> torch.Tensor:
        """Host array -> one whole tensor on the engine's device."""
        return torch.tensor(np.ascontiguousarray(_host(arr, dtype)),
                            device=self.device)

    def _put_b(self, arr, dtype=None) -> list[torch.Tensor]:
        """[G]-leading host array -> its g-blocks."""
        return self._lay.put(_host(arr, dtype))

    def _full_b(self, value, dtype=np.int32) -> list[torch.Tensor]:
        """[G] constant vector, as g-blocks."""
        return self._put_b(np.full(self.g, value), dtype)

    # -- views ------------------------------------------------------------

    def is_leader(self) -> np.ndarray:
        return _ledger.fetch("dist.view", self._field("role")) == LEADER

    def leader_hint(self) -> np.ndarray:
        """[G] member slot believed to lead each group (-1 none)."""
        return _ledger.fetch("dist.view", self._field("lead"))

    def commit_index(self) -> np.ndarray:
        return _ledger.fetch("dist.view", self._field("commit"))

    def terms(self) -> np.ndarray:
        return _ledger.fetch("dist.view", self._field("term"))

    def commit_terms(self) -> np.ndarray:
        """[G] term of the entry AT each commit index: what frontier
        markers and snapshots must record: a restarted/installed
        follower seeds its log slot 0 with this value, and the
        leader's append match at prev=frontier compares against the
        ENTRY's term, not the group's current term."""
        return _ledger.fetch("dist.view", self._lay.gather([
            term_at(st.log_term, st.offset, st.last, st.commit)
            for st in self._blocks]))

    def terms_at(self, idx: np.ndarray) -> np.ndarray:
        """[G] term of the entry at ``idx`` per group (0 outside the
        retained window)."""
        return _ledger.fetch("dist.view", self._lay.gather([
            term_at(st.log_term, st.offset, st.last, ix)
            for st, ix in zip(self._blocks, self._put_b(idx, np.int32))]))

    def committed_payload(self, group: int, index: int):
        return self.payloads[group].get(index)

    # -- leader path ------------------------------------------------------

    def propose(self, n_new: np.ndarray,
                data: list[list[bytes]] | None = None,
                self_ack: bool = True):
        """Append ``n_new[g]`` entries on lanes where this slot leads.
        Returns (valid, base): which lanes accepted, and each lane's
        pre-append last index (keys the caller's bookkeeping).

        ``self_ack=False`` (the pipelined server): the append does NOT
        advance this slot's own match: the caller counts its own ack
        via :meth:`ack_self` only after the WAL fsync covering these
        entries has landed, so commit can never form a quorum out of
        a non-durable local copy."""
        base = _ledger.fetch("dist.propose", self._field("last"))
        lead = self.is_leader()
        err = self._step(leader_append, self._put_b(n_new, np.int32),
                         self._full_b(self.slot), self_ack=self_ack)
        overflow = _ledger.fetch("dist.propose", err)
        self.errors["overflow"] = overflow
        valid = lead & (np.asarray(n_new) > 0) & ~overflow
        if data is not None:
            pay = self.payloads
            for gi in np.nonzero(valid)[0].tolist():
                row, b0 = pay[gi], int(base[gi])
                for j, blob in enumerate(data[gi][:int(n_new[gi])]):
                    row[b0 + 1 + j] = blob
        return valid, base

    def build_append(self, peer: int,
                     lane_mask: np.ndarray | None = None
                     ) -> AppendBatch | None:
        """The batched msgApp frame for ``peer``: every lane this slot
        leads sends its window [next_[peer], min(next+E-1, last)] (or
        a need_snap flag past compaction, raft.go:207-209).

        ``lane_mask`` restricts the frame to a subset of groups: the
        pipelined server stripes groups across parallel connections,
        and each stripe's frames must cover only ITS lanes so one
        lane's appends always ride one ordered connection."""
        mask = (np.ones(self.g, bool) if lane_mask is None
                else np.asarray(lane_mask, bool))
        p = _ledger.fetch("dist.build_append", self._lay.gather([
            _build_append_fused(st, mk, peer=peer, e=self.e)
            for st, mk in zip(self._blocks, self._put_b(mask))]))
        active = p[:, 0].astype(bool)
        if not active.any():
            return None
        need_snap = p[:, 1].astype(bool)
        prev_idx = p[:, 2]
        n_ents = p[:, 3]
        terms2 = p[:, 6:]
        # flat fetch: one (group, gindex) table drives one pass over
        # the payload ring: no per-group inner loop; the same table
        # ships on the wire (FLAG_PACKED) so the follower stores flat
        groups, gindex = flat_entry_table(prev_idx, n_ents)
        pay = self.payloads
        flat = [pay[gi].get(ix, b"")
                for gi, ix in zip(groups.tolist(), gindex.tolist())]
        return AppendBatch(
            sender=self.slot, term=p[:, 4],
            prev_idx=prev_idx, prev_term=terms2[:, 0],
            n_ents=n_ents, commit=p[:, 5],
            active=active, need_snap=need_snap,
            ent_terms=terms2[:, 1:],
            payloads=PackedPayloads.from_counts(flat, n_ents),
            ent_group=groups if self.packed_wire else None,
            ent_gindex=gindex if self.packed_wire else None)

    def ack_self(self, upto: np.ndarray) -> None:
        """Count this host's own DURABLE ack (pipelined mode):
        advance own match to ``upto`` (monotone max) once the WAL
        fsync covering entries ``<= upto`` has landed, then
        quorum-commit."""
        self._step(_ack_self_fused, self._full_b(self.slot),
                   self._put_b(upto, np.int32))

    def optimistic_advance(self, peer: int, b: AppendBatch) -> None:
        """Advance ``next_[:, peer]`` past the window just SENT in
        frame ``b`` (etcd raft OptimisticUpdate) so the next
        build_append ships the following entries without waiting for
        the ack.  match is untouched: only real acks move quorum."""
        sent = (np.asarray(b.prev_idx)
                + np.asarray(b.n_ents)).astype(np.int32)
        active = np.asarray(b.active) & ~np.asarray(b.need_snap)
        self._step(progress_optimistic, self._full_b(peer),
                   self._put_b(sent, np.int32), self._put_b(active))

    def probe_reset(self, peer: int) -> None:
        """Roll ``next_[:, peer]`` back to ``match + 1`` after a
        transport failure dropped in-flight frames (etcd raft
        becomeProbe): resend from the last CONFIRMED point."""
        self._step(progress_probe, self._full_b(peer))

    def step_down(self, mask: np.ndarray) -> None:
        """Abdicate the masked leader lanes (check-quorum): a leader
        whose outbound frames still deliver but whose inbound acks are
        lost keeps the followers' election timers reset FOREVER while
        never committing anything: the asymmetric-partition wedge.
        The server calls this when a lane's quorum ack basis (the
        lease clock) has gone stale for longer than the full
        worst-case election window: stop heartbeating so the
        followers can elect a reachable leader."""
        self._step(_step_down, self._put_b(np.asarray(mask, bool)))

    def handle_append_resp(self, r: AppendResp) -> np.ndarray:
        """Absorb a peer's batched response; returns the [G] commit
        vector after quorum advance."""
        _ledger.fetch("dist.absorb", self._field("commit"))
        self._step(lambda st, *x: _absorb_resp(st, r.sender, *x),
                   self._put_b(r.term), self._put_b(r.ok),
                   self._put_b(r.acked), self._put_b(r.hint),
                   self._put_b(r.active))
        return _ledger.fetch("dist.absorb", self._field("commit"))

    # -- follower path ----------------------------------------------------

    def handle_append(self, b: AppendBatch) -> AppendResp:
        """Batched msgApp receipt (stepFollower, raft.go:496-504):
        adopt higher terms, maybe_append current-term lanes, store
        payloads, reply with match/hint arrays: one fused step + ONE
        packed fetch per frame.  The CALLER persists the accepted
        entries BEFORE shipping the response."""
        packed = self._step(
            _handle_append_fused, self._full_b(b.sender),
            self._put_b(b.term), self._put_b(b.prev_idx),
            self._put_b(b.prev_term), self._put_b(b.ent_terms),
            self._put_b(b.n_ents), self._put_b(b.commit),
            self._put_b(b.active), self._put_b(b.need_snap),
            write_mode=_append_write_mode())
        p = _ledger.fetch("dist.handle_append", packed)
        ok_np = p[:, 0].astype(bool)
        cur = p[:, 1].astype(bool)
        self.errors["conflict"] = p[:, 2].astype(bool)
        self.errors["overflow"] = (self.errors["overflow"]
                                   | p[:, 3].astype(bool))
        pay = self.payloads
        if (b.ent_group is not None
                and isinstance(b.payloads, PackedPayloads)):
            # packed frame: the validated flat table routes every
            # blob in ONE pass: mask by the accepting lanes, no
            # per-group dict hop
            groups = np.asarray(b.ent_group)
            gl, il = groups.tolist(), \
                np.asarray(b.ent_gindex).tolist()
            flat = b.payloads.flat
            for k in np.nonzero(ok_np[groups])[0].tolist():
                pay[gl[k]][il[k]] = flat[k]
        else:
            for gi in np.nonzero(ok_np)[0].tolist():
                row, b0 = pay[gi], int(b.prev_idx[gi])
                blobs = b.payloads[gi]
                for j in range(int(b.n_ents[gi])):
                    row[b0 + 1 + j] = blobs[j]
        # A need_snap lane acks POSITIVELY at its commit (the
        # reference's handleSnapshot reply, raft.go:418-424): the
        # follower durably holds everything at or below its commit,
        # and after a snapshot install this is what advances the
        # leader's match/next past its compaction point.  (A reject's
        # hint repair sets next_ = hint+1, but a need_snap lane sends
        # no append to reject, so without this positive ack the
        # leader re-flags need_snap forever and the follower loops
        # snapshot pulls.)  The fused step already folded the need
        # lanes into acked (= commit there); ok/active fold here.
        need_mask = np.asarray(b.need_snap)
        need = need_mask & cur
        return AppendResp(
            sender=self.slot, term=p[:, 5],
            ok=ok_np | need,
            acked=p[:, 4],
            hint=p[:, 6],
            active=cur | (need_mask & np.asarray(b.active)),
            appended=ok_np)

    def install_snapshot(self, frontier: np.ndarray,
                         terms: np.ndarray,
                         members: np.ndarray | None = None
                         ) -> np.ndarray:
        """Collapse lanes to a pulled snapshot's frontier
        (raft.go:535-554 batched); returns installed lanes."""
        mem = [None] * len(self._blocks) if members is None \
            else self._put_b(members)
        installed = self._step(
            lambda st, fr, tm, mb: restore_snapshot(st, fr, tm,
                                                    members=mb),
            self._put_b(frontier, np.int32), self._put_b(terms, np.int32),
            mem)
        inst = _ledger.fetch("dist.install", installed)
        for gi in np.nonzero(inst)[0]:
            cut = int(frontier[gi])
            p = self.payloads[gi]
            if p and min(p) <= cut:
                self.payloads[gi] = {k: v for k, v in p.items()
                                     if k > cut}
        return inst

    # -- elections --------------------------------------------------------

    def _draw_timeouts(self) -> np.ndarray:
        """[G] election timeouts from this slot's stratified band.

        The draw is randomized WITHIN ``[election + slot*w,
        election + (slot+1)*w)`` where ``w = election // m``: bands
        are disjoint across slots, so two live hosts' timers cannot
        fire in the same tick band at all.  Plain uniform
        ``[election, 2*election)`` draws (raft.go:608-617) let two
        survivors collide with probability ~1/election per round.
        The per-campaign redraw is kept for decorrelation within a
        band; worst case stays <= 2*election for slot < m."""
        w = max(1, self.election // max(1, self.m))
        lo = self.election + self.slot * w
        return self._rng.integers(lo, lo + w, size=self.g)

    def begin_campaign(self, mask: np.ndarray) -> VoteReq:
        """Start campaigns on the masked lanes; the returned frame
        goes to every peer.  Caller persists the ballot (term+vote)
        BEFORE shipping (vote durability, wal.go:35-39's state
        record).

        Each campaign RE-DRAWS the fired lanes' election timeouts
        from the slot's stratified band (see _draw_timeouts).  A
        fixed per-lane timeout lets two hosts that drew equal values
        fire in lockstep forever: both campaign the same term, each
        votes for itself, neither grants: a split that repeats every
        timeout."""
        mask_b = self._put_b(np.asarray(mask, bool))
        mj, lterm = self._step(_begin_campaign, mask_b, slot=self.slot)
        fresh = self._draw_timeouts()
        self._step(_set_timeout, mask_b, self._put_b(fresh, np.int32))
        return VoteReq(sender=self.slot,
                       term=_ledger.fetch("dist.vote", self._field("term")),
                       last=_ledger.fetch("dist.vote", self._field("last")),
                       lterm=_ledger.fetch("dist.vote", lterm),
                       active=_ledger.fetch("dist.vote", mj))

    def handle_vote(self, v: VoteReq) -> VoteResp:
        """Batched msgVote receipt (raft.go:511-518): adopt higher
        terms, grant where log-up-to-date and not already voted.
        Caller persists the ballot before shipping the response."""
        active = self._put_b(v.active)
        granted = self._step(
            _handle_vote, active, self._put_b(v.term),
            self._put_b(v.last), self._put_b(v.lterm), self._full_b(-1),
            self._full_b(v.sender))
        return VoteResp(sender=self.slot,
                        term=_ledger.fetch("dist.vote", self._field("term")),
                        granted=_ledger.fetch("dist.vote", granted),
                        active=_ledger.fetch("dist.vote",
                                             self._lay.gather(active)))

    def tally(self, mask: np.ndarray,
              resps: list[VoteResp]) -> np.ndarray:
        """Count votes (self + granted responses) for the campaign
        lanes; quorum from live member counts.  Returns won lanes
        (already promoted to leader)."""
        votes = np.asarray(mask, np.int32).copy()  # own vote
        for r in resps:
            self._step(_adopt_term, self._put_b(r.term), self._full_b(-1),
                       self._put_b(r.active))
            votes += (r.granted & r.active).astype(np.int32)
        quorum = _ledger.fetch("dist.vote", self._field("nmembers")) // 2 + 1
        still_cand = _ledger.fetch("dist.vote",
                                   self._field("role")) == CANDIDATE
        won = np.asarray(mask, bool) & still_cand & (votes >= quorum)
        self._step(_become_leader, self._put_b(won), slot=self.slot)
        lost = np.asarray(mask, bool) & ~won
        if lost.any():
            # Loser backoff: a refused campaign usually means a
            # better-qualified peer exists (our log is behind, or the
            # peer is mid-candidacy): re-firing on the normal band
            # just churns terms and, under slow frame delivery, can
            # pre-empt that peer's own campaign for several rounds.
            # Waiting one extra election period before retrying gives
            # every other slot's band a clear shot while still
            # guaranteeing progress if we are the only candidate left.
            extra = self._draw_timeouts() + self.election
            self._step(_set_timeout, self._put_b(lost),
                       self._put_b(extra, np.int32))
        if won.any():
            # Raft safety: uncommitted tail payloads beyond our last
            # may be overwritten by the new term: drop stale keys
            last = _ledger.fetch("dist.vote", self._field("last"))
            for gi in np.nonzero(won)[0]:
                p = self.payloads[gi]
                if p and max(p) > int(last[gi]):
                    self.payloads[gi] = {
                        k: v for k, v in p.items()
                        if k <= int(last[gi])}
        return won

    # -- timers / maintenance --------------------------------------------

    def tick(self) -> np.ndarray:
        """Advance timers; returns lanes whose election timer fired
        (caller runs the campaign round-trip)."""
        elect = self._step(lambda st: tick_batch(st)[:2])
        return _ledger.fetch("dist.tick", elect)

    def mark_applied(self, upto: np.ndarray) -> None:
        self._step(lambda st, up: st._replace(applied=torch.maximum(
            st.applied, torch.minimum(up, st.commit))),
            self._put_b(upto, np.int32))

    def compact(self) -> None:
        self._step(lambda st: compact_batch(
            st, torch.maximum(st.applied, st.offset))[0])
        cut = _ledger.fetch("dist.compact", self._field("offset"))
        for gi in range(self.g):
            p = self.payloads[gi]
            c = int(cut[gi])
            if p and min(p) < c:
                self.payloads[gi] = {k: v for k, v in p.items()
                                     if k >= c}

    def apply_conf_change(self, add: bool, slot: int,
                          mask: np.ndarray | None = None) -> None:
        """Adopt a COMMITTED membership change (server layer proposes
        it through the log first, server.go:542-559)."""
        mask = np.ones(self.g, bool) if mask is None \
            else np.asarray(mask, bool)
        self._step(lambda st, a, s, me, act: conf_change_batch(
            st, a, s, me, active=act),
            self._full_b(bool(add), np.bool_), self._full_b(slot),
            self._full_b(self.slot), self._put_b(mask))
