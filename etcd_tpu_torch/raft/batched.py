"""Group-batched Raft engine: [G, ...] state tensors, masked torch ops.

The port of ``etcd_tpu/raft/batched.py``, function for function.  The
reference runs ONE raft group per process and its hot loops are scalar
(``maybeCommit``'s sort, ``log.append``/``findConflict`` walks —
raft/raft.go:248-258, raft/log.go:49-84).  Here tens of thousands of
co-hosted groups step at once: state lives as leading-axis-``G`` tensors
on the card and every hot-path transition is a masked, branchless batch
op.  Functions are pure: each returns a new ``GroupState`` and leaves
its inputs untouched.

Capacity model: each group's log is a CAP-slot window; slot ``s`` holds
the term of entry ``offset + s`` (slot 0 = the dummy/compacted entry).
Overflow and conflict-below-commit (a panic in the reference,
raft/log.go:57) surface as per-group error lanes in the returned flags.

Translation notes: ``take_along_axis`` is ``torch.gather`` with int64
indices; a one-hot over member slots is a comparison with ``arange(M)``,
which, like ``jax.nn.one_hot``, gives an all-False row for a slot out of
range.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from .. import default_device
from ..ops.quorum import commit_index_batch


def _append_write_mode() -> str:
    """``scatter`` | ``dense`` — how maybe_append writes the incoming
    window.  ``ETCD_APPEND_WRITE`` overrides the default (dense), as in
    the reference; both forms give identical state."""
    mode = os.environ.get("ETCD_APPEND_WRITE")
    if mode:
        if mode not in ("scatter", "dense"):
            # a typo must fail loudly, not measure some other form
            raise ValueError(
                f"ETCD_APPEND_WRITE={mode!r}: want scatter|dense")
        return mode
    return "dense"


FOLLOWER, CANDIDATE, LEADER = 0, 1, 2


class GroupState(NamedTuple):
    """Per-group consensus state, leading axis G."""

    term: torch.Tensor       # [G] i32 current term
    vote: torch.Tensor       # [G] i32 voted-for member slot (-1 none)
    role: torch.Tensor       # [G] i32 FOLLOWER/CANDIDATE/LEADER
    lead: torch.Tensor       # [G] i32 leader member slot (-1 none)
    commit: torch.Tensor     # [G] i32 commit index
    applied: torch.Tensor    # [G] i32 applied index
    log_term: torch.Tensor   # [G, CAP] i32 terms; slot s = idx offset+s
    offset: torch.Tensor     # [G] i32 compaction offset
    last: torch.Tensor       # [G] i32 last log index
    match: torch.Tensor      # [G, M] i32 leader view of peer match
    next_: torch.Tensor      # [G, M] i32 leader view of peer next
    nmembers: torch.Tensor   # [G] i32 live member count
    elapsed: torch.Tensor    # [G] i32 ticks since last reset
    timeout: torch.Tensor    # [G] i32 randomized election timeout
    members: torch.Tensor    # [G, M] bool live-membership mask

    @property
    def cap(self) -> int:
        return self.log_term.shape[1]


def init_groups(g: int, m: int, cap: int, election: int = 10,
                live: int | None = None, device=None) -> GroupState:
    """Fresh follower groups at term 0 with empty logs.

    ``live``: how many of the ``m`` member slots start as cluster
    members (default all) — the rest are addable later via
    :func:`apply_conf_change`.
    """
    dev = default_device(device)
    zi = torch.zeros((g,), dtype=torch.int32, device=dev)
    live = m if live is None else live
    members = (torch.arange(m, device=dev) < live).repeat(g, 1)
    return GroupState(
        term=zi, vote=zi - 1, role=zi + FOLLOWER, lead=zi - 1,
        commit=zi, applied=zi,
        log_term=torch.zeros((g, cap), dtype=torch.int32, device=dev),
        offset=zi, last=zi,
        match=torch.zeros((g, m), dtype=torch.int32, device=dev),
        next_=torch.ones((g, m), dtype=torch.int32, device=dev),
        nmembers=zi + live, elapsed=zi, timeout=zi + election,
        members=members,
    )


def group_state_from_numpy(fields: dict, device=None) -> GroupState:
    """A ``GroupState`` from numpy arrays keyed by field name (for
    example a JAX ``GroupState``'s ``_asdict()`` passed through
    ``np.asarray``), on ``device``.  Dtypes are kept."""
    dev = default_device(device)
    return GroupState(**{
        k: torch.from_numpy(np.ascontiguousarray(fields[k])).to(dev)
        for k in GroupState._fields})


def group_state_to_numpy(state: GroupState) -> dict:
    """Every field of ``state`` as a numpy array, keyed by name."""
    return {k: v.detach().cpu().numpy()
            for k, v in state._asdict().items()}


def _ones(g: int, like: torch.Tensor) -> torch.Tensor:
    return torch.ones((g,), dtype=torch.bool, device=like.device)


def _one_hot(slot: torch.Tensor, m: int) -> torch.Tensor:
    """bool [G, M]: True at each group's ``slot``."""
    return slot[:, None] == torch.arange(m, dtype=slot.dtype,
                                         device=slot.device)


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, 1, idx.to(torch.int64))


# ---------------------------------------------------------------------------
# log primitives (batched forms of log.py / reference raft/log.go)
# ---------------------------------------------------------------------------


def term_at(log_term, offset, last, idx):
    """Term of entry ``idx`` per group; 0 outside [offset, last].

    ``idx`` may be [G] or [G, K] (absolute entry indices).
    """
    squeeze = idx.dim() == 1
    if squeeze:
        idx = idx[:, None]
    cap = log_term.shape[1]
    slot = idx - offset[:, None]
    valid = (idx >= offset[:, None]) & (idx <= last[:, None]) & \
        (slot < cap)
    t = _gather(log_term, torch.clamp(slot, 0, cap - 1))
    t = torch.where(valid, t, 0)
    return t[:, 0] if squeeze else t


def match_term(log_term, offset, last, idx, term):
    """Batched ``RaftLog.match_term`` — a term-0 entry at a valid index
    cannot be distinguished from absence, as in the reference."""
    in_range = (idx >= offset) & (idx <= last)
    return in_range & (term_at(log_term, offset, last, idx) == term)


def is_up_to_date(log_term, offset, last, cand_idx, cand_term):
    """Batched ``RaftLog.is_up_to_date`` (log.go:136-139): vote grant
    condition on candidate's (last index, last term)."""
    lt = term_at(log_term, offset, last, last)
    return (cand_term > lt) | ((cand_term == lt) & (cand_idx >= last))


def maybe_append(state: GroupState, prev_idx, prev_term, ent_terms,
                 n_ents, leader_commit, active=None,
                 write_mode: str | None = None):
    """Follower replication step, batched ``RaftLog.maybe_append``
    (log.go:49-69): term-match at prev, conflict scan, truncating
    append, commit advance.

    ``ent_terms`` [G, E] terms of incoming entries (entry j has index
    prev_idx + 1 + j), ``n_ents`` [G] how many are real, ``active``
    [G] bool mask of groups actually receiving an append.
    ``write_mode`` pins the window-write form (scatter|dense); by
    default it is read from ETCD_APPEND_WRITE at each call.

    Returns ``(state', ok, err_conflict, err_overflow)``; error lanes
    leave the group's state untouched.
    """
    mode = write_mode or _append_write_mode()
    g, cap = state.log_term.shape
    e = ent_terms.shape[1]
    dev = state.log_term.device
    if active is None:
        active = _ones(g, state.log_term)

    ok = active & match_term(state.log_term, state.offset, state.last,
                             prev_idx, prev_term)

    # conflict scan (log.go:77-84) over the incoming window
    e_idx = prev_idx[:, None] + 1 + torch.arange(e, dtype=torch.int32,
                                                 device=dev)
    existing = term_at(state.log_term, state.offset, state.last, e_idx)
    valid_e = torch.arange(e, device=dev) < n_ents[:, None]
    mismatch = valid_e & ((e_idx > state.last[:, None]) |
                          (existing != ent_terms))
    conflict = mismatch.any(dim=1)
    # first mismatch position (argmax returns the first maximum)
    ci_rel = mismatch.to(torch.uint8).argmax(dim=1).to(torch.int32)
    ci = prev_idx + 1 + ci_rel
    lastnewi = prev_idx + n_ents

    err_conflict = ok & conflict & (ci <= state.commit)
    err_overflow = ok & (lastnewi - state.offset >= cap)
    ok = ok & ~(err_conflict | err_overflow)

    # truncating append: slots in [prev_idx+1, lastnewi] take the
    # incoming terms.  "scatter" writes only the E incoming slots;
    # "dense" is one masked where() over the whole window.
    if mode == "scatter":
        rel = e_idx - state.offset[:, None]    # cap slot of entry j
        writej = ok[:, None] & valid_e & (rel >= 0) & (rel < cap)
        cols = torch.where(writej, rel, cap)   # column cap = dropped
        padded = torch.cat([state.log_term,
                            state.log_term.new_zeros((g, 1))], dim=1)
        log_term = padded.scatter(1, cols.to(torch.int64),
                                  ent_terms.to(padded.dtype))[:, :cap]
    else:
        cap_idx = state.offset[:, None] + \
            torch.arange(cap, dtype=torch.int32, device=dev)
        j = cap_idx - (prev_idx[:, None] + 1)
        write = ok[:, None] & (j >= 0) & (j < n_ents[:, None])
        incoming = _gather(ent_terms, torch.clamp(j, 0, e - 1))
        log_term = torch.where(write, incoming, state.log_term)

    last = torch.where(ok & conflict, lastnewi, state.last)
    tocommit = torch.minimum(leader_commit, lastnewi)
    commit = torch.where(ok & (tocommit > state.commit), tocommit,
                         state.commit)
    return state._replace(log_term=log_term, last=last,
                          commit=commit), ok, err_conflict, err_overflow


def leader_append(state: GroupState, n_new, self_slot, active=None,
                  self_ack: bool = True):
    """Leader-side ``append_entry`` (raft.go:279-286): append n_new
    entries of the leader's term, update own progress.

    Returns ``(state', err)`` with err = capacity overflow lanes, which
    are left untouched.  ``self_ack=False`` appends WITHOUT advancing
    the leader's own ``match``: its caller counts its own copy only
    once its WAL fsync lands.
    """
    g, cap = state.log_term.shape
    if active is None:
        active = _ones(g, state.log_term)
    self_live = _gather(state.members, self_slot[:, None])[:, 0]
    active = active & (state.role == LEADER) & self_live

    lastnew = state.last + n_new
    err = active & (lastnew - state.offset >= cap)
    do = active & ~err

    cap_idx = state.offset[:, None] + torch.arange(
        cap, dtype=torch.int32, device=state.log_term.device)
    write = do[:, None] & (cap_idx > state.last[:, None]) & \
        (cap_idx <= lastnew[:, None])
    log_term = torch.where(write, state.term[:, None], state.log_term)

    m = state.match.shape[1]
    onehot = _one_hot(self_slot, m)
    match = state.match
    if self_ack:
        match = torch.where(do[:, None] & onehot, lastnew[:, None], match)
    next_ = torch.where(do[:, None] & onehot, lastnew[:, None] + 1,
                        state.next_)
    last = torch.where(do, lastnew, state.last)
    return state._replace(log_term=log_term, last=last, match=match,
                          next_=next_), err


def progress_update(state: GroupState, from_slot, idx, active=None):
    """Leader handling a successful msgAppResp (raft.go:456-463):
    ``prs[from].update(idx)`` batched as a one-hot select."""
    g, m = state.match.shape
    if active is None:
        active = _ones(g, state.match)
    active = active & (state.role == LEADER)
    onehot = _one_hot(from_slot, m) & active[:, None]
    match = torch.where(onehot, torch.maximum(state.match, idx[:, None]),
                        state.match)
    next_ = torch.where(onehot,
                        torch.maximum(state.next_, idx[:, None] + 1),
                        state.next_)
    return state._replace(match=match, next_=next_)


def progress_optimistic(state: GroupState, from_slot, idx, active=None):
    """Pipelined leader: advance ``next_[from]`` past a just-SENT window
    (etcd raft ``Progress.OptimisticUpdate``); ``match`` is untouched."""
    g, m = state.match.shape
    if active is None:
        active = _ones(g, state.match)
    active = active & (state.role == LEADER)
    onehot = _one_hot(from_slot, m) & active[:, None]
    next_ = torch.where(onehot,
                        torch.maximum(state.next_, idx[:, None] + 1),
                        state.next_)
    return state._replace(next_=next_)


def progress_probe(state: GroupState, from_slot, active=None):
    """Pipelined leader on TRANSPORT failure to a peer: roll ``next_``
    back to the last confirmed point, ``match + 1`` (etcd raft
    ``Progress.becomeProbe``)."""
    g, m = state.match.shape
    if active is None:
        active = _ones(g, state.match)
    active = active & (state.role == LEADER)
    onehot = _one_hot(from_slot, m) & active[:, None]
    return state._replace(next_=torch.where(
        onehot, torch.clamp(state.match + 1, min=1), state.next_))


def progress_repair(state: GroupState, from_slot, hint,
                    active) -> GroupState:
    """Leader handling a REJECTED msgAppResp: SET ``next_[from] =
    hint + 1`` where ``hint`` is the follower's commit — one-round
    repair instead of the reference's decrement-by-one probe."""
    g, m = state.match.shape
    active = active & (state.role == LEADER)
    onehot = _one_hot(from_slot, m) & active[:, None]
    repaired = torch.clamp(hint + 1, min=1)
    return state._replace(next_=torch.where(
        onehot, repaired[:, None], state.next_))


def maybe_commit(state: GroupState) -> GroupState:
    """Quorum commit advance (raft.go:248-258 + log.go:88-95) for all
    leader groups: q-th largest LIVE match, gated on current-term
    entry."""
    mci = commit_index_batch(
        torch.where(state.members, state.match, 0), state.nmembers)
    t_at = term_at(state.log_term, state.offset, state.last, mci)
    ok = (state.role == LEADER) & (mci > state.commit) & \
        (t_at == state.term)
    return state._replace(commit=torch.where(ok, mci, state.commit))


def compact(state: GroupState, idx, active=None):
    """Batched ``RaftLog.compact`` (log.go:161-169): slide the window
    so slot 0 holds entry ``idx``.  err lanes where idx is not in
    [offset, applied]."""
    g, cap = state.log_term.shape
    if active is None:
        active = _ones(g, state.log_term)
    err = active & ((idx < state.offset) | (idx > state.applied))
    do = active & ~err
    shift = idx - state.offset
    src = torch.arange(cap, dtype=torch.int32,
                       device=state.log_term.device)[None, :] + \
        shift[:, None]
    rolled = _gather(state.log_term, torch.clamp(src, 0, cap - 1))
    rolled = torch.where(src < cap, rolled, 0)
    return state._replace(
        log_term=torch.where(do[:, None], rolled, state.log_term),
        offset=torch.where(do, idx, state.offset)), err


def restore_snapshot(state: GroupState, idx, term, commit=None,
                     active=None, members=None):
    """Install a snapshot into the masked groups (raft.go:535-554):
    the log collapses to a single dummy slot at ``idx`` carrying
    ``term``, and commit/applied jump to ``idx`` (or ``commit``).
    ``members``: optional [G, M] snapshot-carried membership.

    Lanes whose commit already reaches ``idx`` reject the snapshot.
    Returns ``(state', installed)``.
    """
    g, cap = state.log_term.shape
    if active is None:
        active = _ones(g, state.log_term)
    if commit is None:
        commit = idx
    installed = active & (idx > state.commit)
    slot0 = torch.cat([term[:, None].to(state.log_term.dtype),
                       state.log_term.new_zeros((g, cap - 1))], dim=1)
    new_members = state.members
    nmembers = state.nmembers
    if members is not None:
        new_members = torch.where(installed[:, None], members,
                                  state.members)
        nmembers = new_members.sum(dim=1).to(torch.int32)
    return state._replace(
        log_term=torch.where(installed[:, None], slot0, state.log_term),
        offset=torch.where(installed, idx, state.offset),
        last=torch.where(installed, idx, state.last),
        commit=torch.where(installed, commit, state.commit),
        applied=torch.where(installed, commit, state.applied),
        members=new_members, nmembers=nmembers), installed


def apply_conf_change(state: GroupState, add, slot, self_slot,
                      active=None):
    """Batched ConfChange apply (raft.go:376-387,431-435 semantics).

    ``add`` [G] bool (True = AddNode, False = RemoveNode), ``slot`` [G]
    the member slot being changed, ``self_slot`` [G] the slot THIS
    state belongs to (a member removing itself steps down).  A newly
    added member starts with match 0 and next = last+1; nmembers
    recounts.
    """
    g, m = state.match.shape
    if active is None:
        active = _ones(g, state.match)
    onehot = _one_hot(slot, m) & active[:, None]
    members = torch.where(onehot, add[:, None], state.members)
    newly = onehot & add[:, None] & ~state.members
    match = torch.where(newly, 0, state.match)
    next_ = torch.where(newly, state.last[:, None] + 1, state.next_)
    nmembers = members.sum(dim=1).to(torch.int32)
    self_removed = active & ~add & (slot == self_slot)
    role = torch.where(self_removed, FOLLOWER, state.role)
    # a group whose leader was removed has no leader until the next
    # election
    lead = torch.where(active & ~add & (slot == state.lead), -1,
                       state.lead)
    return state._replace(members=members, match=match, next_=next_,
                          nmembers=nmembers, role=role, lead=lead)


def tick(state: GroupState, heartbeat: int = 1):
    """Batched tick (raft.go:288-301): advance timers, report which
    groups fire an election timeout (followers/candidates) or a
    heartbeat (leaders)."""
    elapsed = state.elapsed + 1
    elect = (state.role != LEADER) & (elapsed >= state.timeout)
    beat = (state.role == LEADER) & (elapsed >= heartbeat)
    elapsed = torch.where(elect | beat, 0, elapsed)
    return state._replace(elapsed=elapsed), elect, beat


def grant_vote(state: GroupState, cand_idx, cand_term, msg_term,
               cand_slot, active=None):
    """Vote grant decision batched (raft.go:511-518): term check,
    not-voted-or-same check, log up-to-dateness."""
    g = state.term.shape[0]
    if active is None:
        active = _ones(g, state.term)
    utd = is_up_to_date(state.log_term, state.offset, state.last,
                        cand_idx, cand_term)
    free = (state.vote == -1) | (state.vote == cand_slot)
    grant = active & (msg_term >= state.term) & free & utd
    vote = torch.where(grant, cand_slot, state.vote)
    return state._replace(vote=vote), grant


def replication_round(state: GroupState, n_new, self_slot,
                      resp_slots, resp_idx, resp_mask):
    """One fused leader-side pipeline step:

    1. append ``n_new`` proposals per leader group (raft.go:279),
    2. absorb a [G, R] batch of msgAppResp progress updates
       (raft.go:456-463) — R responses per group, masked,
    3. advance quorum commit (raft.go:248).

    Returns ``(state', err, n_committed)`` where n_committed is the
    per-group count of newly committed entries this round.
    """
    before = state.commit
    state, err = leader_append(state, n_new, self_slot)
    for k in range(resp_slots.shape[1]):
        state = progress_update(state, resp_slots[:, k], resp_idx[:, k],
                                active=resp_mask[:, k])
    state = maybe_commit(state)
    return state, err, state.commit - before
