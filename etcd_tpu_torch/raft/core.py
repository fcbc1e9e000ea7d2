"""Raft consensus state machine (reference raft/raft.go).

A pure, deterministic function of (state, message): ``Raft.step``
mutates only its own fields and appends outbound messages to
``self.msgs`` — no I/O, no clocks, no goroutines.  This purity is the
property the reference's test suite exploits (thousands of table cases
with a fake network pump) and exactly what makes the state machine
batchable: batched.py carries the same state as [G, ...] tensors and
steps every group in one masked torch computation.  The port's copy of
``etcd_tpu/raft/core.py``: the two step in lockstep, message for
message.

Role dispatch mirrors step_leader/step_candidate/step_follower
(reference raft/raft.go:439-520); panics in the reference become
``RaftPanicError``.
"""

from __future__ import annotations

import random

from ..wire import (
    ENTRY_CONF_CHANGE,
    Entry,
    HardState,
    MSG_APP,
    MSG_APP_RESP,
    MSG_BEAT,
    MSG_DENIED,
    MSG_HUP,
    MSG_PROP,
    MSG_SNAP,
    MSG_VOTE,
    MSG_VOTE_RESP,
    Message,
    Snapshot,
)
from .log import RaftLog

NONE = 0  # placeholder node ID when there is no leader (raft.go:13)

STATE_FOLLOWER = 0
STATE_CANDIDATE = 1
STATE_LEADER = 2

STATE_NAMES = ("StateFollower", "StateCandidate", "StateLeader")


class RaftPanicError(Exception):
    """Where the reference panics, we raise."""


class Progress:
    """Per-peer replication progress (reference raft/raft.go:67-94)."""

    __slots__ = ("match", "next")

    def __init__(self, match: int = 0, next: int = 0):
        self.match = match
        self.next = next

    def update(self, n: int) -> None:
        self.match = n
        self.next = n + 1

    def maybe_decr_to(self, to: int) -> bool:
        """False if the rejection is stale (raft.go:78-90)."""
        if self.match != 0 or self.next - 1 != to:
            return False
        self.next -= 1
        if self.next < 1:
            self.next = 1
        return True

    def __repr__(self) -> str:
        return f"n={self.next} m={self.match}"


class SoftState:
    """Volatile state, for logging/should-stop (reference node.go:21-26)."""

    __slots__ = ("lead", "raft_state", "nodes", "should_stop")

    def __init__(self, lead: int, raft_state: int, nodes: list[int],
                 should_stop: bool):
        self.lead = lead
        self.raft_state = raft_state
        self.nodes = nodes
        self.should_stop = should_stop

    def __eq__(self, other) -> bool:
        return (isinstance(other, SoftState)
                and self.lead == other.lead
                and self.raft_state == other.raft_state
                and self.nodes == other.nodes
                and self.should_stop == other.should_stop)


class Raft:
    def __init__(self, id: int, peers: list[int], election: int,
                 heartbeat: int):
        if id == NONE:
            raise RaftPanicError("cannot use none id")
        # HardState fields (embedded pb.HardState in the reference)
        self.term = 0
        self.vote = NONE
        self.commit = 0

        self.id = id
        self.raft_log = RaftLog()
        self.prs: dict[int, Progress] = {p: Progress() for p in peers}
        self.state = STATE_FOLLOWER
        self.votes: dict[int, bool] = {}
        self.msgs: list[Message] = []
        self.lead = NONE
        self.pending_conf = False
        self.removed: dict[int, bool] = {}
        self.elapsed = 0
        self.heartbeat_timeout = heartbeat
        self.election_timeout = election
        # deterministic per-id randomness (reference raft.go:139
        # rand.Seed(int64(id)))
        self._rng = random.Random(id)
        self._tick = self._tick_election
        self._step = _step_follower
        self.become_follower(0, NONE)

    # -- queries -----------------------------------------------------------

    def has_leader(self) -> bool:
        return self.lead != NONE

    def should_stop(self) -> bool:
        return self.removed.get(self.id, False)

    def soft_state(self) -> SoftState:
        return SoftState(self.lead, self.state, self.nodes(),
                         self.should_stop())

    def hard_state(self) -> HardState:
        return HardState(term=self.term, vote=self.vote, commit=self.commit)

    def nodes(self) -> list[int]:
        return sorted(self.prs)

    def removed_nodes(self) -> list[int]:
        return sorted(self.removed)

    def q(self) -> int:
        """Quorum size (reference raft.go:275-277)."""
        return len(self.prs) // 2 + 1

    def promotable(self) -> bool:
        return self.id in self.prs

    # -- vote bookkeeping --------------------------------------------------

    def poll(self, id: int, v: bool) -> int:
        if id not in self.votes:
            self.votes[id] = v
        return sum(1 for vv in self.votes.values() if vv)

    # -- message emission --------------------------------------------------

    def send(self, m: Message) -> None:
        """Stamp from/term and queue to the mailbox (raft.go:190-199).
        Proposals are local/forwarded messages and carry no term."""
        m.from_ = self.id
        if m.type != MSG_PROP:
            m.term = self.term
        self.msgs.append(m)

    def send_append(self, to: int) -> None:
        """Replicate to one peer: entries or snapshot
        (reference raft.go:202-217)."""
        pr = self.prs[to]
        m = Message(to=to, index=pr.next - 1)
        if self.need_snapshot(m.index):
            m.type = MSG_SNAP
            m.snapshot = self.raft_log.snapshot
        else:
            m.type = MSG_APP
            m.log_term = self.raft_log.term(pr.next - 1)
            m.entries = self.raft_log.entries(pr.next)
            m.commit = self.raft_log.committed
        self.send(m)

    def send_heartbeat(self, to: int) -> None:
        """Empty msgApp (reference raft.go:220-226)."""
        self.send(Message(to=to, type=MSG_APP))

    def bcast_append(self) -> None:
        for i in self.prs:
            if i != self.id:
                self.send_append(i)

    def bcast_heartbeat(self) -> None:
        for i in self.prs:
            if i != self.id:
                self.send_heartbeat(i)

    def read_messages(self) -> list[Message]:
        msgs = self.msgs
        self.msgs = []
        return msgs

    # -- commit ------------------------------------------------------------

    def maybe_commit(self) -> bool:
        """Quorum commit index = q-th largest match (raft.go:248-258).
        The reference sorts; the batched engine computes the same
        order statistic with jnp.sort over the member axis."""
        mis = sorted((pr.match for pr in self.prs.values()), reverse=True)
        mci = mis[self.q() - 1]
        return self.raft_log.maybe_commit(mci, self.term)

    # -- state transitions -------------------------------------------------

    def reset(self, term: int) -> None:
        self.term = term
        self.lead = NONE
        self.vote = NONE
        self.elapsed = 0
        self.votes = {}
        for i in list(self.prs):
            self.prs[i] = Progress(next=self.raft_log.last_index() + 1)
            if i == self.id:
                self.prs[i].match = self.raft_log.last_index()
        self.pending_conf = False

    def append_entry(self, e: Entry) -> None:
        e.term = self.term
        e.index = self.raft_log.last_index() + 1
        self.raft_log.append(self.raft_log.last_index(), [e])
        self.prs[self.id].update(self.raft_log.last_index())
        self.maybe_commit()

    def _tick_election(self) -> None:
        """Followers/candidates count toward election (raft.go:288-298)."""
        if not self.promotable():
            self.elapsed = 0
            return
        self.elapsed += 1
        if self.is_election_timeout():
            self.elapsed = 0
            self.step(Message(from_=self.id, type=MSG_HUP))

    def _tick_heartbeat(self) -> None:
        self.elapsed += 1
        if self.elapsed > self.heartbeat_timeout:
            self.elapsed = 0
            self.step(Message(from_=self.id, type=MSG_BEAT))

    def tick(self) -> None:
        self._tick()

    def become_follower(self, term: int, lead: int) -> None:
        self._step = _step_follower
        self.reset(term)
        self._tick = self._tick_election
        self.lead = lead
        self.state = STATE_FOLLOWER

    def become_candidate(self) -> None:
        if self.state == STATE_LEADER:
            raise RaftPanicError("invalid transition [leader -> candidate]")
        self._step = _step_candidate
        self.reset(self.term + 1)
        self._tick = self._tick_election
        self.vote = self.id
        self.state = STATE_CANDIDATE

    def become_leader(self) -> None:
        if self.state == STATE_FOLLOWER:
            raise RaftPanicError("invalid transition [follower -> leader]")
        self._step = _step_leader
        self.reset(self.term)
        self._tick = self._tick_heartbeat
        self.lead = self.id
        self.state = STATE_LEADER
        for e in self.raft_log.entries(self.raft_log.committed + 1):
            if e.type != ENTRY_CONF_CHANGE:
                continue
            if self.pending_conf:
                raise RaftPanicError(
                    "unexpected double uncommitted config entry")
            self.pending_conf = True
        self.append_entry(Entry())

    def campaign(self) -> None:
        """Start an election (reference raft.go:358-370)."""
        self.become_candidate()
        if self.q() == self.poll(self.id, True):
            self.become_leader()
        for i in self.prs:
            if i == self.id:
                continue
            lasti = self.raft_log.last_index()
            self.send(Message(to=i, type=MSG_VOTE, index=lasti,
                              log_term=self.raft_log.term(lasti)))

    # -- the step function -------------------------------------------------

    def step(self, m: Message) -> None:
        """THE consensus transition (reference raft.go:372-408)."""
        try:
            if self.removed.get(m.from_, False):
                if m.from_ != self.id:
                    self.send(Message(to=m.from_, type=MSG_DENIED))
                return
            if m.type == MSG_DENIED:
                self.removed[self.id] = True
                return

            if m.type == MSG_HUP:
                self.campaign()

            if m.term == 0:
                pass  # local message
            elif m.term > self.term:
                lead = m.from_
                if m.type == MSG_VOTE:
                    lead = NONE
                self.become_follower(m.term, lead)
            elif m.term < self.term:
                return  # ignore
            self._step(self, m)
        finally:
            # defer: keep HardState.commit in sync (raft.go:374)
            self.commit = self.raft_log.committed

    def handle_append_entries(self, m: Message) -> None:
        if self.raft_log.maybe_append(m.index, m.log_term, m.commit,
                                      m.entries):
            self.send(Message(to=m.from_, type=MSG_APP_RESP,
                              index=self.raft_log.last_index()))
        else:
            self.send(Message(to=m.from_, type=MSG_APP_RESP, index=m.index,
                              reject=True))

    def handle_snapshot(self, m: Message) -> None:
        if self.restore(m.snapshot):
            self.send(Message(to=m.from_, type=MSG_APP_RESP,
                              index=self.raft_log.last_index()))
        else:
            self.send(Message(to=m.from_, type=MSG_APP_RESP,
                              index=self.raft_log.committed))

    # -- membership --------------------------------------------------------

    def add_node(self, id: int) -> None:
        self.set_progress(id, 0, self.raft_log.last_index() + 1)
        self.pending_conf = False

    def remove_node(self, id: int) -> None:
        self.del_progress(id)
        self.pending_conf = False
        self.removed[id] = True

    def set_progress(self, id: int, match: int, next: int) -> None:
        self.prs[id] = Progress(match=match, next=next)

    def del_progress(self, id: int) -> None:
        self.prs.pop(id, None)

    # -- snapshot / compaction ---------------------------------------------

    def compact(self, index: int, nodes: list[int], d: bytes) -> None:
        """Reference raft.go:522-531."""
        if index > self.raft_log.applied:
            raise RaftPanicError(
                f"compact index ({index}) exceeds applied index "
                f"({self.raft_log.applied})")
        self.raft_log.snap(d, index, self.raft_log.term(index), nodes,
                           self.removed_nodes())
        self.raft_log.compact(index)

    def restore(self, s: Snapshot) -> bool:
        """Recover from snapshot: log + configuration
        (reference raft.go:535-554)."""
        if s.index <= self.raft_log.committed:
            return False
        self.raft_log.restore(s)
        self.prs = {}
        for n in s.nodes:
            if n == self.id:
                self.set_progress(n, self.raft_log.last_index(),
                                  self.raft_log.last_index() + 1)
            else:
                self.set_progress(n, 0, self.raft_log.last_index() + 1)
        self.removed = {}
        for n in s.removed_nodes:
            self.removed[n] = True
        return True

    def need_snapshot(self, i: int) -> bool:
        if i < self.raft_log.offset:
            if self.raft_log.snapshot.term == 0:
                raise RaftPanicError("need non-empty snapshot")
            return True
        return False

    # -- restart loading ---------------------------------------------------

    def load_ents(self, ents: list[Entry]) -> None:
        self.raft_log.load(ents)

    def load_state(self, state: HardState) -> None:
        self.raft_log.committed = state.commit
        self.term = state.term
        self.vote = state.vote
        self.commit = state.commit

    # -- timing ------------------------------------------------------------

    def is_election_timeout(self) -> bool:
        """Randomized in (timeout, 2*timeout - 1) (raft.go:608-617)."""
        d = self.elapsed - self.election_timeout
        if d < 0:
            return False
        return d > self._rng.randrange(self.election_timeout)

    def __repr__(self) -> str:
        return (f"state={STATE_NAMES[self.state]} term={self.term} "
                f"lead={self.lead} commit={self.raft_log.committed}")


# -- role step functions (reference raft.go:439-520) ------------------------

def _step_leader(r: Raft, m: Message) -> None:
    if m.type == MSG_BEAT:
        r.bcast_heartbeat()
    elif m.type == MSG_PROP:
        if len(m.entries) != 1:
            raise RaftPanicError("unexpected length(entries) of a msgProp")
        e = m.entries[0]
        if e.type == ENTRY_CONF_CHANGE:
            if r.pending_conf:
                return
            r.pending_conf = True
        r.append_entry(e)
        r.bcast_append()
    elif m.type == MSG_APP_RESP:
        if m.reject:
            if r.prs[m.from_].maybe_decr_to(m.index):
                r.send_append(m.from_)
        else:
            r.prs[m.from_].update(m.index)
            if r.maybe_commit():
                r.bcast_append()
    elif m.type == MSG_VOTE:
        r.send(Message(to=m.from_, type=MSG_VOTE_RESP, reject=True))


def _step_candidate(r: Raft, m: Message) -> None:
    if m.type == MSG_PROP:
        raise RaftPanicError("no leader")
    elif m.type == MSG_APP:
        r.become_follower(r.term, m.from_)
        r.handle_append_entries(m)
    elif m.type == MSG_SNAP:
        r.become_follower(m.term, m.from_)
        r.handle_snapshot(m)
    elif m.type == MSG_VOTE:
        r.send(Message(to=m.from_, type=MSG_VOTE_RESP, reject=True))
    elif m.type == MSG_VOTE_RESP:
        gr = r.poll(m.from_, not m.reject)
        if r.q() == gr:
            r.become_leader()
            r.bcast_append()
        elif r.q() == len(r.votes) - gr:
            r.become_follower(r.term, NONE)


def _step_follower(r: Raft, m: Message) -> None:
    if m.type == MSG_PROP:
        if r.lead == NONE:
            raise RaftPanicError("no leader")
        m.to = r.lead
        r.send(m)
    elif m.type == MSG_APP:
        r.elapsed = 0
        r.lead = m.from_
        r.handle_append_entries(m)
    elif m.type == MSG_SNAP:
        r.elapsed = 0
        r.handle_snapshot(m)
    elif m.type == MSG_VOTE:
        if ((r.vote == NONE or r.vote == m.from_)
                and r.raft_log.is_up_to_date(m.index, m.log_term)):
            r.elapsed = 0
            r.vote = m.from_
            r.send(Message(to=m.from_, type=MSG_VOTE_RESP))
        else:
            r.send(Message(to=m.from_, type=MSG_VOTE_RESP, reject=True))
