"""Raft node driver: serialized access + batched Ready emission (the
port's copy of ``etcd_tpu/raft/node.py``).

The reference wraps the pure SM in a goroutine that selects over
propc/recvc/tickc/compactc/confc and emits ``Ready`` batches
(raft/node.go:190-260).  Here the same serialization is a mutex and the
Ready channel is a condition-variable pull: ``ready()`` blocks until
the SM has updates, returns the batch, and atomically performs the
consumption bookkeeping of the reference's ``case readyc <- rd`` branch
(resetNextEnts/resetUnstable/clear msgs, node.go:239-255).

Contract preserved exactly (node.go:35-61): HardState+Entries must be
persisted BEFORE Messages are sent; CommittedEntries have previously
been persisted.  Proposals block while there is no leader, mirroring
the nil-propc trick (node.go:207-215).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

from ..wire import (
    CONF_CHANGE_ADD_NODE,
    CONF_CHANGE_REMOVE_NODE,
    ConfChange,
    ENTRY_CONF_CHANGE,
    Entry,
    HardState,
    MSG_BEAT,
    MSG_HUP,
    MSG_PROP,
    Message,
    Snapshot,
    is_empty_hard_state,
    is_empty_snap,
)
from .core import NONE, Raft, SoftState


class StoppedError(Exception):
    """Operation on a stopped node (reference raft.ErrStopped)."""


@dataclass
class Ready:
    """Point-in-time batch of work for the orchestrator
    (reference raft/node.go:35-61)."""

    soft_state: SoftState | None = None
    hard_state: HardState = field(default_factory=HardState)
    entries: list[Entry] = field(default_factory=list)
    snapshot: Snapshot = field(default_factory=Snapshot)
    committed_entries: list[Entry] = field(default_factory=list)
    messages: list[Message] = field(default_factory=list)

    def contains_updates(self) -> bool:
        return (self.soft_state is not None
                or not is_empty_hard_state(self.hard_state)
                or not is_empty_snap(self.snapshot)
                or bool(self.entries)
                or bool(self.committed_entries)
                or bool(self.messages))


@dataclass(frozen=True)
class Peer:
    """Bootstrap peer (reference raft/node.go:120-123)."""

    id: int
    context: bytes = b""


def start_node(id: int, peers: list[Peer], election: int,
               heartbeat: int) -> "Node":
    """Fresh node: seed the log with ConfChangeAddNode entries for each
    peer, pre-committed (reference node.go:128-146)."""
    r = Raft(id, [], election, heartbeat)
    ents = []
    for i, peer in enumerate(peers):
        cc = ConfChange(type=CONF_CHANGE_ADD_NODE, node_id=peer.id,
                        context=peer.context)
        ents.append(Entry(type=ENTRY_CONF_CHANGE, term=1, index=i + 1,
                          data=cc.marshal()))
    r.raft_log.append(0, ents)
    r.raft_log.committed = len(ents)
    return Node(r)


def restart_node(id: int, election: int, heartbeat: int,
                 snapshot: Snapshot | None, st: HardState,
                 ents: list[Entry]) -> "Node":
    """Restart from stable storage (reference node.go:151-161)."""
    r = Raft(id, [], election, heartbeat)
    if snapshot is not None:
        r.restore(snapshot)
    if ents:
        # an empty replay must keep the restored dummy slot (load
        # replaces the whole entry array)
        r.load_ents(ents)
    # the reference's loadState guard (raft.go): a commit outside the
    # loaded log marks corrupt/mismatched storage — fail LOUDLY here
    # rather than restart as a zombie that silently skips its whole
    # apply window
    last = r.raft_log.last_index()
    if st.commit > last:
        raise ValueError(
            f"restart state.commit {st.commit} is past the loaded "
            f"log's last index {last} (corrupt or truncated storage)")
    r.load_state(st)
    return Node(r)


class Node:
    def __init__(self, r: Raft):
        self.r = r
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._stopped = False
        self._prev_soft = r.soft_state()
        self._prev_hard = r.hard_state()
        self._prev_snapi = r.raft_log.snapshot.index

    # -- inputs ------------------------------------------------------------

    def tick(self) -> None:
        """Advance the logical clock one tick (node.go:264-269)."""
        with self._cond:
            if self._stopped:
                return
            self.r.tick()
            self._cond.notify_all()

    def campaign(self, timeout: float | None = None) -> None:
        self._step_local(Message(type=MSG_HUP), timeout)

    def propose(self, data: bytes, timeout: float | None = None) -> None:
        """Blocks until a leader exists to accept the proposal
        (mirrors the propc-nil gating, node.go:207-221)."""
        self.propose_message(
            Message(type=MSG_PROP, entries=[Entry(data=data)]), timeout)

    def propose_conf_change(self, cc: ConfChange,
                            timeout: float | None = None) -> None:
        self.propose_message(
            Message(type=MSG_PROP,
                    entries=[Entry(type=ENTRY_CONF_CHANGE,
                                   data=cc.marshal())]), timeout)

    def step(self, m: Message, timeout: float | None = None) -> None:
        """Feed a message from the network; local message types are
        dropped (reference node.go:279-286)."""
        if m.type in (MSG_HUP, MSG_BEAT):
            return
        if m.type == MSG_PROP:
            self.propose_message(m, timeout)
            return
        self._step_local(m, timeout)

    def propose_message(self, m: Message,
                        timeout: float | None = None) -> None:
        """Gate on leader presence and step a proposal.  Every proposal
        — local or forwarded — is re-stamped with the local id, like
        the reference's propc case (node.go:221-223)."""
        with self._cond:
            if not self._cond.wait_for(
                    lambda: self._stopped or self.r.has_leader(),
                    timeout=timeout):
                raise TimeoutError("no leader")
            if self._stopped:
                raise StoppedError()
            m.from_ = self.r.id
            self.r.step(m)
            self._cond.notify_all()

    def _step_local(self, m: Message, timeout: float | None = None) -> None:
        with self._cond:
            if self._stopped:
                raise StoppedError()
            self.r.step(m)
            self._cond.notify_all()

    def apply_conf_change(self, cc: ConfChange) -> None:
        """Reference node.go:318-323 + run-loop confc case."""
        with self._cond:
            if self._stopped:
                return
            if cc.type == CONF_CHANGE_ADD_NODE:
                self.r.add_node(cc.node_id)
            elif cc.type == CONF_CHANGE_REMOVE_NODE:
                self.r.remove_node(cc.node_id)
            else:
                raise ValueError("unexpected conf type")
            self._cond.notify_all()

    def compact(self, index: int, nodes: list[int], d: bytes) -> None:
        with self._cond:
            if self._stopped:
                return
            self.r.compact(index, nodes, d)
            self._cond.notify_all()

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()

    @property
    def stopped(self) -> bool:
        return self._stopped

    # -- Ready pull --------------------------------------------------------

    def _new_ready(self) -> Ready:
        """Reference newReady (node.go:332-348)."""
        r = self.r
        rd = Ready(
            entries=r.raft_log.unstable_ents(),
            committed_entries=r.raft_log.next_ents(),
            messages=list(r.msgs),
        )
        soft = r.soft_state()
        if soft != self._prev_soft:
            rd.soft_state = soft
        hard = r.hard_state()
        if hard != self._prev_hard:
            rd.hard_state = hard
        if self._prev_snapi != r.raft_log.snapshot.index:
            rd.snapshot = r.raft_log.snapshot
        return rd

    def _has_updates(self) -> bool:
        """Cheap containsUpdates check — no list materialization; the
        predicate runs on every condition wakeup."""
        r = self.r
        log = r.raft_log
        return (bool(r.msgs)
                or log.unstable <= log.last_index()
                or log.committed > log.applied
                or r.soft_state() != self._prev_soft
                or r.hard_state() != self._prev_hard
                or log.snapshot.index != self._prev_snapi)

    def has_ready(self) -> bool:
        with self._lock:
            return self._has_updates()

    def ready(self, timeout: float | None = None) -> Ready | None:
        """Block until the SM has updates; consuming the Ready performs
        the reference's post-send bookkeeping (node.go:239-255).
        Returns None on stop or timeout."""
        with self._cond:
            ok = self._cond.wait_for(
                lambda: self._stopped or self._has_updates(),
                timeout=timeout)
            if self._stopped or not ok:
                return None
            rd = self._new_ready()
            if rd.soft_state is not None:
                self._prev_soft = rd.soft_state
            if not is_empty_hard_state(rd.hard_state):
                self._prev_hard = rd.hard_state
            if not is_empty_snap(rd.snapshot):
                self._prev_snapi = rd.snapshot.index
            self.r.raft_log.reset_next_ents()
            self.r.raft_log.reset_unstable()
            self.r.msgs = []
            return rd
