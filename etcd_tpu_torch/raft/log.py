"""Raft log: contiguous entry array with offset (reference raft/log.go;
the port's copy of ``etcd_tpu/raft/log.py``).

The host-parity structure.  The batched device engine (batched.py)
holds the same state as [G, capacity] tensors with explicit offset and
length vectors; the semantics here are the executable specification the
array ops are tested against.
"""

from __future__ import annotations

from ..wire import Entry, Snapshot

DEFAULT_COMPACT_THRESHOLD = 10000  # reference raft/log.go:10


class LogError(Exception):
    """Out-of-contract log operation (the reference panics)."""


class RaftLog:
    def __init__(self) -> None:
        # index 0 holds a dummy entry used only for term matching
        self.ents: list[Entry] = [Entry()]
        self.unstable = 0
        self.committed = 0
        self.applied = 0
        self.offset = 0
        self.snapshot = Snapshot()
        self.compact_threshold = DEFAULT_COMPACT_THRESHOLD

    def is_empty(self) -> bool:
        return self.offset == 0 and len(self.ents) == 1

    def load(self, ents: list[Entry]) -> None:
        """Install replayed entries (reference log.go:40-43)."""
        self.ents = ents
        self.unstable = self.offset + len(ents)

    def __repr__(self) -> str:
        return (f"offset={self.offset} committed={self.committed} "
                f"applied={self.applied} len(ents)={len(self.ents)}")

    def maybe_append(self, index: int, log_term: int, committed: int,
                     ents: list[Entry]) -> bool:
        """Follower-side append with conflict truncation
        (reference log.go:49-69)."""
        lastnewi = index + len(ents)
        if self.match_term(index, log_term):
            from_ = index + 1
            ci = self.find_conflict(from_, ents)
            if ci == 0:
                pass
            elif ci <= self.committed:
                raise LogError("conflict with committed entry")
            else:
                self.append(ci - 1, ents[ci - from_:])
            tocommit = min(committed, lastnewi)
            if self.committed < tocommit:
                self.committed = tocommit
            return True
        return False

    def append(self, after: int, ents: list[Entry]) -> int:
        """Truncate to ``after`` then append (reference log.go:71-75)."""
        self.ents = self.slice(self.offset, after + 1) + list(ents)
        self.unstable = min(self.unstable, after + 1)
        return self.last_index()

    def find_conflict(self, from_: int, ents: list[Entry]) -> int:
        """First index whose term mismatches, 0 if none
        (reference log.go:77-84)."""
        for i, ne in enumerate(ents):
            oe = self.at(from_ + i)
            if oe is None or oe.term != ne.term:
                return from_ + i
        return 0

    def unstable_ents(self) -> list[Entry]:
        ents = self.slice(self.unstable, self.last_index() + 1)
        return list(ents)

    def reset_unstable(self) -> None:
        self.unstable = self.last_index() + 1

    def next_ents(self) -> list[Entry]:
        """Committed-but-unapplied entries (reference log.go:102-107)."""
        if self.committed > self.applied:
            return self.slice(self.applied + 1, self.committed + 1)
        return []

    def reset_next_ents(self) -> None:
        if self.committed > self.applied:
            self.applied = self.committed

    def last_index(self) -> int:
        return len(self.ents) - 1 + self.offset

    def term(self, i: int) -> int:
        e = self.at(i)
        return e.term if e is not None else 0

    def entries(self, i: int) -> list[Entry]:
        """Entries from i; never the first (match-only) entry
        (reference log.go:126-134)."""
        if i == self.offset:
            raise LogError("cannot return the first entry in log")
        return self.slice(i, self.last_index() + 1)

    def is_up_to_date(self, i: int, term: int) -> bool:
        e = self.at(self.last_index())
        return term > e.term or (term == e.term and i >= self.last_index())

    def match_term(self, i: int, term: int) -> bool:
        e = self.at(i)
        return e is not None and e.term == term

    def maybe_commit(self, max_index: int, term: int) -> bool:
        if max_index > self.committed and self.term(max_index) == term:
            self.committed = max_index
            return True
        return False

    def compact(self, i: int) -> int:
        """Drop entries before i (reference log.go:161-169)."""
        if self._is_out_of_applied_bounds(i):
            raise LogError(
                f"compact {i} out of bounds [{self.offset}:{self.applied}]")
        self.ents = self.slice(i, self.last_index() + 1)
        self.unstable = max(i + 1, self.unstable)
        self.offset = i
        return len(self.ents)

    def snap(self, d: bytes, index: int, term: int, nodes: list[int],
             removed: list[int]) -> None:
        self.snapshot = Snapshot(data=d, nodes=list(nodes), index=index,
                                 term=term, removed_nodes=list(removed))

    def should_compact(self) -> bool:
        return (self.applied - self.offset) > self.compact_threshold

    def restore(self, s: Snapshot) -> None:
        """Reset the log to a snapshot point (reference log.go:185-192)."""
        self.ents = [Entry(term=s.term)]
        self.unstable = s.index + 1
        self.committed = s.index
        self.applied = s.index
        self.offset = s.index
        self.snapshot = s

    def at(self, i: int) -> Entry | None:
        if self._is_out_of_bounds(i):
            return None
        return self.ents[i - self.offset]

    def slice(self, lo: int, hi: int) -> list[Entry]:
        """Entries [lo, hi); empty on any out-of-bounds
        (reference log.go:202-210)."""
        if lo >= hi:
            return []
        if self._is_out_of_bounds(lo) or self._is_out_of_bounds(hi - 1):
            return []
        return self.ents[lo - self.offset : hi - self.offset]

    def _is_out_of_bounds(self, i: int) -> bool:
        return i < self.offset or i > self.last_index()

    def _is_out_of_applied_bounds(self, i: int) -> bool:
        return i < self.offset or i > self.applied
