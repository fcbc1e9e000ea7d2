"""Array-form GroupEntry replay for multi-group restart (the port's copy
of ``etcd_tpu/server/gereplay.py``).

Walking every replayed entry with ``GroupEntry.unmarshal`` and a
winners dict would put a per-record scalar loop on the restart path (at
1M entries, the restart bottleneck).  This module keeps the whole pass
in arrays:

1. envelope fields come from ONE native sweep over the entry-data
   spans (native/walscan.cc:etcd_ge_scan; an ``EntryBlock`` needs the
   native library and raises :class:`native.NativeError` with its build
   report when it did not load),
2. last-record-wins dedup per (group, gindex) — the replay-overwrite
   semantics of wal.go:171-175 generalized to the group axis — is a
   sort + run-boundary scan,
3. frontier / ballot selection is a reverse argmax.

Payload bytes stay in the blob; only the (rare) committed winners
that actually apply to the store materialize Python objects.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import native
from ..wire import GroupEntry


@dataclass(slots=True)
class GEStream:
    """Struct-of-arrays view of a replayed GroupEntry record stream."""

    seq: np.ndarray       # int64 [N] WAL entry index per record
    kind: np.ndarray      # int64 [N]
    group: np.ndarray     # int64 [N]
    gindex: np.ndarray    # int64 [N]
    gterm: np.ndarray     # int64 [N]
    # payloads: either spans into ``blob`` or a list of bytes
    poff: np.ndarray | None
    plen: np.ndarray | None
    blob: np.ndarray | None
    plist: list | None

    def __len__(self) -> int:
        return self.kind.size

    def payload(self, i: int) -> bytes | None:
        if self.plist is not None:
            return self.plist[i]
        ln = int(self.plen[i])
        if ln == 0:
            return None
        o = int(self.poff[i])
        return self.blob[o:o + ln].tobytes()

    # -- batch selections --------------------------------------------------

    def last_of_kind(self, kind: int) -> int:
        """Position of the last record of ``kind`` (-1 if none)."""
        hits = np.nonzero(self.kind == kind)[0]
        return int(hits[-1]) if hits.size else -1

    def winner_positions(self) -> np.ndarray:
        """Positions (ascending = stream order) of the kind-0 records
        that win last-record-wins dedup for their (group, gindex)."""
        pos = np.nonzero(self.kind == 0)[0]
        if pos.size == 0:
            return pos
        key = self.group[pos].astype(np.int64) * (1 << 40) \
            + self.gindex[pos].astype(np.int64)
        order = np.argsort(key, kind="stable")
        k_sorted = key[order]
        last_in_run = np.ones(k_sorted.size, bool)
        last_in_run[:-1] = k_sorted[1:] != k_sorted[:-1]
        return np.sort(pos[order[last_in_run]])


def scan(block_or_entries, blob: np.ndarray | None = None) -> GEStream:
    """Build a :class:`GEStream` from either a replay-lane
    ``EntryBlock`` (native array sweep — no per-entry objects; raises
    :class:`native.NativeError` when the library did not load) or the
    host repair path's ``list[Entry]`` (a loop over the entries)."""
    from ..wal.replay_device import EntryBlock

    if isinstance(block_or_entries, EntryBlock):
        b = block_or_entries
        native.require()
        kind, group, gindex, gterm, poff, plen = native.ge_scan(
            b.blob, b.data_off, b.data_len)
        return GEStream(seq=b.index.astype(np.int64), kind=kind,
                        group=group, gindex=gindex, gterm=gterm,
                        poff=poff, plen=plen, blob=b.blob, plist=None)
    entries = block_or_entries

    n = len(entries)
    seq = np.empty(n, np.int64)
    kind = np.empty(n, np.int64)
    group = np.empty(n, np.int64)
    gindex = np.empty(n, np.int64)
    gterm = np.empty(n, np.int64)
    plist: list[bytes | None] = []
    for i, e in enumerate(entries):
        ge = GroupEntry.unmarshal(e.data)
        seq[i] = e.index
        kind[i] = ge.kind
        group[i] = ge.group
        gindex[i] = ge.gindex
        gterm[i] = ge.gterm
        plist.append(ge.payload)
    return GEStream(seq=seq, kind=kind, group=group, gindex=gindex,
                    gterm=gterm, poff=None, plen=None, blob=None,
                    plist=plist)


def seed_log_arrays(stream: GEStream, winners: np.ndarray,
                    frontier: np.ndarray, fterms: np.ndarray,
                    g: int, cap: int):
    """Rebuild the engine's per-group log window from the replayed
    tail, entirely in arrays.

    Returns ``(log_term [g, cap], last [g], tail_positions)`` where
    slot 0 of each row carries the frontier term, slots 1.. carry the
    CONTIGUOUS run of winner terms above the frontier (a gap ends the
    run — a non-contiguous higher entry is unreachable garbage from
    a dropped batch), and ``tail_positions`` are the stream positions
    of the retained tail entries (callers hydrate their payload
    rings from these).
    """
    log_term = np.zeros((g, cap), np.int32)
    log_term[:, 0] = fterms
    last = frontier.astype(np.int64).copy()
    if winners.size == 0:
        return log_term, last, winners
    wg = stream.group[winners]
    wi = stream.gindex[winners]
    wt = stream.gterm[winners]
    rel = wi - frontier[wg]
    tail = (rel >= 1) & (rel < cap)
    if not tail.any():
        return log_term, last, winners[:0]
    tg, tt, tr = wg[tail], wt[tail], rel[tail].astype(np.int64)
    # presence matrix + cumulative product = per-group contiguous run
    # length from slot 1 (restart-only [g, cap] scratch; 100k groups
    # x cap 1024 is ~100 MB transiently)
    pres = np.zeros((g, cap), np.uint8)
    pres[tg, tr] = 1
    runlen = np.cumprod(pres[:, 1:], axis=1).sum(
        axis=1).astype(np.int64)
    last += runlen
    keep = tr <= runlen[tg]
    log_term[tg[keep], tr[keep]] = tt[keep]
    return log_term, last, np.sort(winners[tail][keep])
