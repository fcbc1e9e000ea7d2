"""Array-form GroupEntry replay for multi-group restart (the port's copy
of ``etcd_tpu/server/gereplay.py``, less ``seed_log_arrays``, which only
the distributed server calls).

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

