"""Batched inter-host consensus frames for the distributed
multi-group server (SURVEY §5.8's DCN tier).

The reference's peer transport ships ONE raftpb.Message per HTTP POST
(etcdserver/cluster_store.go:106-156).  The distributed multi-group
server hosts one member slot of ALL G co-hosted groups per process,
so a replication round produces G messages *per peer* — shipped here
as ONE binary frame of [G] arrays (the batched analog: same
fire-and-forget, drop-tolerant contract, server.go:202-206, but the
unit of transport is the whole group batch).

Frame = 24-byte header + fixed [G] sections + payload table:

  header:  magic "DGB2" | kind u8 | sender_slot u8 | flags u16 |
           g u32 | e u32 | seq u32 | epoch u32
  body:    kind-specific little-endian arrays (see each class);
           i32 sections lead so every array lands 4-aligned, u8
           masks trail
  payload: lens [sum(n_ents)] i32 + concatenated blobs (appends only)

``seq``/``epoch`` are the PIPELINE tags: the leader numbers
every append frame per peer (seq) within a leadership epoch (bumped
whenever the local leadership set changes), and the follower echoes
both into its response — acks may then return OUT OF ORDER over
striped connections and still be matched to the exact in-flight
frame, with duplicate and stale-epoch responses rejected instead of
corrupting progress state.  Vote frames carry zeros (the campaign
round-trip stays lockstep).

Arrays are raw numpy little-endian — the receiving end feeds them
straight into the batched engine (raft/batched.py) without a decode
loop: wire layout == device layout is the point.

Copy discipline: ``marshal`` writes every section straight into ONE
preallocated bytearray (no intermediate ``tobytes``/join garbage —
at depth-8 pipelining the old form allocated ~10 temporaries per
frame per peer), and ``unmarshal`` returns ``np.frombuffer`` views
over the received buffer (read-only; the engine copies on device
put).  Payload blobs are the one deliberate copy on unpack: they
outlive the frame buffer in the host payload ring, and a memoryview
would pin the whole frame.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from .schema import DGB2, FrameError, check_bound

__all__ = [
    "FrameError", "AppendBatch", "AppendResp", "VoteReq", "VoteResp",
    "PackedPayloads", "parse_header", "unmarshal_any",
    "flat_entry_table", "KIND_APPEND", "KIND_APPEND_RESP",
    "KIND_VOTE", "KIND_VOTE_RESP", "KIND_PROPOSE", "FLAG_TRACE",
    "FLAG_PACKED",
]

# layout constants come from the declarative schema (wire/schema.py)
# — the schema-drift checker fails lint on a locally re-declared
# struct/magic literal in this module
_MAGIC = DGB2.magic
_HDR = DGB2.header_struct()

_KINDS = DGB2.kind_values()
KIND_APPEND = _KINDS["KIND_APPEND"]
KIND_APPEND_RESP = _KINDS["KIND_APPEND_RESP"]
KIND_VOTE = _KINDS["KIND_VOTE"]
KIND_VOTE_RESP = _KINDS["KIND_VOTE_RESP"]
KIND_PROPOSE = _KINDS["KIND_PROPOSE"]

# Header flag bits.  FLAG_TRACE: the frame carries an
# OPTIONAL trace block AFTER the payload table — (group, gindex,
# trace_id, origin) per head-sampled entry, the distributed-trace
# context followers stamp their span events with.  Versioning is
# structural: an old peer ignores unknown flag bits and never reads
# past the sections it knows (trailing bytes are ignored), so a
# traced frame parses on old peers exactly as an untraced one; an
# untraced frame (flags=0) is BYTE-IDENTICAL to the pre-trace
# layout, so new peers interop with old senders for free.
_FLAG_BITS = {f.name: f.bit for f in DGB2.flags}
FLAG_TRACE = _FLAG_BITS["FLAG_TRACE"]

# FLAG_PACKED: the frame carries an OPTIONAL flat entry
# table AFTER the payload blobs (and after the trace block when both
# are present — trailing sections appear in flag-bit order):
#
#   u32 total | ent_group [total] i32 | ent_gindex [total] i32
#
# One row per carried entry, in frame order: the group lane and the
# absolute group index (prev_idx[g]+1+j) of each payload blob.  The
# receiver's serving loop consumes entries FLAT — one pass over the
# table builds every WAL record and stores every payload without a
# per-group dict hop.  The table is redundant with (prev_idx,
# n_ents), which is exactly why it is validated on unmarshal (count,
# range, per-lane histogram): a corrupted table cannot disagree with
# the [G] sections without failing typed as FrameError.  Same
# structural versioning as FLAG_TRACE: old peers ignore the bit and
# the trailing bytes; an unpacked frame is byte-identical to DGB2.
FLAG_PACKED = _FLAG_BITS["FLAG_PACKED"]

#: one trace entry: group i32, gindex i32, trace_id u32, origin u8
#: (+3 pad — keeps entries 16-byte and the block 4-aligned)
_TRACE_ENT = struct.Struct(DGB2.structs["_TRACE_ENT"])


def _view_i32(data, pos: int, n: int) -> tuple[np.ndarray, int]:
    """Read-only [n] i32 view over the frame buffer (no copy)."""
    end = pos + 4 * n
    if end > len(data):
        raise FrameError("truncated i32 section")
    return np.frombuffer(data, "<i4", count=n, offset=pos), end


def _view_u8(data, pos: int, n: int) -> tuple[np.ndarray, int]:
    end = pos + n
    if end > len(data):
        raise FrameError("truncated u8 section")
    return np.frombuffer(data, np.uint8, count=n, offset=pos), end


def _w_i32(buf: bytearray, pos: int, arr) -> int:
    """Write ``arr`` as little-endian i32 straight into ``buf`` at
    ``pos`` (the preallocated-frame write path: one cast-assign into
    a frombuffer view, no intermediate bytes object)."""
    a = np.asarray(arr)
    n = a.size
    if n:
        np.frombuffer(buf, "<i4", count=n, offset=pos)[:] = a.ravel()
    return pos + 4 * n


def _w_u8(buf: bytearray, pos: int, arr) -> int:
    a = np.asarray(arr)
    n = a.size
    if n:
        np.frombuffer(buf, np.uint8, count=n,
                      offset=pos)[:] = a.ravel()
    return pos + n


def parse_header(data) -> tuple[int, int, int, int, int, int, int]:
    """Returns (kind, sender_slot, g, e, seq, epoch, flags); raises
    FrameError."""
    if len(data) < _HDR.size:
        raise FrameError("short frame")
    magic, kind, sender, flags, g, e, seq, epoch = \
        _HDR.unpack_from(data)
    if magic != _MAGIC:
        raise FrameError("bad magic")
    check_bound("dgb2.groups", g)
    check_bound("dgb2.ents_per_lane", e)
    return kind, sender, g, e, seq, epoch, flags


def _read_trace(
        data, pos: int) -> tuple[list[tuple[int, int, int, int]], int]:
    """Parse the optional trailing trace block at ``pos`` (the
    FLAG_TRACE bit was set).  Raises FrameError on truncation or an
    implausible count — a flipped flag bit must fail typed, never
    escape as IndexError/struct.error."""
    if pos + 4 > len(data):
        raise FrameError("truncated trace block")
    (n,) = struct.unpack_from("<I", data, pos)
    pos += 4
    check_bound("dgb2.trace_count", n)
    end = pos + n * _TRACE_ENT.size
    if end > len(data):
        raise FrameError("truncated trace block")
    out = []
    for _ in range(n):
        g, gi, tid, org = _TRACE_ENT.unpack_from(data, pos)
        out.append((g, gi, tid, org))
        pos += _TRACE_ENT.size
    return out, pos


def _read_packed(data, pos: int, prev_idx, n_ents,
                 total: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Parse + validate the trailing FLAG_PACKED entry table.  The
    table is fully determined by (prev_idx, n_ents) — row k of lane
    g MUST be (g, prev_idx[g]+1+j) in frame order — so it is checked
    for exact equality against the recomputed layout: a mutated
    table fails typed here instead of mis-routing entries in the
    receiver's flat store loop, and downstream consumers may index
    ent_terms[group, gindex-prev_idx-1] without re-validating."""
    if pos + 4 > len(data):
        raise FrameError("truncated packed table")
    (n,) = struct.unpack_from("<I", data, pos)
    pos += 4
    if n != total:
        raise FrameError(
            f"packed table count {n} != sum(n_ents) {total}")
    groups, pos = _view_i32(data, pos, n)
    gindex, pos = _view_i32(data, pos, n)
    exp_g, exp_i = flat_entry_table(prev_idx, n_ents)
    if not (np.array_equal(groups, exp_g)
            and np.array_equal(gindex, exp_i)):
        raise FrameError("packed table disagrees with [G] sections")
    return groups, gindex, pos


class PackedPayloads:
    """Flat payload storage for an AppendBatch: one ``list[bytes]``
    in frame order plus a [G+1] starts table (cumsum of n_ents).
    Indexing by group returns that lane's blob list, so existing
    per-group consumers keep working, but batch consumers iterate
    ``flat`` directly — no nested list-of-lists allocation per frame.
    ``unmarshal`` always returns this form."""

    __slots__ = ("flat", "starts")

    def __init__(self, flat: list[bytes], starts: np.ndarray):
        self.flat = flat
        self.starts = starts

    @classmethod
    def from_counts(cls, flat: list[bytes],
                    n_ents) -> "PackedPayloads":
        n = np.asarray(n_ents, np.int64)
        starts = np.zeros(n.shape[0] + 1, np.int64)
        np.cumsum(n, out=starts[1:])
        return cls(flat, starts)

    def __len__(self) -> int:
        return self.starts.shape[0] - 1

    def __getitem__(self, gi: int) -> list[bytes]:
        return self.flat[int(self.starts[gi]):
                         int(self.starts[gi + 1])]

    def __eq__(self, other) -> bool:
        if isinstance(other, PackedPayloads):
            return (self.flat == other.flat
                    and np.array_equal(self.starts, other.starts))
        if isinstance(other, (list, tuple)):
            return (len(other) == len(self)
                    and all(self[gi] == list(other[gi])
                            for gi in range(len(self))))
        return NotImplemented

    def __repr__(self) -> str:  # debugging aid only
        return f"PackedPayloads({len(self.flat)} blobs/{len(self)} groups)"


def flat_entry_table(prev_idx,
                     n_ents) -> tuple[np.ndarray, np.ndarray]:
    """Build the FLAG_PACKED (ent_group, ent_gindex) table for a
    frame carrying n_ents[g] entries per lane starting at
    prev_idx[g]+1 — all vectorized, no per-group host loop."""
    n = np.asarray(n_ents, np.int64)
    g = n.shape[0]
    total = int(n.sum())
    starts = np.zeros(g + 1, np.int64)
    np.cumsum(n, out=starts[1:])
    groups = np.repeat(np.arange(g, dtype=np.int32), n)
    j = np.arange(total, dtype=np.int64) - starts[groups]
    gindex = np.asarray(prev_idx, np.int64)[groups] + 1 + j
    return groups, gindex.astype(np.int32)


def _write_trace(buf: bytearray, pos: int, trace) -> int:
    struct.pack_into("<I", buf, pos, len(trace))
    pos += 4
    for g, gi, tid, org in trace:
        _TRACE_ENT.pack_into(buf, pos, g, gi, tid & 0xFFFFFFFF,
                             org & 0xFF)
        pos += _TRACE_ENT.size
    return pos


@dataclass
class AppendBatch:
    """Leader → follower replication round for all G groups at once
    (the batched msgApp, raft.proto:31-42 fields term/index/logTerm/
    entries/commit, G-wide).

    ``active[g]``: this frame carries an append for group g.
    ``need_snap[g]``: the leader has compacted past the follower's
    next index — follower must pull a full snapshot (the msgSnap
    analog, raft.go:207-209, as a pull to keep round frames small).
    ``ent_terms[g, j]``: term of entry prev_idx[g]+1+j, j < n_ents[g].
    ``payloads[g][j]``: that entry's opaque payload bytes.
    ``seq``/``epoch``: pipeline frame tags (module docstring).
    """

    sender: int
    term: np.ndarray        # [G] i32 leader term
    prev_idx: np.ndarray    # [G] i32
    prev_term: np.ndarray   # [G] i32
    n_ents: np.ndarray      # [G] i32
    commit: np.ndarray      # [G] i32 leader commit
    active: np.ndarray      # [G] bool
    need_snap: np.ndarray   # [G] bool
    ent_terms: np.ndarray   # [G, E] i32
    payloads: "list[list[bytes]] | PackedPayloads" = \
        field(default_factory=list)
    seq: int = 0
    epoch: int = 0
    #: optional distributed-trace block: (group, gindex,
    #: trace_id, origin) per head-sampled entry this frame carries.
    #: None/[] marshals the exact pre-trace layout (flags=0).
    trace: list[tuple[int, int, int, int]] | None = None
    #: optional FLAG_PACKED flat entry table: the group lane
    #: and absolute group index of each carried payload, frame order.
    #: Both or neither; None marshals the exact DGB2 layout.
    ent_group: np.ndarray | None = None   # [total] i32
    ent_gindex: np.ndarray | None = None  # [total] i32

    def marshal(self) -> bytearray:
        g = self.term.shape[0]
        e = self.ent_terms.shape[1] if self.ent_terms.size else 0
        n_ents = np.asarray(self.n_ents)
        flat: list[bytes]
        if isinstance(self.payloads, PackedPayloads):
            flat = self.payloads.flat
            if len(flat) != int(n_ents.sum()):
                raise FrameError("payloads disagree with n_ents")
        else:
            flat = []
            for gi in range(g):
                row = self.payloads[gi] if self.payloads else []
                for j in range(int(n_ents[gi])):
                    flat.append(row[j] if j < len(row) else b"")
        lens = [len(b) for b in flat]
        blob_total = sum(lens)
        trace = self.trace or None
        packed = self.ent_group is not None
        flags = ((FLAG_TRACE if trace else 0)
                 | (FLAG_PACKED if packed else 0))
        tr_bytes = (4 + _TRACE_ENT.size * len(trace)) if trace else 0
        pk_bytes = (4 + 8 * len(lens)) if packed else 0
        out = bytearray(_HDR.size + (5 * g + g * e + len(lens)) * 4
                        + 2 * g + blob_total + tr_bytes + pk_bytes)
        _HDR.pack_into(out, 0, _MAGIC, KIND_APPEND, self.sender,
                       flags, g, e, self.seq & 0xFFFFFFFF,
                       self.epoch & 0xFFFFFFFF)
        pos = _HDR.size
        pos = _w_i32(out, pos, self.term)
        pos = _w_i32(out, pos, self.prev_idx)
        pos = _w_i32(out, pos, self.prev_term)
        pos = _w_i32(out, pos, n_ents)
        pos = _w_i32(out, pos, self.commit)
        pos = _w_i32(out, pos, self.ent_terms)
        pos = _w_i32(out, pos, np.asarray(lens, "<i4"))
        pos = _w_u8(out, pos, self.active)
        pos = _w_u8(out, pos, self.need_snap)
        for b in flat:
            out[pos:pos + len(b)] = b
            pos += len(b)
        if trace:
            pos = _write_trace(out, pos, trace)
        if packed:
            struct.pack_into("<I", out, pos, len(lens))
            pos += 4
            pos = _w_i32(out, pos, self.ent_group)
            pos = _w_i32(out, pos, self.ent_gindex)
        return out

    @classmethod
    def unmarshal(cls, data) -> "AppendBatch":
        kind, sender, g, e, seq, epoch, flags = parse_header(data)
        if kind != KIND_APPEND:
            raise FrameError(f"kind {kind} != append")
        pos = _HDR.size
        term, pos = _view_i32(data, pos, g)
        prev_idx, pos = _view_i32(data, pos, g)
        prev_term, pos = _view_i32(data, pos, g)
        n_ents, pos = _view_i32(data, pos, g)
        commit, pos = _view_i32(data, pos, g)
        ets, pos = _view_i32(data, pos, g * e)
        if (n_ents < 0).any():
            # per-lane, not just the sum: one negative and one large
            # positive lane cancel to a small total but would spin
            # the payload loop for ~2^31 iterations before dying on
            # an IndexError instead of a FrameError
            raise FrameError("negative entry count")
        total = int(n_ents.sum())
        check_bound("dgb2.total_entries", total)
        lens, pos = _view_i32(data, pos, total)
        if total:
            check_bound("dgb2.payload_len", int(lens.max()))
        active, pos = _view_u8(data, pos, g)
        need_snap, pos = _view_u8(data, pos, g)
        buf = memoryview(data)
        # flat single-loop payload parse: blob order on the wire IS
        # frame order, so there is no per-group inner loop to run —
        # the nested view is recovered lazily via PackedPayloads
        flat: list[bytes] = []
        for li in range(total):
            ln = int(lens[li])
            if ln < 0 or pos + ln > len(data):
                raise FrameError("truncated payload blob")
            flat.append(bytes(buf[pos:pos + ln]))
            pos += ln
        payloads = PackedPayloads.from_counts(flat, n_ents)
        trace = None
        if flags & FLAG_TRACE:
            trace, pos = _read_trace(data, pos)
        ent_group = ent_gindex = None
        if flags & FLAG_PACKED:
            ent_group, ent_gindex, pos = _read_packed(
                data, pos, prev_idx, n_ents, total)
        return cls(sender=sender, term=term, prev_idx=prev_idx,
                   prev_term=prev_term, n_ents=n_ents, commit=commit,
                   active=active.astype(bool),
                   need_snap=need_snap.astype(bool),
                   ent_terms=ets.reshape(g, e), payloads=payloads,
                   seq=seq, epoch=epoch, trace=trace,
                   ent_group=ent_group, ent_gindex=ent_gindex)


@dataclass
class AppendResp:
    """Follower → leader batched msgAppResp.

    ``acked[g]``: on success, the follower's new match index; on
    reject, ignored.  ``hint[g]``: the follower's commit index — the
    leader repairs next_ to hint+1 on reject (faster than the
    reference's decrement-by-one probe, raft.go:464-470; safe because
    the committed prefix always matches).  ``seq``/``epoch`` echo the
    AppendBatch this responds to (pipeline ack matching)."""

    sender: int
    term: np.ndarray    # [G] i32 follower term (leader steps down if >)
    ok: np.ndarray      # [G] bool
    acked: np.ndarray   # [G] i32
    hint: np.ndarray    # [G] i32
    active: np.ndarray  # [G] bool
    seq: int = 0
    epoch: int = 0
    # LOCAL-ONLY (never marshalled): lanes whose entries the engine
    # actually appended this frame.  ``ok`` also covers need_snap
    # positive acks, which carry no entries — the follower's persist
    # loop must write exactly what was appended, so it iterates this
    # mask, not ``ok``.
    appended: np.ndarray | None = None

    def marshal(self) -> bytearray:
        g = self.term.shape[0]
        out = bytearray(_HDR.size + 3 * 4 * g + 2 * g)
        _HDR.pack_into(out, 0, _MAGIC, KIND_APPEND_RESP, self.sender,
                       0, g, 0, self.seq & 0xFFFFFFFF,
                       self.epoch & 0xFFFFFFFF)
        pos = _HDR.size
        pos = _w_i32(out, pos, self.term)
        pos = _w_i32(out, pos, self.acked)
        pos = _w_i32(out, pos, self.hint)
        pos = _w_u8(out, pos, self.ok)
        pos = _w_u8(out, pos, self.active)
        return out

    @classmethod
    def unmarshal(cls, data) -> "AppendResp":
        kind, sender, g, _e, seq, epoch, _flags = parse_header(data)
        if kind != KIND_APPEND_RESP:
            raise FrameError(f"kind {kind} != append_resp")
        pos = _HDR.size
        term, pos = _view_i32(data, pos, g)
        acked, pos = _view_i32(data, pos, g)
        hint, pos = _view_i32(data, pos, g)
        ok, pos = _view_u8(data, pos, g)
        active, pos = _view_u8(data, pos, g)
        return cls(sender=sender, term=term, ok=ok.astype(bool),
                   acked=acked, hint=hint,
                   active=active.astype(bool), seq=seq, epoch=epoch)


@dataclass
class VoteReq:
    """Candidate → peer batched msgVote (raft.go:363-369)."""

    sender: int
    term: np.ndarray    # [G] i32 candidate term
    last: np.ndarray    # [G] i32 candidate last index
    lterm: np.ndarray   # [G] i32 candidate last term
    active: np.ndarray  # [G] bool

    def marshal(self) -> bytearray:
        g = self.term.shape[0]
        out = bytearray(_HDR.size + 3 * 4 * g + g)
        _HDR.pack_into(out, 0, _MAGIC, KIND_VOTE, self.sender, 0,
                       g, 0, 0, 0)
        pos = _HDR.size
        pos = _w_i32(out, pos, self.term)
        pos = _w_i32(out, pos, self.last)
        pos = _w_i32(out, pos, self.lterm)
        pos = _w_u8(out, pos, self.active)
        return out

    @classmethod
    def unmarshal(cls, data) -> "VoteReq":
        kind, sender, g, _e, _seq, _epoch, _fl = parse_header(data)
        if kind != KIND_VOTE:
            raise FrameError(f"kind {kind} != vote")
        pos = _HDR.size
        term, pos = _view_i32(data, pos, g)
        last, pos = _view_i32(data, pos, g)
        lterm, pos = _view_i32(data, pos, g)
        active, pos = _view_u8(data, pos, g)
        return cls(sender=sender, term=term, last=last, lterm=lterm,
                   active=active.astype(bool))


@dataclass
class VoteResp:
    """Peer → candidate batched msgVoteResp."""

    sender: int
    term: np.ndarray     # [G] i32 responder term
    granted: np.ndarray  # [G] bool
    active: np.ndarray   # [G] bool

    def marshal(self) -> bytearray:
        g = self.term.shape[0]
        out = bytearray(_HDR.size + 4 * g + 2 * g)
        _HDR.pack_into(out, 0, _MAGIC, KIND_VOTE_RESP, self.sender,
                       0, g, 0, 0, 0)
        pos = _HDR.size
        pos = _w_i32(out, pos, self.term)
        pos = _w_u8(out, pos, self.granted)
        pos = _w_u8(out, pos, self.active)
        return out

    @classmethod
    def unmarshal(cls, data) -> "VoteResp":
        kind, sender, g, _e, _seq, _epoch, _fl = parse_header(data)
        if kind != KIND_VOTE_RESP:
            raise FrameError(f"kind {kind} != vote_resp")
        pos = _HDR.size
        term, pos = _view_i32(data, pos, g)
        granted, pos = _view_u8(data, pos, g)
        active, pos = _view_u8(data, pos, g)
        return cls(sender=sender, term=term,
                   granted=granted.astype(bool),
                   active=active.astype(bool))


def unmarshal_any(data):
    kind, *_ = parse_header(data)
    try:
        cls = {KIND_APPEND: AppendBatch,
               KIND_APPEND_RESP: AppendResp,
               KIND_VOTE: VoteReq,
               KIND_VOTE_RESP: VoteResp}[kind]
    except KeyError:
        raise FrameError(f"unknown frame kind {kind}") from None
    return cls.unmarshal(data)
