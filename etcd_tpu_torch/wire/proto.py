"""Hand-rolled protobuf wire codec for the WAL's record types and the
Raft peer messages.

The port's own copy of ``etcd_tpu/wire/proto.py``: the varint
primitives, ``Entry``, ``HardState``, ``Record``, ``Snapshot``,
``Message``, ``ConfChange``, ``SnapPb`` and the multi-group
``GroupEntry`` envelope, with the same fixed field emission order
(gogoproto ``nullable=false``: every field is written, even when zero),
so WAL and snapshot files and /raft messages written by either package
are byte-equal:

- ``Entry``      reference raft/raftpb/raft.proto:16-21
- ``HardState``  raft.proto:44-48
- ``Record``     wal/walpb/record.proto:10-14
- ``Snapshot``   raft.proto:23-29
- ``Message``    raft.proto:31-42
- ``SnapPb``     snap/snappb/snap.proto

Unmarshaling is a permissive field-number dispatch (any order, unknown
fields skipped), matching the generated Unmarshal functions.
"""

from __future__ import annotations

from dataclasses import dataclass, field

_MASK64 = (1 << 64) - 1

#: the largest length-delimited field a parse accepts
MAX_FIELD_BYTES = 1 << 30


class ProtoError(ValueError):
    pass


class CRCMismatchError(ProtoError):
    """Record CRC mismatch.  Lives at the wire layer like the
    reference's walpb.ErrCRCMismatch (wal/walpb/record.go:20)."""


# ---------------------------------------------------------------------------
# varint primitives
# ---------------------------------------------------------------------------

def put_uvarint(buf: bytearray, v: int) -> None:
    v &= _MASK64
    while v >= 0x80:
        buf.append((v & 0x7F) | 0x80)
        v >>= 7
    buf.append(v)


def _tag(data: bytes, pos: int) -> tuple[int, int, int]:
    """Read a field tag, rejecting field number 0 as the generated
    unmarshalers do ("illegal tag 0")."""
    tag, pos = uvarint(data, pos)
    fnum, wt = tag >> 3, tag & 7
    if fnum == 0:
        raise ProtoError(f"illegal tag 0 (wire type {wt})")
    return fnum, wt, pos


def uvarint(data: bytes, pos: int) -> tuple[int, int]:
    """Decode a varint at ``pos``; returns (value, new_pos)."""
    result = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise ProtoError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result & _MASK64, pos
        shift += 7
        if shift >= 70:
            raise ProtoError("varint overflow")


def _skip_field(data: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:  # varint
        _, pos = uvarint(data, pos)
        return pos
    elif wire_type == 1:  # fixed64
        pos += 8
    elif wire_type == 2:  # length-delimited
        n, pos = uvarint(data, pos)
        pos += n
    elif wire_type == 5:  # fixed32
        pos += 4
    else:
        raise ProtoError(f"unsupported wire type {wire_type}")
    if pos > len(data):
        raise ProtoError("truncated field")
    return pos


def _expect_wt(fnum: int, wt: int, want: int) -> None:
    """Known fields must carry their declared wire type: corrupt
    framing aborts instead of being skipped."""
    if wt != want:
        raise ProtoError(f"field {fnum}: wrong wire type {wt}, want {want}")


def _bytes_field(data: bytes, pos: int) -> tuple[bytes, int]:
    n, pos = uvarint(data, pos)
    if n > MAX_FIELD_BYTES:
        raise ProtoError(f"implausible gpb1.len {n} "
                         f"(cap {MAX_FIELD_BYTES})")
    if pos + n > len(data):
        raise ProtoError("truncated bytes field")
    return bytes(data[pos : pos + n]), pos + n


def _tagged_varint(buf: bytearray, tag: int, v: int) -> None:
    buf.append(tag)
    put_uvarint(buf, v)


def _tagged_bytes(buf: bytearray, tag: int, b: bytes) -> None:
    buf.append(tag)
    put_uvarint(buf, len(b))
    buf.extend(b)


ENTRY_NORMAL = 0
ENTRY_CONF_CHANGE = 1

CONF_CHANGE_ADD_NODE = 0
CONF_CHANGE_REMOVE_NODE = 1

# Raft message types (reference raft/raft.go:17-27)
MSG_HUP = 0
MSG_BEAT = 1
MSG_PROP = 2
MSG_APP = 3
MSG_APP_RESP = 4
MSG_VOTE = 5
MSG_VOTE_RESP = 6
MSG_SNAP = 7
MSG_DENIED = 8

MSG_NAMES = (
    "msgHup",
    "msgBeat",
    "msgProp",
    "msgApp",
    "msgAppResp",
    "msgVote",
    "msgVoteResp",
    "msgSnap",
    "msgDenied",
)


# ---------------------------------------------------------------------------
# messages
# ---------------------------------------------------------------------------

@dataclass(slots=True)
class Entry:
    type: int = ENTRY_NORMAL
    term: int = 0
    index: int = 0
    data: bytes = b""

    def marshal(self) -> bytes:
        buf = bytearray()
        _tagged_varint(buf, 0x08, self.type)
        _tagged_varint(buf, 0x10, self.term)
        _tagged_varint(buf, 0x18, self.index)
        _tagged_bytes(buf, 0x22, self.data)
        return bytes(buf)

    @classmethod
    def unmarshal(cls, data: bytes) -> "Entry":
        e = cls()
        pos = 0
        while pos < len(data):
            fnum, wt, pos = _tag(data, pos)
            if fnum == 1:
                _expect_wt(fnum, wt, 0)
                e.type, pos = uvarint(data, pos)
            elif fnum == 2:
                _expect_wt(fnum, wt, 0)
                e.term, pos = uvarint(data, pos)
            elif fnum == 3:
                _expect_wt(fnum, wt, 0)
                e.index, pos = uvarint(data, pos)
            elif fnum == 4:
                _expect_wt(fnum, wt, 2)
                e.data, pos = _bytes_field(data, pos)
            else:
                pos = _skip_field(data, pos, wt)
        return e


@dataclass(slots=True)
class HardState:
    term: int = 0
    vote: int = 0
    commit: int = 0

    def marshal(self) -> bytes:
        buf = bytearray()
        _tagged_varint(buf, 0x08, self.term)
        _tagged_varint(buf, 0x10, self.vote)
        _tagged_varint(buf, 0x18, self.commit)
        return bytes(buf)

    @classmethod
    def unmarshal(cls, data: bytes) -> "HardState":
        s = cls()
        pos = 0
        while pos < len(data):
            fnum, wt, pos = _tag(data, pos)
            if fnum == 1:
                _expect_wt(fnum, wt, 0)
                s.term, pos = uvarint(data, pos)
            elif fnum == 2:
                _expect_wt(fnum, wt, 0)
                s.vote, pos = uvarint(data, pos)
            elif fnum == 3:
                _expect_wt(fnum, wt, 0)
                s.commit, pos = uvarint(data, pos)
            else:
                pos = _skip_field(data, pos, wt)
        return s


EMPTY_HARD_STATE = HardState()


def is_empty_hard_state(st: HardState) -> bool:
    """Reference raft/node.go:69-76."""
    return st.term == 0 and st.vote == 0 and st.commit == 0


@dataclass(slots=True)
class Record:
    """WAL record (reference wal/walpb/record.proto:10-14).

    ``data=None`` omits field 3 entirely, mirroring the generated
    marshaler's nil check (record.pb.go:186).
    """

    type: int = 0
    crc: int = 0
    data: bytes | None = None

    def marshal(self) -> bytes:
        buf = bytearray()
        _tagged_varint(buf, 0x08, self.type)
        _tagged_varint(buf, 0x10, self.crc)
        if self.data is not None:
            _tagged_bytes(buf, 0x1A, self.data)
        return bytes(buf)

    @classmethod
    def unmarshal(cls, data: bytes) -> "Record":
        r = cls()
        pos = 0
        while pos < len(data):
            fnum, wt, pos = _tag(data, pos)
            if fnum == 1:
                _expect_wt(fnum, wt, 0)
                r.type, pos = uvarint(data, pos)
            elif fnum == 2:
                _expect_wt(fnum, wt, 0)
                r.crc, pos = uvarint(data, pos)
            elif fnum == 3:
                _expect_wt(fnum, wt, 2)
                r.data, pos = _bytes_field(data, pos)
            else:
                pos = _skip_field(data, pos, wt)
        return r


@dataclass(slots=True)
class Snapshot:
    data: bytes = b""
    nodes: list[int] = field(default_factory=list)
    index: int = 0
    term: int = 0
    removed_nodes: list[int] = field(default_factory=list)

    def marshal(self) -> bytes:
        buf = bytearray()
        _tagged_bytes(buf, 0x0A, self.data)
        for n in self.nodes:
            _tagged_varint(buf, 0x10, n)
        _tagged_varint(buf, 0x18, self.index)
        _tagged_varint(buf, 0x20, self.term)
        for n in self.removed_nodes:
            _tagged_varint(buf, 0x28, n)
        return bytes(buf)

    @classmethod
    def unmarshal(cls, data: bytes) -> "Snapshot":
        s = cls()
        pos = 0
        while pos < len(data):
            fnum, wt, pos = _tag(data, pos)
            if fnum == 1:
                _expect_wt(fnum, wt, 2)
                s.data, pos = _bytes_field(data, pos)
            elif fnum == 2:
                _expect_wt(fnum, wt, 0)
                v, pos = uvarint(data, pos)
                s.nodes.append(v)
            elif fnum == 3:
                _expect_wt(fnum, wt, 0)
                s.index, pos = uvarint(data, pos)
            elif fnum == 4:
                _expect_wt(fnum, wt, 0)
                s.term, pos = uvarint(data, pos)
            elif fnum == 5:
                _expect_wt(fnum, wt, 0)
                v, pos = uvarint(data, pos)
                s.removed_nodes.append(v)
            else:
                pos = _skip_field(data, pos, wt)
        return s

    def clone(self) -> "Snapshot":
        return Snapshot(self.data, list(self.nodes), self.index, self.term,
                        list(self.removed_nodes))


@dataclass(slots=True)
class Message:
    type: int = 0
    to: int = 0
    from_: int = 0
    term: int = 0
    log_term: int = 0
    index: int = 0
    entries: list[Entry] = field(default_factory=list)
    commit: int = 0
    snapshot: Snapshot = field(default_factory=Snapshot)
    reject: bool = False

    def marshal(self) -> bytes:
        buf = bytearray()
        _tagged_varint(buf, 0x08, self.type)
        _tagged_varint(buf, 0x10, self.to)
        _tagged_varint(buf, 0x18, self.from_)
        _tagged_varint(buf, 0x20, self.term)
        _tagged_varint(buf, 0x28, self.log_term)
        _tagged_varint(buf, 0x30, self.index)
        for e in self.entries:
            _tagged_bytes(buf, 0x3A, e.marshal())
        _tagged_varint(buf, 0x40, self.commit)
        _tagged_bytes(buf, 0x4A, self.snapshot.marshal())
        _tagged_varint(buf, 0x50, 1 if self.reject else 0)
        return bytes(buf)

    @classmethod
    def unmarshal(cls, data: bytes) -> "Message":
        m = cls()
        pos = 0
        while pos < len(data):
            fnum, wt, pos = _tag(data, pos)
            if fnum == 1:
                _expect_wt(fnum, wt, 0)
                m.type, pos = uvarint(data, pos)
            elif fnum == 2:
                _expect_wt(fnum, wt, 0)
                m.to, pos = uvarint(data, pos)
            elif fnum == 3:
                _expect_wt(fnum, wt, 0)
                m.from_, pos = uvarint(data, pos)
            elif fnum == 4:
                _expect_wt(fnum, wt, 0)
                m.term, pos = uvarint(data, pos)
            elif fnum == 5:
                _expect_wt(fnum, wt, 0)
                m.log_term, pos = uvarint(data, pos)
            elif fnum == 6:
                _expect_wt(fnum, wt, 0)
                m.index, pos = uvarint(data, pos)
            elif fnum == 7:
                _expect_wt(fnum, wt, 2)
                b, pos = _bytes_field(data, pos)
                m.entries.append(Entry.unmarshal(b))
            elif fnum == 8:
                _expect_wt(fnum, wt, 0)
                m.commit, pos = uvarint(data, pos)
            elif fnum == 9:
                _expect_wt(fnum, wt, 2)
                b, pos = _bytes_field(data, pos)
                m.snapshot = Snapshot.unmarshal(b)
            elif fnum == 10:
                _expect_wt(fnum, wt, 0)
                v, pos = uvarint(data, pos)
                m.reject = bool(v)
            else:
                pos = _skip_field(data, pos, wt)
        return m



def is_empty_snap(sp: Snapshot) -> bool:
    """Reference raft/node.go:79-81."""
    return sp.index == 0



@dataclass(slots=True)
class ConfChange:
    id: int = 0
    type: int = CONF_CHANGE_ADD_NODE
    node_id: int = 0
    context: bytes = b""

    def marshal(self) -> bytes:
        buf = bytearray()
        _tagged_varint(buf, 0x08, self.id)
        _tagged_varint(buf, 0x10, self.type)
        _tagged_varint(buf, 0x18, self.node_id)
        _tagged_bytes(buf, 0x22, self.context)
        return bytes(buf)

    @classmethod
    def unmarshal(cls, data: bytes) -> "ConfChange":
        c = cls()
        pos = 0
        while pos < len(data):
            fnum, wt, pos = _tag(data, pos)
            if fnum == 1:
                _expect_wt(fnum, wt, 0)
                c.id, pos = uvarint(data, pos)
            elif fnum == 2:
                _expect_wt(fnum, wt, 0)
                c.type, pos = uvarint(data, pos)
            elif fnum == 3:
                _expect_wt(fnum, wt, 0)
                c.node_id, pos = uvarint(data, pos)
            elif fnum == 4:
                _expect_wt(fnum, wt, 2)
                c.context, pos = _bytes_field(data, pos)
            else:
                pos = _skip_field(data, pos, wt)
        return c



@dataclass(slots=True)
class GroupEntry:
    """Multi-group WAL envelope (new work — no reference counterpart:
    the reference runs ONE raft group per process, so its WAL needs no
    group axis; the co-hosted server multiplexes G groups into one
    record stream, keeping file count O(1) and the whole log
    replayable as a single device batch).

    ``kind``: 0 = a group's log entry (payload = marshaled Request),
    1 = commit-frontier marker (payload = the [G] i32-LE commit vector
    followed by the [G] i32-LE term-at-commit vector).
    """

    kind: int = 0
    group: int = 0
    gindex: int = 0
    gterm: int = 0
    payload: bytes | None = None

    def marshal(self) -> bytes:
        buf = bytearray()
        _tagged_varint(buf, 0x08, self.kind)
        _tagged_varint(buf, 0x10, self.group)
        _tagged_varint(buf, 0x18, self.gindex)
        _tagged_varint(buf, 0x20, self.gterm)
        if self.payload is not None:
            _tagged_bytes(buf, 0x2A, self.payload)
        return bytes(buf)

    @classmethod
    def unmarshal(cls, data: bytes) -> "GroupEntry":
        ge = cls()
        pos = 0
        while pos < len(data):
            fnum, wt, pos = _tag(data, pos)
            if fnum == 1:
                _expect_wt(fnum, wt, 0)
                ge.kind, pos = uvarint(data, pos)
            elif fnum == 2:
                _expect_wt(fnum, wt, 0)
                ge.group, pos = uvarint(data, pos)
            elif fnum == 3:
                _expect_wt(fnum, wt, 0)
                ge.gindex, pos = uvarint(data, pos)
            elif fnum == 4:
                _expect_wt(fnum, wt, 0)
                ge.gterm, pos = uvarint(data, pos)
            elif fnum == 5:
                _expect_wt(fnum, wt, 2)
                ge.payload, pos = _bytes_field(data, pos)
            else:
                pos = _skip_field(data, pos, wt)
        return ge


def marshal_group_entries(kind: int, groups, gindexes, gterms,
                          payloads) -> list[bytes]:
    """Batch-marshal GroupEntry envelopes without constructing the
    dataclass per record (the serving loop's WAL record builder runs
    this for every entry of every group in a frame, which hoists
    the per-record object churn out of that hot loop).  Byte-
    identical to ``GroupEntry(...).marshal()`` element-wise: all four
    varint fields are always written and a payload is written iff it
    is not None (``b""`` included)."""
    out = []
    for g, gi, gt, p in zip(groups, gindexes, gterms, payloads):
        buf = bytearray()
        _tagged_varint(buf, 0x08, kind)
        _tagged_varint(buf, 0x10, g)
        _tagged_varint(buf, 0x18, gi)
        _tagged_varint(buf, 0x20, gt)
        if p is not None:
            _tagged_bytes(buf, 0x2A, p)
        out.append(bytes(buf))
    return out



@dataclass(slots=True)
class SnapPb:
    """Snapshot file wrapper (reference snap/snappb/snap.proto).

    ``data=None`` omits field 2, mirroring snap.pb.go:165.
    """

    crc: int = 0
    data: bytes | None = None

    def marshal(self) -> bytes:
        buf = bytearray()
        _tagged_varint(buf, 0x08, self.crc)
        if self.data is not None:
            _tagged_bytes(buf, 0x12, self.data)
        return bytes(buf)

    @classmethod
    def unmarshal(cls, data: bytes) -> "SnapPb":
        s = cls()
        pos = 0
        while pos < len(data):
            fnum, wt, pos = _tag(data, pos)
            if fnum == 1:
                _expect_wt(fnum, wt, 0)
                s.crc, pos = uvarint(data, pos)
            elif fnum == 2:
                _expect_wt(fnum, wt, 2)
                s.data, pos = _bytes_field(data, pos)
            else:
                pos = _skip_field(data, pos, wt)
        return s
