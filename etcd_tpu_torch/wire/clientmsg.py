"""Length-prefixed binary framing for the batch client endpoints
.

``get_many``/``propose_many`` JSON-marshal every op on the hot path:
a 100-op read batch costs ~100 f-string path encodes + one
``json.dumps`` on the client and a ``json.loads`` + per-op dict hops
on the server, and the reply pays the same again.  This module is
the binary alternative — fixed-width tables and value blobs
assembled in a handful of C-level join/encode calls (never a
per-op Python loop on the hot shape) and unmarshaled as
``np.frombuffer`` views + single-pass decodes, the client-wire
analog of ``wire/distmsg.py``'s peer frames.

Negotiation is via Content-Type/Accept (server/distserver.py
``_make_peer_handler``): HTTP+JSON stays the default and is
byte-for-byte unchanged; a binary-capable client advertises
``Accept: application/x-etcd-batch`` and only switches its request
bodies over after the server has answered in kind, so a mixed-
version pair degrades to JSON with zero failed ops.

Frame = 12-byte header + kind-specific sections:

  header:   magic "DCB1" | kind u8 | flags u8 | reserved u16 |
            count u32
  GET_REQ:  plens  [count] i32  + concatenated utf-8 paths
  GET_RESP: vlens  [count] i32  (-1 = key absent / errored)
            + n_errs u32 + (idx i32, code i32, mlen i32) * n_errs
            + concatenated value bytes + concatenated utf-8 messages
  PROPOSE_RESP:
            n_errs u32 + (idx i32, code i32, mlen i32) * n_errs
            + concatenated utf-8 messages

Error tables are SPARSE (idx names the failed op) — the common
all-ok reply of a 1000-op propose batch is 16 bytes.  Decoder
totality matches the peer tier: every malformed frame fails typed as
``FrameError``, never an untyped crash (mutation fuzz in
tests/test_wire_client.py).
"""

from __future__ import annotations

import struct

import numpy as np

from .distmsg import FrameError, _view_i32
from .schema import DCB1, check_bound

#: negotiated media type; requests carry it as Accept (capability
#: advert) and, once confirmed, as Content-Type on binary bodies
CONTENT_TYPE = "application/x-etcd-batch"

# layout constants come from the declarative schema (wire/schema.py)
_MAGIC = DCB1.magic
_HDR = DCB1.header_struct()

_KINDS = DCB1.kind_values()
KIND_GET_REQ = _KINDS["KIND_GET_REQ"]
KIND_GET_RESP = _KINDS["KIND_GET_RESP"]
KIND_PROPOSE_RESP = _KINDS["KIND_PROPOSE_RESP"]

#: one sparse error row: op index i32, error code i32, msg len i32
_ERR = struct.Struct(DCB1.structs["_ERR"])


def _parse_header(data) -> tuple[int, int]:
    """Returns (kind, count); raises FrameError."""
    if len(data) < _HDR.size:
        raise FrameError("short client frame")
    magic, kind, _flags, _rsvd, count = _HDR.unpack_from(data)
    if magic != _MAGIC:
        raise FrameError("bad client frame magic")
    # the header count sizes every downstream table view and the
    # propose-ack return value — cap it before anything allocates
    # (it used to flow through unpack_propose_response unchecked)
    check_bound("dcb1.count", count)
    return kind, count


def pack_get_request(paths: list[str]) -> bytes:
    """One C-level join + encode for the whole batch: utf-8 of a
    concatenation is the concatenation of the utf-8, so the blob
    never needs per-path encodes — only the LENGTH table does, and
    only when a path is non-ASCII (char count != byte count)."""
    joined = "".join(paths)
    blob = joined.encode()
    if len(blob) == len(joined):
        lens = np.fromiter(map(len, paths), "<i4",
                           count=len(paths))
    else:
        lens = np.fromiter((len(p.encode()) for p in paths),
                           "<i4", count=len(paths))
    return b"".join((
        _HDR.pack(_MAGIC, KIND_GET_REQ, 0, 0, len(paths)),
        lens.tobytes(), blob))


def unpack_get_request(data) -> list[str]:
    kind, count = _parse_header(data)
    if kind != KIND_GET_REQ:
        raise FrameError(f"kind {kind} != get_req")
    plens, pos = _view_i32(data, _HDR.size, count)
    if count == 0:
        return []
    if int(plens.min()) < 0:
        raise FrameError("negative path length")
    check_bound("dcb1.path_len", int(plens.max()))
    # int64 running ends: an adversarial table of huge i32 lens must
    # overflow into the bounds check, not wrap into a wrong slice
    ends = plens.cumsum(dtype=np.int64)
    total = int(ends[-1])
    if pos + total > len(data):
        raise FrameError("truncated path")
    blob = data[pos:pos + total]
    if not isinstance(blob, (bytes, bytearray)):
        blob = bytes(blob)
    try:
        s = blob.decode()
    except UnicodeDecodeError:
        raise FrameError("path not utf-8") from None
    if len(s) == total:
        # ASCII blob: char offsets == byte offsets, so the paths
        # are plain slices of the ONE decoded string (the hot shape
        # — this is what keeps the batch parse off the stage table)
        out = []
        a = 0
        for b in ends.tolist():
            out.append(s[a:b])
            a = b
        return out
    out = []
    a = 0
    for b in ends.tolist():
        try:
            out.append(blob[a:b].decode())
        except UnicodeDecodeError:
            # the whole blob decoded, so a per-path failure means
            # the length table splits a multibyte character
            raise FrameError("path not utf-8") from None
        a = b
    return out


def _pack_errs(errs) -> tuple[bytes, list[bytes]]:
    """Errs table bytes + the message blobs to append after values.
    ``errs``: {op_index: (code, message)} sparse map."""
    lead = bytearray(4 + _ERR.size * len(errs))
    struct.pack_into("<I", lead, 0, len(errs))
    pos = 4
    msgs = []
    for idx in sorted(errs):
        code, msg = errs[idx]
        mb = msg.encode()
        _ERR.pack_into(lead, pos, idx, code, len(mb))
        pos += _ERR.size
        msgs.append(mb)
    return bytes(lead), msgs


def _unpack_errs(data, pos: int,
                 count: int) -> tuple[list[tuple[int, int, int]],
                                      int]:
    """Parse the sparse errs table; returns ([(idx, code, mlen)],
    pos past the table).  Message bytes trail the frame's other
    blobs and are sliced by the caller."""
    if pos + 4 > len(data):
        raise FrameError("truncated errs table")
    (n_errs,) = struct.unpack_from("<I", data, pos)
    pos += 4
    if n_errs > count:
        raise FrameError(f"errs {n_errs} > ops {count}")
    end = pos + n_errs * _ERR.size
    if end > len(data):
        raise FrameError("truncated errs table")
    rows = []
    for _ in range(n_errs):
        idx, code, mlen = _ERR.unpack_from(data, pos)
        pos += _ERR.size
        if idx < 0 or idx >= count:
            raise FrameError("errs index out of range")
        check_bound("dcb1.msg_len", mlen)
        rows.append((idx, code, mlen))
    return rows, pos


def _slice_msgs(data, pos: int,
                rows) -> dict[int, tuple[int, str]]:
    errs: dict[int, tuple[int, str]] = {}
    buf = memoryview(data)
    for idx, code, mlen in rows:
        if pos + mlen > len(data):
            raise FrameError("truncated errs message")
        try:
            errs[idx] = (code, str(buf[pos:pos + mlen], "utf-8"))
        except UnicodeDecodeError:
            raise FrameError("errs message not utf-8") from None
        pos += mlen
    return errs


#: values are encoded in chunks of this many ops so every
#: intermediate join/encode buffer stays pooled-arena/cache sized;
#: only the OUTPUT is ever allocated at full frame size, and it is
#: written exactly once (a whole-blob join+encode+join costs three
#: full-size memory passes — that triple showed up as the marshal
#: stage's cost at KB values, not the per-op Python work)
_VAL_CHUNK = 32


def pack_get_response(vals, errs: dict[int, tuple[int, str]]
                      ) -> bytearray | bytes:
    """``vals``: value per op — str (the serving path hands store
    leaf values straight through), bytes, or None (absent/errored).
    The all-present all-str batch — the hot serve shape — encodes
    chunk-wise straight into the preallocated frame; None/bytes
    (chunk join raises TypeError) or non-ASCII text (byte length
    outruns the char-count table) fall back to the per-value
    path."""
    lead, msgs = _pack_errs(errs)
    count = len(vals)
    mblob = b"".join(msgs)
    try:
        lens = np.fromiter(map(len, vals), "<i4", count=count)
        total = int(lens.sum(dtype=np.int64))
        head = _HDR.size + 4 * count + len(lead)
        out = bytearray(head + total + len(mblob))
        _HDR.pack_into(out, 0, _MAGIC, KIND_GET_RESP, 0, 0, count)
        out[_HDR.size:_HDR.size + 4 * count] = lens.tobytes()
        out[_HDR.size + 4 * count:head] = lead
        a = head
        for i in range(0, count, _VAL_CHUNK):
            b = "".join(vals[i:i + _VAL_CHUNK]).encode()
            e = a + len(b)
            out[a:e] = b
            a = e
        if a == head + total:
            out[a:] = mblob
            return out
        # non-ASCII: utf-8 byte lens exceed the char-count table we
        # optimistically wrote — rebuild on the general path
    except TypeError:
        pass  # a None (len) or bytes (str join) value in the batch
    lens = []
    parts = []
    for v in vals:
        if v is None:
            lens.append(-1)
            continue
        if type(v) is bytes:
            b = v
        else:
            b = str(v).encode()
        parts.append(b)
        lens.append(len(b))
    blob = b"".join(parts)
    return b"".join((
        _HDR.pack(_MAGIC, KIND_GET_RESP, 0, 0, count),
        np.asarray(lens, "<i4").tobytes(), lead, blob, mblob))


def unpack_get_response(
        data) -> tuple[list[bytes | None],
                       dict[int, tuple[int, str]]]:
    kind, count = _parse_header(data)
    if kind != KIND_GET_RESP:
        raise FrameError(f"kind {kind} != get_resp")
    vlens, pos = _view_i32(data, _HDR.size, count)
    if count and int(vlens.min()) < -1:
        raise FrameError("bad value length")
    if count:
        # -1 rows mean "absent" and are legal — cap the largest
        # actual value length only
        check_bound("dcb1.val_len", max(0, int(vlens.max())))
    rows, pos = _unpack_errs(data, pos, count)
    total = int(np.maximum(vlens, 0).sum(dtype=np.int64))
    if pos + total > len(data):
        raise FrameError("truncated value blob")
    vals: list[bytes | None] = []
    a = pos
    for ln in vlens.tolist():
        if ln < 0:
            vals.append(None)
        else:
            b = a + ln
            vals.append(bytes(data[a:b]))
            a = b
    return vals, _slice_msgs(data, a, rows)


def pack_propose_response(
        count: int, errs: dict[int, tuple[int, str]]) -> bytearray:
    lead, msgs = _pack_errs(errs)
    blob_total = sum(len(b) for b in msgs)
    out = bytearray(_HDR.size + len(lead) + blob_total)
    _HDR.pack_into(out, 0, _MAGIC, KIND_PROPOSE_RESP, 0, 0, count)
    pos = _HDR.size
    out[pos:pos + len(lead)] = lead
    pos += len(lead)
    for b in msgs:
        out[pos:pos + len(b)] = b
        pos += len(b)
    return out


def unpack_propose_response(
        data) -> tuple[int, dict[int, tuple[int, str]]]:
    kind, count = _parse_header(data)
    if kind != KIND_PROPOSE_RESP:
        raise FrameError(f"kind {kind} != propose_resp")
    rows, pos = _unpack_errs(data, _HDR.size, count)
    return count, _slice_msgs(data, pos, rows)
