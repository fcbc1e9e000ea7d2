"""Packed inter-role handoff frames for the compartmentalized
serving topology.

The role split (server/roles.py) moves client ingest, apply/watch
fanout, and group-sharded consensus into separate processes.  The
handoff between them must not re-spend the packed wire's winnings on
serialization, so every hop uses the same fixed-table + blob style as
``wire/distmsg.py`` (DGB3) and ``wire/clientmsg.py`` (DCB1): numpy
``frombuffer`` views over length tables, one-pass blob slicing, and
typed ``FrameError`` totality (mutation fuzz in tests/test_roles.py).

Frame = 12-byte header + kind-specific sections:

  header:    magic "DRH1" | kind u8 | flags u8 | rsvd u16 | count u32

  FWD_REQ:   opflags [count] u8 + pad-to-4 + rlens [count] i32
             + concatenated Request.marshal blobs.  The op flag
             carries ``Request.serializable`` — a LOCAL-ONLY field
             the version-stable marshal form deliberately omits, but
             which must survive the ingest -> shard hop or every
             replica-local read silently upgrades to linearizable.
             Header flags pick the reply shape (below).
  FWD_ACKS:  sparse errs only (u32 n_errs + (idx i32, code i32,
             mlen i32) rows + utf-8 messages) — the write-batch
             reply; all-ok costs 16 bytes.
  FWD_VALS:  vlens [count] i32 (-1 = absent/error) + sparse errs +
             value blobs + message blobs — the read-batch reply.
  FWD_RESP:  one fixed 72-byte event row per op + a single blob
             stream — the full-fidelity reply for coalesced single
             client ops (the front door needs whole v2 events, not
             just values).  Rare shapes (directory listings, TTL'd
             prev nodes) ride a per-op JSON fallback flag; the hot
             flat event never touches JSON.
  COMMIT:    seq u64 + groups [count] i32 + gindex [count] i64 +
             rlens [count] i32 + concatenated entry payloads — the
             shard -> apply-worker committed stream (shared-memory
             ring records, server/shmring.py).  ``seq`` numbers
             frames per ring so a consumer detects dropped frames as
             a gap instead of silently missing events.
"""

from __future__ import annotations

import json
import struct

import numpy as np

from .distmsg import FrameError, _view_i32
from .schema import DRH1, check_bound
from ..store.event import Event, NodeExtern

# layout constants come from the declarative schema (wire/schema.py)
_MAGIC = DRH1.magic
_HDR = DRH1.header_struct()

_KINDS = DRH1.kind_values()
KIND_FWD_REQ = _KINDS["KIND_FWD_REQ"]
KIND_FWD_ACKS = _KINDS["KIND_FWD_ACKS"]
KIND_FWD_VALS = _KINDS["KIND_FWD_VALS"]
KIND_FWD_RESP = _KINDS["KIND_FWD_RESP"]
KIND_COMMIT = _KINDS["KIND_COMMIT"]

# FWD_REQ header flags: requested reply shape
REPLY_EVENTS = 0       # FWD_RESP (full v2 events)
REPLY_ACKS = 0x01      # FWD_ACKS (write batch: error-sparse)
REPLY_VALS = 0x02      # FWD_VALS (read batch: leaf values)

# FWD_REQ per-op flags
OP_SERIALIZABLE = 0x01

#: one sparse error row: op index i32, error code i32, msg len i32
_ERR = struct.Struct(DRH1.structs["_ERR"])

#: one FWD_RESP event row (72 bytes):
#: code i32 | action u8 | flags u8 | rsvd u16 | etcd_index i64 |
#: mod i64 | created i64 | pmod i64 | pcreated i64 | expiration f64 |
#: ttl i32 | klen i32 | vlen i32 | pvlen i32
_EVT = struct.Struct(DRH1.structs["_EVT"])

F_ERR = 0x01        # error row: code + cause (klen bytes), index
F_HAS_NODE = 0x02
F_HAS_PREV = 0x04
F_DIR = 0x08        # node.dir
F_PDIR = 0x10       # prev_node.dir
F_JSON = 0x20       # fallback: klen bytes of event-dict JSON
F_HAS_EXP = 0x40    # expiration field is meaningful

_ACTIONS = ("get", "create", "set", "update", "delete",
            "compareAndSwap", "compareAndDelete", "expire")
_ACTION_IDX = {a: i for i, a in enumerate(_ACTIONS)}


def _parse_header(data) -> tuple[int, int, int]:
    """Returns (kind, flags, count); raises FrameError."""
    if len(data) < _HDR.size:
        raise FrameError("short role frame")
    magic, kind, flags, _rsvd, count = _HDR.unpack_from(data)
    if magic != _MAGIC:
        raise FrameError("bad role frame magic")
    # the header count sizes every downstream table view and the
    # fwd_acks return value — cap it before anything allocates (it
    # used to flow through unpack_fwd_acks unchecked)
    check_bound("drh1.count", count)
    return kind, flags, count


def _view_i64(data, pos: int, n: int) -> tuple[np.ndarray, int]:
    end = pos + 8 * n
    if end > len(data):
        raise FrameError("truncated i64 section")
    return np.frombuffer(data, "<i8", count=n, offset=pos), end


def _view_u8(data, pos: int, n: int) -> tuple[np.ndarray, int]:
    end = pos + n
    if end > len(data):
        raise FrameError("truncated u8 section")
    return np.frombuffer(data, np.uint8, count=n, offset=pos), end


def _lens_blobs(blobs: list[bytes]) -> tuple[bytes, bytes]:
    lens = np.fromiter(map(len, blobs), "<i4", count=len(blobs))
    return lens.tobytes(), b"".join(blobs)


def _slice_blobs(data, pos: int, lens: np.ndarray) -> list[bytes]:
    if lens.size and int(lens.min()) < 0:
        raise FrameError("negative blob length")
    if lens.size:
        check_bound("drh1.blob_len", int(lens.max()))
    # int64 running ends: adversarial i32 lens must overflow into the
    # bounds check, never wrap into a wrong slice
    ends = lens.cumsum(dtype=np.int64)
    total = int(ends[-1]) if lens.size else 0
    if pos + total > len(data):
        raise FrameError("truncated blob section")
    out = []
    a = pos
    for b in ends.tolist():
        out.append(bytes(data[a:pos + b]))
        a = pos + b
    return out


# -- FWD_REQ ----------------------------------------------------------------


def pack_fwd_request(blobs: list[bytes], opflags: list[int],
                     reply: int = REPLY_EVENTS) -> bytes:
    """``blobs``: Request.marshal per op; ``opflags``: per-op flag
    byte (OP_SERIALIZABLE)."""
    count = len(blobs)
    if len(opflags) != count:
        raise ValueError("opflags/blobs length mismatch")
    lens, blob = _lens_blobs(blobs)
    pad = b"\x00" * (-(_HDR.size + count) % 4)
    return b"".join((
        _HDR.pack(_MAGIC, KIND_FWD_REQ, reply, 0, count),
        bytes(bytearray(opflags)), pad, lens, blob))


def unpack_fwd_request(data) -> tuple[list[bytes], np.ndarray, int]:
    """Returns (request blobs, [count] u8 opflags view, reply
    shape)."""
    kind, flags, count = _parse_header(data)
    if kind != KIND_FWD_REQ:
        raise FrameError(f"kind {kind} != fwd_req")
    opflags, pos = _view_u8(data, _HDR.size, count)
    pos += -pos % 4
    rlens, pos = _view_i32(data, pos, count)
    return _slice_blobs(data, pos, rlens), opflags, flags


# -- sparse errs (shared by FWD_ACKS / FWD_VALS) ----------------------------


def _pack_errs(errs: dict[int, tuple[int, str]]
               ) -> tuple[bytes, list[bytes]]:
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


def _unpack_errs(data, pos: int, count: int
                 ) -> tuple[list[tuple[int, int, int]], int]:
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
        check_bound("drh1.msg_len", mlen)
        rows.append((idx, code, mlen))
    return rows, pos


def _slice_msgs(data, pos: int, rows) -> dict[int, tuple[int, str]]:
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


# -- FWD_ACKS ---------------------------------------------------------------


def pack_fwd_acks(count: int,
                  errs: dict[int, tuple[int, str]]) -> bytes:
    lead, msgs = _pack_errs(errs)
    return b"".join((_HDR.pack(_MAGIC, KIND_FWD_ACKS, 0, 0, count),
                     lead, *msgs))


def unpack_fwd_acks(data) -> tuple[int, dict[int, tuple[int, str]]]:
    kind, _flags, count = _parse_header(data)
    if kind != KIND_FWD_ACKS:
        raise FrameError(f"kind {kind} != fwd_acks")
    rows, pos = _unpack_errs(data, _HDR.size, count)
    return count, _slice_msgs(data, pos, rows)


# -- FWD_VALS ---------------------------------------------------------------


def pack_fwd_vals(vals: list[bytes | str | None],
                  errs: dict[int, tuple[int, str]]) -> bytes:
    lead, msgs = _pack_errs(errs)
    lens = []
    parts = []
    for v in vals:
        if v is None:
            lens.append(-1)
            continue
        b = v if type(v) is bytes else str(v).encode()
        parts.append(b)
        lens.append(len(b))
    return b"".join((
        _HDR.pack(_MAGIC, KIND_FWD_VALS, 0, 0, len(vals)),
        np.asarray(lens, "<i4").tobytes(), lead, *parts, *msgs))


def unpack_fwd_vals(data) -> tuple[list[bytes | None],
                                   dict[int, tuple[int, str]]]:
    kind, _flags, count = _parse_header(data)
    if kind != KIND_FWD_VALS:
        raise FrameError(f"kind {kind} != fwd_vals")
    vlens, pos = _view_i32(data, _HDR.size, count)
    if count and int(vlens.min()) < -1:
        raise FrameError("bad value length")
    if count:
        # -1 rows mean "absent" and are legal — cap the largest
        # actual value length only
        check_bound("drh1.val_len", max(0, int(vlens.max())))
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
            vals.append(bytes(data[a:a + ln]))
            a += ln
    return vals, _slice_msgs(data, a, rows)


# -- FWD_RESP ---------------------------------------------------------------


def _node_fits(n: NodeExtern | None) -> bool:
    """The flat row carries (key, value, dir, ttl, expiration, mod,
    created); listings (``nodes``) need the JSON fallback."""
    return n is None or not n.nodes


def _enc(s: str | None) -> bytes:
    return b"" if s is None else s.encode()


def pack_fwd_response(results: list) -> bytes:
    """``results``: per op, either a store ``Event`` (with
    ``etcd_index`` set) or an exception (EtcdError-shaped: uses
    ``error_code``/``cause``/``index`` when present)."""
    count = len(results)
    rows = bytearray(_EVT.size * count)
    blobs: list[bytes] = []
    pos = 0
    for x in results:
        code = 0
        action = 0
        flags = 0
        eidx = mod = created = pmod = pcreated = 0
        exp = 0.0
        ttl = 0
        klen = vlen = pvlen = 0
        if isinstance(x, Exception):
            flags = F_ERR
            code = getattr(x, "error_code", 300)
            eidx = getattr(x, "index", 0)
            cause = getattr(x, "cause", None)
            b = (cause if cause is not None else str(x)).encode()
            blobs.append(b)
            klen = len(b)
            vlen = pvlen = -1
        else:
            ev = x
            eidx = ev.etcd_index
            n, p = ev.node, ev.prev_node
            if (ev.action in _ACTION_IDX and _node_fits(n)
                    and _node_fits(p)
                    and (p is None or (p.ttl == 0
                                       and p.expiration is None
                                       and (n is None
                                            or p.key == n.key)))):
                action = _ACTION_IDX[ev.action]
                if n is not None:
                    flags |= F_HAS_NODE
                    if n.dir:
                        flags |= F_DIR
                    if n.expiration is not None:
                        flags |= F_HAS_EXP
                        exp = float(n.expiration)
                    ttl = n.ttl
                    mod, created = n.modified_index, n.created_index
                    kb = _enc(n.key)
                    blobs.append(kb)
                    klen = len(kb)
                    if n.value is None:
                        vlen = -1
                    else:
                        vb = _enc(n.value)
                        blobs.append(vb)
                        vlen = len(vb)
                else:
                    vlen = -1
                if p is not None:
                    flags |= F_HAS_PREV
                    if p.dir:
                        flags |= F_PDIR
                    pmod, pcreated = (p.modified_index,
                                      p.created_index)
                    if p.value is None:
                        pvlen = -1
                    else:
                        pb = _enc(p.value)
                        blobs.append(pb)
                        pvlen = len(pb)
                else:
                    pvlen = -1
            else:
                # rare shape (listing / TTL'd prev / alien action):
                # whole-event JSON, still one blob in the stream
                flags = F_JSON
                b = json.dumps(ev.to_dict()).encode()
                blobs.append(b)
                klen = len(b)
                vlen = pvlen = -1
        _EVT.pack_into(rows, pos, code, action, flags, 0, eidx,
                       mod, created, pmod, pcreated, exp, ttl,
                       klen, vlen, pvlen)
        pos += _EVT.size
    return b"".join((
        _HDR.pack(_MAGIC, KIND_FWD_RESP, 0, 0, count),
        bytes(rows), *blobs))


def unpack_fwd_response(data) -> list:
    """Returns per-op ``Event`` | ``(code, cause, index)`` error
    tuples (the caller rebuilds its typed error)."""
    kind, _flags, count = _parse_header(data)
    if kind != KIND_FWD_RESP:
        raise FrameError(f"kind {kind} != fwd_resp")
    pos = _HDR.size
    if pos + _EVT.size * count > len(data):
        raise FrameError("truncated event rows")
    out: list = []
    cur = pos + _EVT.size * count
    buf = memoryview(data)

    def take(n: int) -> bytes:
        nonlocal cur
        if n < 0 or cur + n > len(data):
            raise FrameError("truncated event blob")
        b = bytes(buf[cur:cur + n])
        cur += n
        return b

    for i in range(count):
        (code, action, flags, _r, eidx, mod, created, pmod,
         pcreated, exp, ttl, klen, vlen, pvlen) = _EVT.unpack_from(
            data, pos + i * _EVT.size)
        if flags & F_ERR:
            try:
                cause = take(klen).decode()
            except UnicodeDecodeError:
                raise FrameError("error cause not utf-8") from None
            out.append((code, cause, eidx))
            continue
        try:
            if flags & F_JSON:
                try:
                    ev = Event.from_dict(json.loads(take(klen)))
                except (ValueError, KeyError, TypeError):
                    raise FrameError("bad event json") from None
                ev.etcd_index = eidx
                out.append(ev)
                continue
            if action >= len(_ACTIONS):
                raise FrameError("bad event action")
            node = prev = None
            if flags & F_HAS_NODE:
                key = take(klen).decode()
                val = None if vlen < 0 else take(vlen).decode()
                node = NodeExtern(
                    key=key, value=val, dir=bool(flags & F_DIR),
                    expiration=exp if flags & F_HAS_EXP else None,
                    ttl=ttl, modified_index=mod,
                    created_index=created)
            if flags & F_HAS_PREV:
                pval = None if pvlen < 0 else take(pvlen).decode()
                prev = NodeExtern(
                    key=node.key if node is not None else "",
                    value=pval, dir=bool(flags & F_PDIR),
                    modified_index=pmod, created_index=pcreated)
        except UnicodeDecodeError:
            raise FrameError("event text not utf-8") from None
        out.append(Event(action=_ACTIONS[action], node=node,
                         prev_node=prev, etcd_index=eidx))
    return out


# -- COMMIT -----------------------------------------------------------------


def pack_commit(seq: int, rows: list[tuple[int, int, bytes]]
                ) -> bytes:
    """``rows``: (group, gindex, payload) per committed entry."""
    count = len(rows)
    groups = np.fromiter((r[0] for r in rows), "<i4", count=count)
    gidx = np.fromiter((r[1] for r in rows), "<i8", count=count)
    lens = np.fromiter((len(r[2]) for r in rows), "<i4",
                       count=count)
    return b"".join((
        _HDR.pack(_MAGIC, KIND_COMMIT, 0, 0, count),
        struct.pack("<Q", seq),
        groups.tobytes(), gidx.tobytes(), lens.tobytes(),
        *(r[2] for r in rows)))


def unpack_commit(data) -> tuple[int, np.ndarray, np.ndarray,
                                 list[bytes]]:
    """Returns (seq, [count] group view, [count] gindex view,
    payload blobs)."""
    kind, _flags, count = _parse_header(data)
    if kind != KIND_COMMIT:
        raise FrameError(f"kind {kind} != commit")
    pos = _HDR.size
    if pos + 8 > len(data):
        raise FrameError("truncated commit seq")
    (seq,) = struct.unpack_from("<Q", data, pos)
    pos += 8
    groups, pos = _view_i32(data, pos, count)
    gidx, pos = _view_i64(data, pos, count)
    rlens, pos = _view_i32(data, pos, count)
    return seq, groups, gidx, _slice_blobs(data, pos, rlens)
