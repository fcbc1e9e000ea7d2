"""Device-batched WAL replay (BASELINE config 1) on the card.

The port of ``etcd_tpu/wal/replay_device.py``.  The reference replays a
WAL strictly sequentially: per record, read a length prefix,
proto-unmarshal, update a rolling CRC, compare (wal/wal.go:164-216,
wal/decoder.go:28-47).  Here the same replay is a three-stage pipeline:

1. **Host framing** (``native/walscan.cc`` through ``native.py``, or a
   pure-Python scan): one sweep produces per-record arrays: type,
   stored CRC, data span, entry index/term/type.
2. **Device verification**: payload rows are right-aligned into
   ``[N, L]`` buffers, one per width class; every record's raw CRC is
   one row of the raw-CRC kernel (``ops/crc_device.raw_crc_batch``,
   ``csrc/raw_crc.cu``; rows wider than 4 KiB are folded from 4 KiB
   slabs), and every chain link is checked at once against the
   *stored* previous value.
3. **Host semantics**: metadata consistency, HardState selection,
   entry dedup-by-index (wal/wal.go:171-175), as array ops on the scan
   output.

Three lanes, chosen by ``route`` or by the measured router
(``wal/backend_policy.py``): ``host`` (one fused native sweep, frame +
parse + CRC; no device), ``device`` (native scan, then the monolithic
batched verify, :func:`verify_chain_device`) and ``stream`` (the
chunked pipeline, :func:`stream_scan_verify`: host framing of chunk
k+1 overlaps the H2D copy of chunk k and the verify of chunk k-1).  The
device lanes run on ``default_device(device)``: CUDA unless the caller
passes ``device="cpu"``; without CUDA they raise.  Unlike the
reference, no lane switches to the native verifier because the device
is the CPU: the native sequential verifier runs only where a caller or
the router names ``route="host"``.

The result keeps entries as an :class:`EntryBlock`: a struct-of-arrays
view into the raw blob.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from queue import Empty, Full, Queue

import numpy as np
import torch

from .. import default_device, native
from ..obs import metrics as _obs
from ..obs.devledger import ledger as _ledger
from ..ops.crc_device import (
    chain_links_device,
    chain_links_injected,
    inject_seeds,
    raw_crc_batch,
    u32_tensor,
)
from ..wire import Entry, HardState
from ..wire.proto import ProtoError
from .backend_policy import ROUTES, get_policy
from .errors import (
    CRCMismatchError,
    IndexNotFoundError,
    MetadataConflictError,
    TornTailError,
    WALError,
)
from .wal import (
    CRC_TYPE,
    ENTRY_TYPE,
    METADATA_TYPE,
    STATE_TYPE,
    WAL,
    select_segments,
)


@dataclass(slots=True)
class EntryBlock:
    """Struct-of-arrays entry log slice backed by the WAL blob: callers
    can ship ``(index, term, type)`` to the card and keep payload bytes
    host-side until apply."""

    index: np.ndarray      # uint64 [N]
    term: np.ndarray       # uint64 [N]
    type: np.ndarray       # uint64 [N]
    data_off: np.ndarray   # uint64 [N] into blob
    data_len: np.ndarray   # uint64 [N]
    blob: np.ndarray       # uint8, the raw WAL byte stream
    last_crc: int = 0      # stored CRC of the stream's final record
                           # (seeds WAL.open_at_end for appending)

    def __len__(self) -> int:
        return self.index.size

    def entry(self, i: int) -> Entry:
        """Materialize one Entry object (host convenience)."""
        o, l = int(self.data_off[i]), int(self.data_len[i])
        return Entry.unmarshal(self.blob[o:o + l].tobytes())

    def entries(self) -> list[Entry]:
        return [self.entry(i) for i in range(len(self))]


def _parse_record_span(raw: bytes, base: int, rlen: int):
    """Parse one Record in place, returning exact field positions.

    Walks the proto fields directly (the field loop of
    ``wire.proto.Record.unmarshal``) so the returned data span is the
    byte range the encoder wrote; a substring search could false-match
    payload bytes that also occur in the type/crc envelope.

    Returns ``(type, crc, data_off_abs, data_len)``.
    """
    from ..wire.proto import _expect_wt, _skip_field, _tag, uvarint

    end = base + rlen
    rtype = crc = 0
    doff, dlen = base, 0
    pos = base
    while pos < end:
        # _tag rejects field number 0 exactly like Record.unmarshal
        fnum, wt, pos = _tag(raw, pos)
        if fnum == 1:
            _expect_wt(fnum, wt, 0)  # corrupt framing aborts
            rtype, pos = uvarint(raw, pos)
        elif fnum == 2:
            _expect_wt(fnum, wt, 0)
            crc, pos = uvarint(raw, pos)
        elif fnum == 3:
            _expect_wt(fnum, wt, 2)
            dlen, pos = uvarint(raw, pos)
            doff = pos
            pos += dlen
        else:
            pos = _skip_field(raw, pos, wt)
        if pos > end:
            raise WALError("record field overruns frame")
    return rtype, crc, doff, dlen


def _scan_python(blob: np.ndarray):
    """Pure-Python framing scan mirroring native.wal_scan."""
    raw = blob.tobytes()
    pos, n = 0, len(raw)
    types, crcs, doffs, dlens, eidxs, eterms, etypes = \
        [], [], [], [], [], [], []
    while pos < n:
        if pos + 8 > n:
            raise TornTailError("truncated frame header")
        rlen = int.from_bytes(raw[pos:pos + 8], "little", signed=True)
        pos += 8
        if rlen < 0:
            raise WALError(f"negative record length {rlen}")
        if rlen > n - pos:
            raise TornTailError("truncated record")
        rtype, crc, doff, dlen = _parse_record_span(raw, pos, rlen)
        types.append(rtype)
        crcs.append(crc)
        doffs.append(doff)
        dlens.append(dlen)
        if rtype == ENTRY_TYPE and dlen:
            e = Entry.unmarshal(raw[doff:doff + dlen])
            eidxs.append(e.index)
            eterms.append(e.term)
            etypes.append(e.type)
        else:
            eidxs.append(0)
            eterms.append(0)
            etypes.append(0)
        pos += rlen
    return (np.asarray(types, np.int64), np.asarray(crcs, np.uint32),
            np.asarray(doffs, np.uint64), np.asarray(dlens, np.uint64),
            np.asarray(eidxs, np.uint64), np.asarray(eterms, np.uint64),
            np.asarray(etypes, np.uint64))


def _pad_rows_numpy(blob, doff, dlen, width):
    n = doff.size
    out = np.zeros((n, width), np.uint8)
    for i in range(n):
        o, l = int(doff[i]), int(dlen[i])
        out[i, width - l:] = blob[o:o + l]
    return out


def _rows_per_chunk(width: int, n_rows: int, chunk_rows: int,
                    byte_budget: int) -> int:
    """Rows of one batch of a width class: at most ``chunk_rows`` and
    ``byte_budget`` bytes (at least 1 row), and no more than the class's
    row count rounded up to a power of two (at least 8), so a tiny
    class does not make a mostly-padding batch."""
    rpc = max(1, min(chunk_rows, byte_budget // width))
    return min(rpc, max(8, 1 << (n_rows - 1).bit_length()))


def _width_classes(dlen_v: np.ndarray, spare: int, floor: int) -> np.ndarray:
    """Quantized padded row width per record: ``dlen + spare`` rounded
    up to a multiple of 128 (at least ``floor``) up to 2 KiB, to a power
    of two above, so one huge record does not inflate every row's
    padding.  The stream lane keeps 4 spare bytes for the injected seed
    and a floor of 128; the monolithic lane none and 64."""
    need = dlen_v.astype(np.int64) + spare
    return np.where(
        need <= 2048,
        np.maximum(floor, -(-need // 128) * 128),
        np.int64(1) << np.ceil(
            np.log2(np.maximum(need, 1).astype(np.float64))
        ).astype(np.int64))


def _batches(wcls, doff, dlen, stored, prev, chunk_rows: int,
             byte_budget: int):
    """Per width class, batches of at most ``chunk_rows`` rows and
    ``byte_budget`` bytes: ``(width, sel, data_off, data_len, stored,
    prev)``, ``sel`` the records' positions.  A short tail is padded
    with zero-length links whose zero prev and stored values verify
    trivially."""
    for w in np.unique(wcls):
        w = int(w)
        rows_idx = np.nonzero(wcls == w)[0]
        rpc = _rows_per_chunk(w, rows_idx.size, chunk_rows, byte_budget)
        for lo in range(0, rows_idx.size, rpc):
            sel = rows_idx[lo:lo + rpc]
            cols = [a[sel] for a in (doff, dlen, stored, prev)]
            if rpc > sel.size:
                cols = [np.pad(a, (0, rpc - sel.size)) for a in cols]
            yield w, sel, *cols


# -- streaming pipeline ------------------------------------------------------
#
# The monolithic device lane serializes scan -> full H2D -> verify, so
# end-to-end throughput is the harmonic mean of the stages.  The
# streaming lane splits the blob into fixed-size chunks and overlaps host
# framing of chunk k+1 with H2D of chunk k and device verify of chunk
# k-1, so throughput approaches min(stage).  GF(2) seed injection makes
# per-chunk verification composable: chunk c's chain seeds from chunk
# c-1's last *stored* CRC.

_CHUNK_HIST = {
    stage: _obs.registry.histogram("etcd_replay_stream_chunk_seconds",
                                   stage=stage)
    for stage in ("scan", "h2d", "verify")}


class _Pinned:
    """One pinned host staging buffer and the event of its last copy."""

    __slots__ = ("host", "event", "in_use")

    def __init__(self, n: int, width: int):
        self.host = torch.empty((n, width), dtype=torch.uint8,
                                pin_memory=True)
        self.event = None
        self.in_use = True


class DeviceTransport:
    """The H2D + device-verify legs of the streaming pipeline, on
    ``default_device(device)``.

    An injectable seam (tests swap in a fake with the same methods).
    On CUDA:

    - :meth:`stage` hands out a pinned host buffer for one batch of
      rows (``native.pad_rows(..., out=)`` fills it in place); a buffer
      is handed out again only once the event of its last copy has
      fired;
    - :meth:`ship` copies that buffer to the card with a
      ``non_blocking`` copy on a copy stream and records the copy's
      event;
    - :meth:`verify` launches ``raw_crc_batch`` and
      ``chain_links_injected`` on a compute stream that waits on the
      copy's event, and queues the verdicts' copy back to pinned host
      memory; it only dispatches;
    - :meth:`collect` waits on that chunk's event and returns the
      verdicts.

    With ``device="cpu"`` the rows stay where they are and ``verify``
    computes at once.
    """

    def __init__(self, device=None):
        self.device = default_device(device)
        self._cuda = self.device.type == "cuda"
        self._pool: dict[tuple[int, int], list[_Pinned]] = {}
        self._by_ptr: dict[int, _Pinned] = {}
        if self._cuda:
            self._copy = torch.cuda.Stream(self.device)
            self._compute = torch.cuda.Stream(self.device)

    def stage(self, n: int, width: int) -> np.ndarray:
        if not self._cuda:
            return np.empty((n, width), np.uint8)
        slots = self._pool.setdefault((n, width), [])
        for slot in slots:
            if not slot.in_use and (slot.event is None
                                    or slot.event.query()):
                slot.in_use = True
                return slot.host.numpy()
        slot = _Pinned(n, width)
        slots.append(slot)
        self._by_ptr[slot.host.data_ptr()] = slot
        return slot.host.numpy()

    def ship(self, rows: np.ndarray):
        if not self._cuda:
            return torch.from_numpy(rows)
        slot = self._by_ptr.get(rows.ctypes.data)
        if slot is None or tuple(slot.host.shape) != rows.shape:
            raise ValueError("ship() takes the rows of a stage() buffer")
        with torch.cuda.stream(self._copy):
            dev = slot.host.to(self.device, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self._copy)
        dev.record_stream(self._compute)
        slot.event, slot.in_use = copied, False
        return dev, copied

    def verify(self, shipped, stored: np.ndarray):
        if not self._cuda:
            return chain_links_injected(raw_crc_batch(shipped),
                                        u32_tensor(stored))
        dev, copied = shipped
        with torch.cuda.stream(self._compute):
            self._compute.wait_event(copied)
            ok = chain_links_injected(raw_crc_batch(dev),
                                      u32_tensor(stored, self.device))
            out = torch.empty(ok.shape, dtype=torch.bool, pin_memory=True)
            out.copy_(ok, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._compute)
        return out, done

    def collect(self, handle) -> np.ndarray:
        if not self._cuda:
            return handle.numpy()
        out, done = handle
        done.synchronize()
        return out.numpy()


def _raise_native(e: native.NativeError, record_base: int = 0):
    """Map a native scan/verify failure onto the WAL error vocabulary
    (by return code, never message text), naming the first bad record
    in stream-global terms."""
    if e.code == native.CRC_MISMATCH:
        bad = record_base + getattr(e, "bad_index", 0)
        raise CRCMismatchError(
            f"crc chain broken at record {bad} "
            f"(stored={getattr(e, 'bad_stored', 0):#x})") from e
    if e.code == native.TRUNCATED:
        raise TornTailError(str(e)) from e
    raise WALError(str(e)) from e


def _dispatch_chunk_verify(blob, crcs, doff, dlen, prev, transport,
                           byte_budget: int, ledger_stage: str):
    """Pad + seed-inject one scanned chunk's records and *dispatch* the
    device chain verify (one shipment per width-class batch inside the
    chunk).  Returns ``[(sel, n_real, handle), ...]`` for a later
    blocking collect."""
    stored = np.ascontiguousarray(crcs, np.uint32)
    dlen_v = np.ascontiguousarray(dlen, np.uint64)
    prev = np.ascontiguousarray(prev, np.uint32)
    wcls = _width_classes(dlen_v, spare=4, floor=128)
    out = []
    t0 = time.perf_counter()
    for w, sel, d_off, d_len, st, pv in _batches(
            wcls, doff, dlen_v, stored, prev, 1 << 17, byte_budget):
        rows = native.pad_rows(blob, d_off, d_len, w,
                               out=transport.stage(d_off.size, w))
        inject_seeds(rows, d_len, pv)
        _ledger.h2d(ledger_stage, rows)
        shipped = transport.ship(rows)
        with _ledger.dispatch(ledger_stage):
            handle = transport.verify(shipped, st)
        out.append((sel, sel.size, handle))
    _CHUNK_HIST["h2d"].observe(time.perf_counter() - t0)
    return out


def stream_scan_verify(blob: np.ndarray, *, seed: int = 0,
                       chunk_bytes: int | None = None,
                       route: str = "stream", transport=None,
                       byte_budget: int = 1 << 28, depth: int = 2,
                       ledger_stage: str = "replay.stream",
                       device=None):
    """Chunked streaming scan + rolling-chain verify of a WAL blob.

    Returns the whole stream's scan arrays ``(types, crcs, data_off,
    data_len, ent_index, ent_term, ent_type)``, identical to
    ``native.wal_scan(blob)`` with the chain verified, or raises the
    same typed errors the monolithic lanes raise.

    ``route="host"``: each chunk is one fused native sweep (frame +
    parse + CRC in a single pass); no device is touched.
    ``route="stream"``: host framing of chunk k+1 (a scanner thread)
    overlaps H2D of chunk k and device verify of chunk k-1; at most
    ``depth`` chunks are buffered on each seam.  ``transport`` injects
    the device legs (default: a :class:`DeviceTransport` on
    ``device``).
    """
    if route not in ("host", "stream"):
        raise ValueError(f"stream_scan_verify runs route host or stream, "
                         f"not {route!r}")
    native.require()
    n = int(blob.size)
    if chunk_bytes is None:
        chunk_bytes = get_policy().chunk_bytes
    chunk_bytes = max(1, int(chunk_bytes))
    if route == "stream" and transport is None:
        transport = DeviceTransport(device)
    # ONE length-hop count sizes the whole stream's output arrays, so
    # every chunk sweep writes into its slice
    try:
        total, _ = native.wal_count_range(blob, 0, n)
    except native.NativeError as e:
        _raise_native(e)
    full = native.alloc_scan_arrays(total)

    if route == "host":
        pos, base, chain = 0, 0, seed
        while pos < n:
            t0 = time.perf_counter()
            try:
                with _ledger.dispatch(ledger_stage):
                    *arrays, nxt = native.scan_chunk(
                        blob, pos, chunk_bytes, seed=chain,
                        verify=True, out=full, out_base=base)
            except native.NativeError as e:
                _raise_native(e, base)
            _CHUNK_HIST["scan"].observe(time.perf_counter() - t0)
            cnt = arrays[0].size
            if cnt:
                chain = int(arrays[1][-1])
            base += cnt
            if nxt <= pos:  # defensive: no forward progress
                break
            pos = nxt
        return tuple(a[:base] for a in full)

    scan_q: Queue = Queue(maxsize=depth)
    cancel = threading.Event()
    scan_err: list[BaseException] = []

    def scanner():
        pos, base = 0, 0
        try:
            while pos < n:
                t0 = time.perf_counter()
                *arrays, nxt = native.scan_chunk(
                    blob, pos, chunk_bytes, verify=False,
                    out=full, out_base=base)
                _CHUNK_HIST["scan"].observe(time.perf_counter() - t0)
                _qput(scan_q, ("chunk", base, tuple(arrays)), cancel)
                base += arrays[0].size
                if nxt <= pos:
                    break
                pos = nxt
            _qput(scan_q, ("done", base, None), cancel)
        except _Cancelled:
            pass
        except BaseException as e:  # noqa: BLE001 - relayed to caller
            scan_err.append(e)
            try:
                _qput(scan_q, ("err", 0, None), cancel)
            except _Cancelled:
                pass

    th = threading.Thread(target=scanner, daemon=True,
                          name="replay-stream-scan")
    th.start()
    inflight: deque = deque()
    prev_tail: int | None = None
    first_bad: int | None = None

    def collect_one():
        nonlocal first_bad
        base, crcs, handles = inflight.popleft()
        t0 = time.perf_counter()
        for sel, n_real, handle in handles:
            ok = transport.collect(handle)
            _ledger.d2h(ledger_stage, ok)
            if not ok.all():
                bad = base + int(sel[np.argmin(ok[:n_real])])
                if first_bad is None or bad < first_bad:
                    first_bad = bad
        _CHUNK_HIST["verify"].observe(time.perf_counter() - t0)
        if first_bad is not None:
            raise CRCMismatchError(
                f"crc chain broken at record {first_bad} "
                f"(stored={int(crcs[first_bad - base]):#x})")

    filled = 0
    try:
        while True:
            kind, base, arrays = scan_q.get()
            if kind == "err":
                e = scan_err[0]
                if isinstance(e, native.NativeError):
                    _raise_native(e, base)
                raise e
            if kind == "done":
                filled = base
                break
            types, crcs = arrays[0], arrays[1]
            if crcs.size == 0:
                continue
            if prev_tail is None:
                head = int(crcs[0]) if types[0] == CRC_TYPE else seed
            else:
                head = prev_tail
            prev = np.concatenate(
                [np.asarray([head], np.uint32), crcs[:-1]])
            handles = _dispatch_chunk_verify(
                blob, crcs, arrays[2], arrays[3], prev, transport,
                byte_budget, ledger_stage)
            inflight.append((base, crcs, handles))
            prev_tail = int(crcs[-1])
            while len(inflight) >= depth:
                collect_one()
        while inflight:
            collect_one()
    finally:
        cancel.set()
        _drain(scan_q)
        th.join(timeout=10)
    return tuple(a[:filled] for a in full)


class _Cancelled(Exception):
    pass


def _qput(q: Queue, item, cancel: threading.Event) -> None:
    while True:
        if cancel.is_set():
            raise _Cancelled()
        try:
            q.put(item, timeout=0.05)
            return
        except Full:
            continue


def _drain(q: Queue) -> None:
    while True:
        try:
            q.get_nowait()
        except Empty:
            return


def verify_chain_device(blob: np.ndarray, types, crcs, doff, dlen,
                        chunk_rows: int = 1 << 17,
                        byte_budget: int = 1 << 28, device=None,
                        route: str = "device") -> None:
    """Rolling-chain verification of scanned records.

    Raises :class:`CRCMismatchError` naming the first bad record.  A
    leading crcType record re-seeds the chain, mirroring the fresh-
    decoder rule of wal/wal.go:184-191 (a mid-file crc record instead
    participates as a regular zero-length link, which its stored value
    satisfies iff it matches the running chain).

    ``route="device"`` (the default) is the batched pass on
    ``default_device(device)``: each link i depends only on the
    *stored* value of link i-1, so records are grouped by width class
    (so one huge record cannot inflate every row) and verified in
    batches of at most ``chunk_rows`` rows and ``byte_budget`` bytes
    (short tails padded with trivially-true links).  ``route="host"``
    is the native sequential sweep (``native.chain_verify``, sharded
    across cores for large streams); no device is touched.
    """
    n = int(types.shape[0])
    if n == 0:
        return
    seed = 0
    start = 0
    if types[0] == CRC_TYPE:
        seed = int(crcs[0])
        start = 1
    if start >= n:
        return

    if route == "host":
        threads = min(os.cpu_count() or 1, 8) \
            if n - start >= (1 << 16) else 1
        try:
            r = native.chain_verify(
                blob, doff[start:], dlen[start:], crcs[start:], seed,
                threads=threads)
        except native.NativeError as e:  # pragma: no cover - scan
            raise WALError(str(e)) from e  # guarantees spans in range
        if r == n - start:
            return
        bad = start + r
        raise CRCMismatchError(
            f"crc chain broken at record {bad} "
            f"(stored={int(crcs[bad]):#x})")
    if route != "device":
        raise ValueError(f"verify_chain_device runs route device or host, "
                         f"not {route!r}")

    dev = default_device(device)
    stored = np.ascontiguousarray(crcs[start:], np.uint32)
    prev = np.concatenate(
        [np.asarray([seed], np.uint32), crcs[start:-1]])
    doff_v = doff[start:]
    dlen_v = np.ascontiguousarray(dlen[start:], np.uint64)

    wcls = _width_classes(dlen_v, spare=0, floor=64)

    first_bad = None
    for w, sel, d_off, d_len, st, pv in _batches(
            wcls, doff_v, dlen_v, stored, prev, chunk_rows, byte_budget):
        if native.available():
            rows = native.pad_rows(blob, d_off, d_len, w)
        else:
            rows = _pad_rows_numpy(blob, d_off, d_len, w)
        # devledger seam: the padded batch is the H2D shipment, the
        # [rows] ok mask the D2H readback
        _ledger.h2d("replay.verify", rows)
        with _ledger.dispatch("replay.verify"):
            rows_t = torch.from_numpy(rows).to(dev)
            lens_t = torch.from_numpy(d_len.astype(np.int64)).to(dev)
            ok = chain_links_device(
                u32_tensor(pv, dev), u32_tensor(st, dev),
                raw_crc_batch(rows_t), lens_t, max_len=w).cpu().numpy()
        _ledger.d2h("replay.verify", ok)
        if not ok.all():
            bad = start + int(sel[np.argmin(ok[:sel.size])])
            if first_bad is None or bad < first_bad:
                first_bad = bad
    if first_bad is not None:
        raise CRCMismatchError(
            f"crc chain broken at record {first_bad} "
            f"(stored={int(crcs[first_bad]):#x})")


def read_all_device(dirpath: str, index: int = 0,
                    route: str | None = None, device=None
                    ) -> tuple[bytes | None, HardState, EntryBlock]:
    """Batched-replay equivalent of ``WAL.open_at_index + read_all``.

    Same semantics as the host path (metadata conflict, state
    selection, entry dedup-by-index, index-gap and not-found errors)
    with the scan/verify lane chosen by ``route``: ``host`` (one fused
    native sweep), ``device`` (monolithic batched verify), ``stream``
    (the chunked overlap pipeline), or, when None, the measured router
    (``wal/backend_policy``; its probe runs on ``device`` and raises
    where that device does).  The device lanes run on
    ``default_device(device)``.

    The router answers ``host`` or ``stream``, never ``device``.  At
    BASELINE config 1 on an H100 it picks ``stream`` although ``host``
    measured faster there (PERF.md, "Where the time goes"): its cost
    model leaves out the stream lane's padding and seed injection.

    ``host`` and ``stream`` need the native scanner and raise
    :class:`native.NativeError` with its build report when it did not
    load.  Without it, ``device`` and the unrouted call scan in pure
    Python and verify the chain with the batched pass.  Returns entries
    as an :class:`EntryBlock`; the WAL itself is not opened for append
    (:func:`open_replay_device` does that).
    """
    if route is not None and route not in ROUTES:
        raise ValueError(f"unknown replay route {route!r} "
                         f"(want one of {ROUTES})")
    names = select_segments(dirpath, index)
    blobs = [np.fromfile(os.path.join(dirpath, nm), dtype=np.uint8)
             for nm in names]
    blob = np.concatenate(blobs) if len(blobs) > 1 else blobs[0]

    verified = False
    if route in ("host", "stream"):
        native.require()
    if native.available():
        if route is None:
            route = get_policy().route("replay", size_bytes=int(blob.size),
                                       device=device)
        if route != "host":
            device = default_device(device)
        try:
            if route == "host":
                # frame + parse + CRC in ONE pass over the blob
                types, crcs, doff, dlen, eidx, eterm, etype = \
                    native.scan_verify(blob)
                verified = True
            elif route == "stream":
                types, crcs, doff, dlen, eidx, eterm, etype = \
                    stream_scan_verify(blob, route="stream", device=device)
                verified = True
            else:
                types, crcs, doff, dlen, eidx, eterm, etype = \
                    native.wal_scan(blob)
        except native.NativeError as e:
            # WAL corruption is a WALError whichever scanner found it;
            # a stream that ends mid-record is a TornTailError
            _raise_native(e)
    else:
        try:
            types, crcs, doff, dlen, eidx, eterm, etype = \
                _scan_python(blob)
        except ProtoError as e:
            raise WALError(str(e)) from e

    known = np.isin(types, (METADATA_TYPE, ENTRY_TYPE, STATE_TYPE,
                            CRC_TYPE))
    if not known.all():
        j = int(np.argmin(known))
        raise WALError(f"unexpected block type {int(types[j])}")

    if not verified:
        verify_chain_device(blob, types, crcs, doff, dlen, device=device)

    # -- host semantics over the scan arrays --------------------------------
    metadata: bytes | None = None
    for j in np.nonzero(types == METADATA_TYPE)[0]:
        md = blob[int(doff[j]):int(doff[j]) + int(dlen[j])].tobytes()
        if metadata is not None and metadata != md:
            raise MetadataConflictError()
        metadata = md

    state = HardState()
    st_idx = np.nonzero(types == STATE_TYPE)[0]
    if st_idx.size:
        j = int(st_idx[-1])
        state = HardState.unmarshal(
            blob[int(doff[j]):int(doff[j]) + int(dlen[j])].tobytes())

    # Entry selection mirrors the host read_all loop exactly: ri = the
    # open index, keep entries with e.index >= ri, dedup-by-index with
    # tail truncation, and the final last-entry >= ri check.
    ei = np.nonzero(types == ENTRY_TYPE)[0]
    ri = index
    if ei.size:
        idxs = eidx[ei].astype(np.int64)
        keep = idxs >= ri
        ei_k = ei[keep]
        idxs_k = idxs[keep]
        if idxs_k.size and np.all(np.diff(idxs_k) == 1) \
                and idxs_k[0] == ri:
            sel = ei_k  # fast path: consecutive from ri, no overwrites
        else:
            # crash-overwrite / gap path: replay dedup-by-index
            kept: list[int] = []
            for j, idx in zip(ei_k, idxs_k):
                slot = int(idx) - ri
                if slot > len(kept):
                    raise WALError(
                        f"entry index gap: {int(idx)} after "
                        f"{len(kept)} entries from {ri}")
                del kept[slot:]
                kept.append(int(j))
            sel = np.asarray(kept, np.int64)
        enti = int(eidx[ei[-1]])  # last entry index SEEN (host parity)
    else:
        sel = np.asarray([], np.int64)
        enti = 0

    if enti < ri:
        raise IndexNotFoundError(f"last entry {enti} < requested {ri}")

    block = EntryBlock(
        index=eidx[sel], term=eterm[sel], type=etype[sel],
        data_off=doff[sel], data_len=dlen[sel], blob=blob,
        last_crc=int(crcs[-1]) if crcs.size else 0)
    return metadata, state, block


def open_replay_device(dirpath: str, index: int = 0,
                       route: str | None = None, device=None
                       ) -> tuple[WAL, bytes | None, HardState, EntryBlock]:
    """Replay on the routed lane, then open the WAL for appends.

    The batched pass both verifies the stream and yields the chain
    tail CRC, so the append encoder seeds directly
    (``WAL.open_at_end``) with no sequential re-read.
    """
    metadata, state, block = read_all_device(dirpath, index, route, device)
    enti = int(block.index[-1]) if len(block) else 0
    w = WAL.open_at_end(dirpath, metadata, block.last_crc, enti)
    return w, metadata, state, block
