"""Write-ahead log: append-only segmented record log with rolling CRC.

Host-path port of the reference's wal package semantics
(wal/wal.go:57-293): a WAL is either in read mode or append mode; a
newly created WAL appends, a just-opened WAL reads, and becomes
appendable only after ``read_all`` drains it.  Files are named
``%016x-%016x.wal`` (seq, index) (wal/util.go:86-88); each file starts
with a crcType record carrying the rolling CRC at the cut point
(wal/wal.go:93,234) followed by a metadata record, so segments chain.

Record framing (wal/encoder.go:25-37, decoder.go:28-47): little-endian
int64 length prefix, then the marshaled walpb Record.  The rolling
digest covers record *data* only — the framing and record envelope are
protected by the fact that a corrupted envelope fails to unmarshal.

The port's copy of ``etcd_tpu/wal/wal.py``, whole: the batched device
replay lives in ``replay_device.py``; this module is the durable
read/write seam shared by both paths, and writes files byte-equal to
the reference's.
"""

from __future__ import annotations

import errno
import logging
import os
import struct
import time
from typing import BinaryIO

from ..crc import Digest
from ..obs import metrics as _obs
from ..utils import faults as _faults
from ..utils.errors import EtcdNoSpace
from ..utils.fsio import fsync as fsio_fsync, fsync_dir
from ..wire import Entry, HardState, Record
from .errors import (
    CRCMismatchError,
    FileNotFoundError_,
    IndexNotFoundError,
    MetadataConflictError,
    TornTailError,
    WALError,
)

log = logging.getLogger(__name__)

# record types (reference wal/wal.go:35-39)
METADATA_TYPE = 1
ENTRY_TYPE = 2
STATE_TYPE = 3
CRC_TYPE = 4

_PRIVATE_DIR_MODE = 0o700
_LEN_STRUCT = struct.Struct("<q")

# obs seams: fsync latency is THE durability hot metric — every
# client ack sits behind one of these (the Ready contract)
_FSYNC_HIST = _obs.registry.histogram("etcd_wal_fsync_seconds")
_APPEND_CTR = _obs.registry.counter("etcd_wal_append_entries_total")
_CUT_CTR = _obs.registry.counter("etcd_wal_cuts_total")
_GC_CTR = _obs.registry.counter("etcd_wal_segments_gc_total")


def wal_name(seq: int, index: int) -> str:
    return f"{seq:016x}-{index:016x}.wal"


def parse_wal_name(name: str) -> tuple[int, int]:
    """Raises ValueError on non-WAL names (reference wal/util.go:77-84)."""
    if not name.endswith(".wal"):
        raise ValueError(f"bad wal name: {name}")
    stem = name[:-4]
    seq_s, _, index_s = stem.partition("-")
    if len(seq_s) != 16 or len(index_s) != 16:
        raise ValueError(f"bad wal name: {name}")
    return int(seq_s, 16), int(index_s, 16)


def check_wal_names(names: list[str]) -> list[str]:
    out = []
    for name in names:
        try:
            parse_wal_name(name)
        except ValueError:
            continue
        out.append(name)
    return out


def search_index(names: list[str], index: int) -> int | None:
    """Last position whose raft-index section is <= index; names sorted
    (reference wal/util.go:20-32)."""
    for i in range(len(names) - 1, -1, -1):
        _, cur_index = parse_wal_name(names[i])
        if index >= cur_index:
            return i
    return None


def is_valid_seq(names: list[str]) -> bool:
    """Sequence numbers must increase continuously (wal/util.go:36-49)."""
    last_seq = 0
    for name in names:
        cur_seq, _ = parse_wal_name(name)
        if last_seq != 0 and last_seq != cur_seq - 1:
            return False
        last_seq = cur_seq
    return True


def select_segments(dirpath: str, index: int) -> list[str]:
    """Sorted, seq-contiguous segment names whose chain covers
    ``index`` — the shared restart seam behind ``open_at_index`` and
    the device/streaming replay lanes (both must agree on which files
    constitute the stream, or the two paths could replay different
    bytes from the same directory)."""
    try:
        names = os.listdir(dirpath)
    except OSError as e:
        raise FileNotFoundError_(str(e)) from e
    names = sorted(check_wal_names(names))
    if not names:
        raise FileNotFoundError_(dirpath)
    i = search_index(names, index)
    if i is None or not is_valid_seq(names[i:]):
        raise FileNotFoundError_(f"no wal file covers index {index}")
    return names[i:]


def exist(dirpath: str) -> bool:
    try:
        return len(os.listdir(dirpath)) != 0
    except OSError:
        return False


def _open_append_0600(path: str) -> BinaryIO:
    """Segment files carry owner-only mode like the reference
    (wal/wal.go:82,222 pass 0600)."""
    fd = os.open(path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o600)
    return os.fdopen(fd, "ab")


class _Encoder:
    """Rolling-CRC record encoder (reference wal/encoder.go:13-45)."""

    def __init__(self, f: BinaryIO, prev_crc: int):
        self.f = f
        self.crc = Digest(prev_crc)

    def encode(self, rec: Record) -> None:
        if rec.data is not None:
            self.crc.write(rec.data)
        rec.crc = self.crc.sum32()
        data = rec.marshal()
        self.f.write(_LEN_STRUCT.pack(len(data)))
        self.f.write(data)


class _Decoder:
    """Sequential record decoder over a chain of segment files
    (reference wal/decoder.go:14-59 + MultiReadCloser)."""

    def __init__(self, files: list[BinaryIO]):
        self.files = files
        self.fi = 0
        self.crc = Digest(0)
        # (file index, offset) where the NEXT record starts — the
        # truncation point for torn-tail repair
        self.good = (0, 0)

    def _read(self, n: int) -> bytes:
        """ReadFull across the file chain; b'' at a clean stream end."""
        chunks = []
        need = n
        while need > 0:
            if self.fi >= len(self.files):
                break
            chunk = self.files[self.fi].read(need)
            if not chunk:
                self.fi += 1
                continue
            chunks.append(chunk)
            need -= len(chunk)
        return b"".join(chunks)

    def decode(self) -> Record | None:
        """Next record, or None at a clean EOF.  A partial trailing
        record raises (the reference surfaces io.ErrUnexpectedEOF)."""
        # advance past exhausted files so the recorded record-start
        # position is meaningful for repair
        while self.fi < len(self.files):
            probe = self.files[self.fi].read(1)
            if probe:
                self.files[self.fi].seek(-1, 1)
                break
            self.fi += 1
        if self.fi >= len(self.files):
            return None
        self.good = (self.fi, self.files[self.fi].tell())
        header = self._read(8)
        if len(header) < 8:
            raise TornTailError("unexpected EOF in record length")
        (length,) = _LEN_STRUCT.unpack(header)
        if length < 0:
            raise WALError(f"negative record length {length}")
        data = self._read(length)
        if len(data) < length:
            raise TornTailError("unexpected EOF in record body")
        rec = Record.unmarshal(data)
        # skip crc checking if the record type is crcType
        # (wal/decoder.go:41-43)
        if rec.type == CRC_TYPE:
            return rec
        if rec.data is not None:
            self.crc.write(rec.data)
        if rec.crc != self.crc.sum32():
            raise CRCMismatchError(
                f"crc mismatch: record={rec.crc:#x} "
                f"computed={self.crc.sum32():#x}")
        return rec

    def update_crc(self, prev_crc: int) -> None:
        self.crc = Digest(prev_crc)

    def last_crc(self) -> int:
        return self.crc.sum32()

    def close(self) -> None:
        for f in self.files:
            f.close()


class WAL:
    """Logical representation of the stable storage (wal/wal.go:57-68)."""

    def __init__(self) -> None:
        self.dir = ""
        self.md: bytes | None = None
        self.ri = 0  # index of entry to start reading
        self.decoder: _Decoder | None = None
        self.f: BinaryIO | None = None  # file opened for appending
        self.seq = 0
        self.enti = 0  # index of the last entry saved
        self.encoder: _Encoder | None = None
        # path of the append-mode segment (fdopen'd handles carry no
        # usable .name — the ENOSPC rollback reopens by path)
        self._fpath = ""

    # -- lifecycle ---------------------------------------------------------

    @classmethod
    def create(cls, dirpath: str, metadata: bytes) -> "WAL":
        """Create an append-mode WAL; metadata heads every segment
        (reference wal/wal.go:72-100)."""
        if exist(dirpath):
            raise FileExistsError(dirpath)
        os.makedirs(dirpath, mode=_PRIVATE_DIR_MODE, exist_ok=True)
        p = os.path.join(dirpath, wal_name(0, 0))
        f = _open_append_0600(p)
        w = cls()
        w.dir = dirpath
        w.md = metadata
        w.seq = 0
        w.f = f
        w._fpath = p
        w.encoder = _Encoder(f, 0)
        w._save_crc(0)
        w.encoder.encode(Record(type=METADATA_TYPE, data=metadata))
        # the header records and the segment's directory entry must
        # be durable before the WAL is handed out — a crash between
        # create() and the first save() must not lose the metadata
        # record that every later open validates against
        w.sync()
        fsync_dir(dirpath)
        return w

    @classmethod
    def open_at_end(cls, dirpath: str, metadata: bytes | None,
                    last_crc: int, enti: int) -> "WAL":
        """Open directly in append mode, seeding the encoder's rolling
        CRC with ``last_crc`` (the stored CRC of the final record).

        Companion to the device replay path (replay_device.py), which
        verifies and decodes the whole stream in one batched pass and
        already knows the chain tail — so the read-then-append
        lifecycle of ``open_at_index`` + ``read_all`` is unnecessary.
        """
        names = sorted(check_wal_names(os.listdir(dirpath)))
        if not names:
            raise FileNotFoundError_(dirpath)
        seq, _ = parse_wal_name(names[-1])
        p = os.path.join(dirpath, names[-1])
        f = _open_append_0600(p)
        w = cls()
        w.dir = dirpath
        w.md = metadata
        w.seq = seq
        w.f = f
        w._fpath = p
        w.enti = enti
        w.encoder = _Encoder(f, last_crc)
        return w

    @classmethod
    def open_at_index(cls, dirpath: str, index: int) -> "WAL":
        """Open read-mode at ``index``; the caller must ``read_all``
        before appending (reference wal/wal.go:108-159)."""
        names = select_segments(dirpath, index)
        files = [open(os.path.join(dirpath, n), "rb")
                 for n in names]
        seq, _ = parse_wal_name(names[-1])
        p = os.path.join(dirpath, names[-1])
        f = open(p, "ab")

        w = cls()
        w.dir = dirpath
        w.ri = index
        w.decoder = _Decoder(files)
        w.f = f
        w._fpath = p
        w.seq = seq
        return w

    # -- read --------------------------------------------------------------

    def read_all(self, repair: bool = False
                 ) -> tuple[bytes | None, HardState, list[Entry]]:
        """Drain the WAL; afterwards it accepts appends
        (reference wal/wal.go:164-216).

        ``repair=True`` tolerates a TORN TAIL — a final record cut
        mid-write by a crash (unexpected EOF): the stream is
        truncated at the last complete record and replay succeeds
        with what is durable.  Safe because acks only follow fsync,
        so torn bytes were never acknowledged to anyone.  The
        reference's 0.5 snapshot log.Fatals here (server.go:156);
        later etcd grew exactly this repair.  Default False keeps the
        strict parity behavior (corruption detection tests).  Any
        OTHER corruption — CRC mismatch, index gap, a torn record
        followed by more data — still raises."""
        if self.decoder is None:
            raise WALError("wal not in read mode")
        metadata: bytes | None = None
        state = HardState()
        ents: list[Entry] = []

        repaired = False

        def decode_or_repair():
            nonlocal repaired
            try:
                return self.decoder.decode()
            except TornTailError as e:
                # torn tail: the failing record is by construction the
                # stream's last bytes (the chain is exhausted
                # mid-record), so every byte from the record start to
                # the end of the chain is part of the torn record —
                # truncate the file it starts in AND remove any later
                # files its bytes spilled into (unreachable from a
                # single crash since writes never span segments, but
                # repair exists for arbitrary crash states)
                if repair:
                    fi, off = self.decoder.good
                    if off == 0 and fi == 0:
                        # the tear consumes the very head of the
                        # decoder's first file: nothing in the read
                        # window is salvageable, and truncating would
                        # manufacture a headless zero-byte segment
                        # (no CRC/metadata records — mid-chain opens
                        # would then corrupt the CRC chain, full
                        # opens would lose node metadata).  Refuse:
                        # nothing here was ever synced+acked.
                        raise
                    if off == 0 and fi > 0:
                        # the tear starts at byte 0 of segment fi:
                        # truncating would leave a headless segment
                        # (no CRC/metadata records) that a later
                        # mid-chain open would reject — the chain
                        # ended exactly at fi-1's end, so fi itself
                        # is all torn bytes; drop it too
                        fi, off = fi - 1, None
                    path = self.decoder.files[fi].name
                    if off is not None:
                        os.truncate(path, off)
                        # the truncation itself must be durable
                        # before replay returns: a crash after a
                        # repaired-but-unsynced truncate would
                        # resurrect the torn bytes on the next open
                        # (fsio.fsync seam: EIO here is fail-stop)
                        tfd = os.open(path, os.O_RDONLY)
                        try:
                            fsio_fsync(tfd)
                        finally:
                            os.close(tfd)
                    doomed = self.decoder.files[fi + 1:]
                    # REMOVE, don't truncate-to-zero: a zero-length
                    # segment carries no metadata/CRC head record and
                    # would break any per-file validation on a later
                    # open.  Descending order with a
                    # directory fsync after EACH unlink keeps any
                    # crash-surviving subset seq-contiguous — without
                    # the per-remove fsync the journal may persist
                    # the unlinks out of call order, stranding a gap
                    # that bricks every subsequent open.
                    if doomed:
                        dfd = os.open(self.dir, os.O_RDONLY)
                        try:
                            for lf in reversed(doomed):
                                os.remove(lf.name)
                                os.fsync(dfd)
                        finally:
                            os.close(dfd)
                        # appends must continue in the surviving
                        # segment — self.f was opened on the last
                        # (now removed) file
                        self.f.close()
                        self.f = _open_append_0600(path)
                        self._fpath = path
                        self.seq, _ = parse_wal_name(
                            os.path.basename(path))
                    fsync_dir(self.dir)
                    log.warning(
                        "wal: repaired torn tail: kept %s%s, removed "
                        "%d later file(s) (%s)",
                        os.path.basename(path),
                        "" if off is None else f" (cut at byte {off})",
                        len(doomed), e)
                    repaired = True
                    return None
                raise

        while (rec := decode_or_repair()) is not None:
            if rec.type == ENTRY_TYPE:
                e = Entry.unmarshal(rec.data or b"")
                if e.index >= self.ri:
                    # dedup-by-index: an uncommitted tail may be
                    # overwritten after restart (wal/wal.go:171-175);
                    # a gap would slice out of range in the reference
                    if e.index - self.ri > len(ents):
                        raise WALError(
                            f"entry index gap: {e.index} after "
                            f"{len(ents)} entries from {self.ri}")
                    del ents[e.index - self.ri:]
                    ents.append(e)
                self.enti = e.index
            elif rec.type == STATE_TYPE:
                state = HardState.unmarshal(rec.data or b"")
            elif rec.type == METADATA_TYPE:
                if metadata is not None and metadata != rec.data:
                    raise MetadataConflictError()
                metadata = rec.data
            elif rec.type == CRC_TYPE:
                crc = self.decoder.crc.sum32()
                # a zero running crc means a fresh decoder (file head);
                # otherwise the chain must match (wal/wal.go:184-191)
                if crc != 0 and rec.crc != crc:
                    raise CRCMismatchError(
                        f"segment boundary crc: record={rec.crc:#x} "
                        f"running={crc:#x}")
                self.decoder.update_crc(rec.crc)
            else:
                raise WALError(f"unexpected block type {rec.type}")

        if self.enti < self.ri:
            raise IndexNotFoundError(
                f"last entry {self.enti} < requested {self.ri}")

        if repaired and state.commit > self.enti:
            # WALs written before the entries-before-state order (or
            # a tear inside the entry run) can leave a surviving
            # state record whose commit points past the surviving
            # entries; an unclamped commit makes the restarted node
            # skip its whole apply window (a silent zombie).  The
            # torn suffix was never acked, so clamping is safe.
            log.warning("wal: repaired tail — clamping commit %d to "
                        "last surviving entry %d", state.commit,
                        self.enti)
            state = HardState(term=state.term, vote=state.vote,
                              commit=self.enti)

        # close decoder, disable reading; chain the encoder's crc
        last_crc = self.decoder.last_crc()
        self.decoder.close()
        self.decoder = None
        self.ri = 0
        self.md = metadata
        self.encoder = _Encoder(self.f, last_crc)
        return metadata, state, ents

    # -- append ------------------------------------------------------------

    def cut(self) -> None:
        """Close the current segment and start seq+1 at enti+1
        (reference wal/wal.go:219-238)."""
        if self.encoder is None:
            raise WALError("wal not in append mode")
        try:
            _faults.hit("wal.cut")
        except OSError as e:
            if e.errno == errno.ENOSPC:
                raise EtcdNoSpace(cause=f"wal cut: {e}") from e
            raise
        fpath = os.path.join(self.dir, wal_name(self.seq + 1, self.enti + 1))
        f = _open_append_0600(fpath)
        self.sync()
        self.f.close()

        self.f = f
        self._fpath = fpath
        self.seq += 1
        prev_crc = self.encoder.crc.sum32()
        self.encoder = _Encoder(self.f, prev_crc)
        self._save_crc(prev_crc)
        self.encoder.encode(Record(type=METADATA_TYPE, data=self.md))
        # new segment's header records + directory entry durable
        # before any entry lands in it: a crash after cut() but
        # before the next save() must leave an openable chain
        self.sync()
        fsync_dir(self.dir)
        _CUT_CTR.inc()

    def gc(self, index: int) -> int:
        """Delete segment files wholly behind ``index`` — the durable
        snapshot index (segment GC; the reference's
        wal.ReleaseLockTo boundary).  Returns how many were removed.

        The segment CONTAINING ``index`` is always kept: restart
        replays from the snapshot index via ``select_segments``,
        which needs a file whose start is <= index.  CALLER CONTRACT:
        the snapshot superseding the deleted entries must already be
        durable (file + dir fsync) — the snapshotter's ``_save`` does
        exactly that before returning, and the durability checker's
        unsynced-delete rule guards the ordering inside this module.

        Crash-safe at any prefix: removal runs OLDEST-FIRST with a
        directory fsync after EACH unlink, so any crash-surviving
        subset is a seq-contiguous suffix still covering ``index``
        (the same per-remove discipline as the torn-tail repair,
        mirrored — that one removes newest-first to keep a contiguous
        PREFIX)."""
        _faults.hit("wal.gc")
        names = sorted(check_wal_names(os.listdir(self.dir)))
        i = search_index(names, index)
        if not i:  # None (index below the chain) or 0: nothing behind
            return 0
        dfd = os.open(self.dir, os.O_RDONLY)
        try:
            for name in names[:i]:
                os.remove(os.path.join(self.dir, name))
                os.fsync(dfd)
        finally:
            os.close(dfd)
        _GC_CTR.inc(i)
        log.info("wal: gc removed %d segment(s) behind index %d "
                 "(kept %s..)", i, index, names[i])
        return i

    def sync(self) -> None:
        """flush + fsync the append segment.  Failure semantics:
        ENOSPC raises the typed ``EtcdNoSpace`` (``save``
        rolls the file back to the pre-batch mark and the server
        enters read-only NOSPACE mode); ANY other fsync error is
        FAIL-STOP — after one failed fsync the kernel may have
        dropped the dirty pages while a retry reports success, so a
        server that retried could ack writes that no longer exist
        (the silent-loss class etcd grew panic-on-fsync-error for).
        This method either returns with the bytes durable, raises
        EtcdNoSpace with the file unchanged on disk semantics, or
        the process is down."""
        if self.f is None:
            return
        t0 = time.perf_counter()
        try:
            _faults.hit("wal.fsync")
            self.f.flush()
            os.fsync(self.f.fileno())
        except OSError as e:
            if e.errno == errno.ENOSPC:
                raise EtcdNoSpace(cause=f"wal fsync: {e}") from e
            _faults.fail_stop(
                f"wal fsync failed on {self._fpath}: {e} — a "
                f"server that retries fsync may silently lose "
                f"acked writes", e)
        _FSYNC_HIST.observe(time.perf_counter() - t0)

    def probe_space(self) -> None:
        """NOSPACE recovery probe: exercise the append + fsync seams
        without writing any record.  Raises ``EtcdNoSpace`` while
        the disk (or an armed ``enospc`` failpoint window) still
        refuses; returns cleanly once space is back so the server
        can leave read-only mode."""
        if self.f is None:
            raise WALError("wal closed")
        try:
            _faults.hit("wal.append")
            _faults.hit("wal.fsync")
            self.f.flush()
            os.fsync(self.f.fileno())
        except OSError as e:
            if e.errno == errno.ENOSPC:
                raise EtcdNoSpace(cause=f"nospace probe: {e}") from e
            _faults.fail_stop(
                f"wal probe fsync failed on {self._fpath}: {e}", e)

    def close(self) -> None:
        if self.decoder is not None:
            self.decoder.close()
            self.decoder = None
        if self.f is not None:
            if self.encoder is not None:
                try:
                    self.sync()
                except EtcdNoSpace:
                    # best-effort final sync on a full disk: every
                    # acked write was already fsynced by its save();
                    # anything buffered here was never acked
                    log.warning("wal: close() sync skipped (ENOSPC)")
            self.f.close()
            self.f = None

    def save_entry(self, e: Entry) -> None:
        if self.encoder is None:
            raise WALError("wal not in append mode (read_all first)")
        rec = Record(type=ENTRY_TYPE, data=e.marshal())
        self.encoder.encode(rec)
        self.enti = e.index

    def save_state(self, st: HardState) -> None:
        from ..wire import is_empty_hard_state

        if is_empty_hard_state(st):
            return
        if self.encoder is None:
            raise WALError("wal not in append mode (read_all first)")
        self.encoder.encode(Record(type=STATE_TYPE, data=st.marshal()))

    def save(self, st: HardState, ents: list[Entry]) -> None:
        """HardState + entries + fsync — the Ready-contract durability
        step (reference wal/wal.go:281-288, state record first for
        byte-layout parity; read_all's repair clamp covers the
        state-before-entries tear case).

        ENOSPC anywhere in the batch (write, flush, or fsync) rolls
        the segment back to the pre-batch mark — truncate below any
        bytes whose writeback the kernel may have dropped, fsync the
        truncation — and raises the typed ``EtcdNoSpace``: the WAL
        stays append-usable, nothing in the failed batch was ever
        acked, and everything before the mark was already durable
        from the previous save.  Any OTHER I/O error is fail-stop
        (see :meth:`sync`)."""
        if self.encoder is None:
            raise WALError("wal not in append mode (read_all first)")
        mark = (self.f.tell(), self.encoder.crc.sum32(), self.enti)
        try:
            _faults.hit("wal.append")
            self.save_state(st)
            for e in ents:
                self.save_entry(e)
        except OSError as e:
            if e.errno == errno.ENOSPC:
                self._rollback(mark, e)  # raises EtcdNoSpace
            _faults.fail_stop(
                f"wal append failed on {self._fpath}: {e}", e)
        if ents:
            _APPEND_CTR.inc(len(ents))
        try:
            self.sync()
        except EtcdNoSpace as e:
            self._rollback(mark, e)
            raise  # unreachable — _rollback always raises; keeps
            #        the no-return-without-fsync path explicit

    def _rollback(self, mark: tuple[int, int, int], cause) -> None:
        """Revert the append segment to the pre-batch ``mark`` after
        an ENOSPC: reopen (dropping any unflushable buffer),
        truncate to the mark (discarding bytes whose writeback may
        already have been dropped — they were never acked), fsync
        the truncation, and rebuild the encoder on the pre-batch
        rolling CRC.  Raises ``EtcdNoSpace``; if even the rollback
        fails the only honest state is fail-stop."""
        off, crc, enti = mark
        try:
            try:
                self.f.close()  # flush may re-raise ENOSPC: ignore
            except OSError:
                pass
            os.truncate(self._fpath, off)
            tfd = os.open(self._fpath, os.O_RDONLY)
            try:
                os.fsync(tfd)
            finally:
                os.close(tfd)
            self.f = _open_append_0600(self._fpath)
            self.encoder = _Encoder(self.f, crc)
            self.enti = enti
        except OSError as e:
            _faults.fail_stop(
                f"wal ENOSPC rollback failed on {self._fpath}: {e} "
                f"(original: {cause})", e)
        log.warning("wal: ENOSPC — rolled %s back to byte %d (%s)",
                    os.path.basename(self._fpath), off, cause)
        if isinstance(cause, EtcdNoSpace):
            raise cause
        raise EtcdNoSpace(cause=f"wal save: {cause}") from (
            cause if isinstance(cause, BaseException) else None)

    def _save_crc(self, prev_crc: int) -> None:
        self.encoder.encode(Record(type=CRC_TYPE, crc=prev_crc))
