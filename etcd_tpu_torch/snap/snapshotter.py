"""Snapshot persistence (reference snap/snapshotter.go:29-150).

Files are named ``%016x-%016x.snap`` (term, index) and contain a
snappb wrapper {crc, data} where crc is the whole-blob CRC32C and data
the marshaled raftpb Snapshot.  Load walks newest-first, quarantining
unreadable files as ``.broken`` so one corruption never masks an older
good snapshot.
"""

from __future__ import annotations

import errno
import logging
import os
from typing import Callable

from ..crc import value as crc_value
from ..utils import faults as _faults
from ..utils.errors import EtcdNoSpace
from ..utils.fsio import fsync as fsio_fsync, fsync_dir
from ..wire import SnapPb, Snapshot, is_empty_snap
from ..wire.proto import ProtoError

log = logging.getLogger(__name__)

SNAP_SUFFIX = ".snap"

#: snapshots retained after a successful save (newest-first); older
#: files and quarantined ``.broken`` files beyond the window are
#: purged so the snap dir stays bounded under sustained traffic
#: One durable snapshot would suffice for recovery; keeping
#: a few preserves the load() fallback ladder against a corrupt
#: newest file.
DEFAULT_SNAP_KEEP = 5


class SnapError(Exception):
    pass


class NoSnapshotError(SnapError):
    """No available snapshot (ErrNoSnapshot)."""


class SnapCRCMismatchError(SnapError):
    """Whole-file CRC mismatch (ErrCRCMismatch)."""


class SnapEmptyError(SnapError):
    """Empty snapshot file or payload."""


def snap_name(term: int, index: int) -> str:
    return f"{term:016x}-{index:016x}{SNAP_SUFFIX}"


class Snapshotter:
    """``crc_fn`` computes CRC32C of a blob from a zero seed; the
    default is the host path and the device kernel
    (ops.crc_kernel.device_crc32c) drops in for large blobs."""

    def __init__(self, dirpath: str,
                 crc_fn: Callable[[bytes], int] | None = None,
                 keep: int = DEFAULT_SNAP_KEEP):
        self.dir = dirpath
        self.crc_fn = crc_fn or crc_value
        if keep < 1:
            raise ValueError(f"keep={keep} must be >= 1 (a purge "
                             f"that deletes every snapshot would "
                             f"strand the GC'd WAL chain)")
        self.keep = keep

    def save_snap(self, snapshot: Snapshot) -> None:
        """No-op for empty snapshots (snapshotter.go:39-44)."""
        if is_empty_snap(snapshot):
            return
        self._save(snapshot)

    def _save(self, snapshot: Snapshot) -> None:
        fname = snap_name(snapshot.term, snapshot.index)
        b = snapshot.marshal()
        crc = self.crc_fn(b)
        d = SnapPb(crc=crc, data=b).marshal()
        fpath = os.path.join(self.dir, fname)
        # contents + directory entry fsynced before returning: the
        # callers cut the WAL right after save_snap, so a snapshot
        # that evaporates in a crash would strand the log tail
        # behind a segment boundary with no state to stand on.
        # ENOSPC (real or the snap.save failpoint) removes the
        # partial file — older durable snapshots remain, the caller
        # enters NOSPACE mode — and any OTHER fsync failure is
        # fail-stop (utils/fsio.fsync semantics, shared rule).
        try:
            _faults.hit("snap.save")
            with open(fpath, "wb") as f:
                f.write(d)
                # fsio.fsync: ENOSPC -> EtcdNoSpace, anything else
                # fail-stop (never returns on failure)
                fsio_fsync(f)
        except EtcdNoSpace:
            # fsync-time full disk: drop the partial file so a
            # truncated snapshot can never be loaded, then degrade
            try:
                os.remove(fpath)
            except OSError:
                pass
            fsync_dir(self.dir)
            raise
        except OSError as e:
            # open/write-time failure (fsync errors never get here)
            if e.errno == errno.ENOSPC:
                try:
                    os.remove(fpath)
                except OSError:
                    pass
                fsync_dir(self.dir)
                raise EtcdNoSpace(
                    cause=f"snapshot save {fname}: {e}") from e
            _faults.fail_stop(
                f"snapshot write failed on {fpath}: {e}", e)
        fsync_dir(self.dir)
        # the NEW snapshot is durable (file + dir entry) — only now
        # may older snapshots be deleted (delete-after-fsync; the
        # durability-ordering checker's unsynced-delete rule)
        self.purge()

    def purge(self) -> None:
        """Delete snapshots beyond the newest ``keep`` plus every
        quarantined ``.broken`` file older than the newest snapshot.

        Without this ``_snap_names`` grows forever under sustained
        snapshotting.  Crash-safe at any point: snapshots are
        independent files, so any surviving subset keeps load()
        working as long as the newest (already fsynced by _save) is
        present; a ``.broken`` newer than the newest kept snapshot is
        retained so the quarantine evidence of a corrupt latest file
        is not destroyed before an operator can see it."""
        try:
            names = os.listdir(self.dir)
        except OSError:  # pragma: no cover - dir vanished
            return
        snaps = sorted((n for n in names if n.endswith(SNAP_SUFFIX)),
                       reverse=True)
        doomed = snaps[self.keep:]
        if snaps:
            newest_kept = snaps[0]
            doomed += [n for n in names
                       if n.endswith(".broken")
                       and n[:-len(".broken")] < newest_kept]
        if not doomed:
            return
        for n in doomed:
            try:
                os.remove(os.path.join(self.dir, n))
            except OSError as e:  # pragma: no cover - racing purge
                log.warning("snapshotter purge cannot remove %s: %s",
                            n, e)
        # unlinks must stick: a crash-reverted purge would regrow the
        # dir and (worse) resurrect a .broken-masked ordering
        fsync_dir(self.dir)
        log.info("snapshotter: purged %d old snapshot file(s), "
                 "%d kept", len(doomed), min(len(snaps), self.keep))

    def retained_floor(self) -> int | None:
        """Smallest raft index among the retained ``.snap`` files —
        THE safe WAL-GC boundary.  Segments covering indexes at or
        above this must survive: ``load()`` falls back across every
        kept snapshot when the newest is corrupt, and the fallback
        target needs WAL coverage from ITS index to replay forward.
        GC'ing at the newest snapshot's index instead would make a
        single corrupt newest file unrecoverable despite K-1 good
        older snapshots."""
        try:
            names = os.listdir(self.dir)
        except OSError:
            return None
        idxs = []
        for n in names:
            if not n.endswith(SNAP_SUFFIX):
                continue
            try:
                _, _, idx_s = n[:-len(SNAP_SUFFIX)].partition("-")
                idxs.append(int(idx_s, 16))
            except ValueError:
                continue
        return min(idxs) if idxs else None

    def load(self) -> Snapshot:
        """Newest-first, falling back across corrupt files
        (snapshotter.go:62-74)."""
        names = self._snap_names()
        err: Exception = NoSnapshotError(self.dir)
        for name in names:
            try:
                return self._load_snap(name)
            except SnapError as e:
                err = e
        raise err

    def _load_snap(self, name: str) -> Snapshot:
        """Any failure quarantines the file (snapshotter.go:81-85
        defers renameBroken on every error path, reads included)."""
        fpath = os.path.join(self.dir, name)
        try:
            with open(fpath, "rb") as f:
                b = f.read()
        except OSError as e:
            log.warning("snapshotter cannot read file %s: %s", name, e)
            self._rename_broken(fpath)
            raise SnapError(str(e)) from e
        try:
            if not b:
                raise SnapEmptyError(name)
            serialized = SnapPb.unmarshal(b)
            if serialized.data is None:
                raise SnapEmptyError(name)
            crc = self.crc_fn(serialized.data)
            if crc != serialized.crc:
                log.warning("corrupted snapshot file %s: crc mismatch", name)
                raise SnapCRCMismatchError(name)
            try:
                return Snapshot.unmarshal(serialized.data)
            except ProtoError as e:
                raise SnapError(f"corrupted snapshot {name}: {e}") from e
        except ProtoError as e:
            log.warning("corrupted snapshot file %s: %s", name, e)
            self._rename_broken(fpath)
            raise SnapError(str(e)) from e
        except SnapError:
            self._rename_broken(fpath)
            raise

    def _snap_names(self) -> list[str]:
        """Snapshot filenames newest-first (snapshotter.go:115-131)."""
        names = os.listdir(self.dir)
        snaps = [n for n in names if n.endswith(SNAP_SUFFIX)]
        for n in names:
            if not n.endswith(SNAP_SUFFIX):
                log.warning("unexpected non-snap file %s", n)
        if not snaps:
            raise NoSnapshotError(self.dir)
        return sorted(snaps, reverse=True)

    @staticmethod
    def _rename_broken(path: str) -> None:
        broken = path + ".broken"
        try:
            os.rename(path, broken)
            # quarantine must stick across a crash — an un-fsynced
            # rename can revert, and the corrupt file would then
            # mask older good snapshots again on the next load
            fsync_dir(os.path.dirname(path))
        except OSError as e:  # pragma: no cover
            log.warning("cannot rename broken snapshot %s: %s", path, e)
