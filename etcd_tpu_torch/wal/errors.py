"""WAL error vocabulary (reference wal/wal.go:44-49).

The wire layer owns the base CRC error (like walpb.ErrCRCMismatch,
wal/walpb/record.go:20); the WAL's ``CRCMismatchError`` subclasses both
it and ``WALError`` so callers can treat all replay corruption
uniformly with ``except WALError``.
"""

from ..wire.proto import CRCMismatchError as WireCRCMismatchError

__all__ = [
    "WALError",
    "MetadataConflictError",
    "FileNotFoundError_",
    "IndexNotFoundError",
    "CRCMismatchError",
    "TornTailError",
]


class WALError(Exception):
    pass


class TornTailError(WALError):
    """The stream ends mid-record (the reference's io.ErrUnexpectedEOF
    lane, wal/decoder.go:30-35): every byte from the failing record's
    start to the end of the file chain belongs to the torn record.

    All three scanners (host decoder, python scan, native scan) raise
    this exact type so strict-mode replay policy matches on the type,
    never on message text.
    """


class CRCMismatchError(WALError, WireCRCMismatchError):
    """Rolling checksum mismatch during replay (ErrCRCMismatch)."""


class MetadataConflictError(WALError):
    """Conflicting metadata found (ErrMetadataConflict)."""


class FileNotFoundError_(WALError):
    """No WAL file found for the requested index (ErrFileNotFound)."""


class IndexNotFoundError(WALError):
    """Requested index not present in the WAL (ErrIndexNotFound)."""
