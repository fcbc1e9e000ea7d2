"""Write-ahead log: durable record log + batched device replay (the
port of ``etcd_tpu/wal``).

``WAL`` is the host read/write path (reference wal/wal.go seam:
Create/OpenAtIndex/ReadAll/Save/SaveEntry/SaveState/Cut/Sync/Close).
``replay_device`` adds the bulk replay lanes: native record framing +
the raw-CRC kernel on the card + GF(2) chain fix-up instead of the
reference's strictly-sequential decode loop; ``backend_policy`` routes
between them.
"""

from .errors import (
    CRCMismatchError,
    FileNotFoundError_,
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
    exist,
    parse_wal_name,
    search_index,
    select_segments,
    is_valid_seq,
    wal_name,
)

__all__ = [
    "WAL",
    "exist",
    "wal_name",
    "parse_wal_name",
    "search_index",
    "select_segments",
    "is_valid_seq",
    "METADATA_TYPE",
    "ENTRY_TYPE",
    "STATE_TYPE",
    "CRC_TYPE",
    "WALError",
    "MetadataConflictError",
    "FileNotFoundError_",
    "IndexNotFoundError",
    "CRCMismatchError",
    "TornTailError",
]
