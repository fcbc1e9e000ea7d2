"""The one etcd error the WAL raises (the port's copy of the part of
``etcd_tpu/utils/errors.py`` it uses)."""

from __future__ import annotations

ECODE_NO_SPACE = 405


class EtcdError(Exception):
    """An etcd numeric error (reference error/error.go:102-130)."""

    def __init__(self, error_code: int, message: str, cause: str = "",
                 index: int = 0):
        self.error_code = error_code
        self.message = message
        self.cause = cause
        self.index = index
        super().__init__(f"{message} ({cause})")


class EtcdNoSpace(EtcdError):
    """Typed ENOSPC degradation signal: a WAL writer could not allocate
    space.  Servers catching this enter a read-only NOSPACE mode; a
    failed fsync is never retried (that path is fail-stop,
    ``utils/faults.fail_stop``)."""

    def __init__(self, cause: str = "", index: int = 0):
        super().__init__(ECODE_NO_SPACE,
                         "No space on data disk; member is read-only",
                         cause, index)
