"""Durable-filesystem helpers of the WAL (the port's copy of
``etcd_tpu/utils/fsio.py``).

A file's contents become durable on ``fsync(fd)``; its directory entry
(creation, rename, unlink) only on an fsync of the directory.  Both
helpers are failpoints (``fsio.fsync``, ``fsio.fsync_dir``).
:func:`fsync` treats ENOSPC as the graceful-degradation signal (typed
``EtcdNoSpace``) and every other fsync failure as fail-stop.
"""

from __future__ import annotations

import errno
import os

from . import faults as _faults


def fsync(f) -> None:
    """flush + fsync a writable file object (or fsync a raw fd).
    ENOSPC raises ``EtcdNoSpace``; any other OSError is fail-stop."""
    try:
        _faults.hit("fsio.fsync")
        if isinstance(f, int):
            os.fsync(f)
        else:
            f.flush()
            os.fsync(f.fileno())
    except OSError as e:
        if e.errno == errno.ENOSPC:
            from .errors import EtcdNoSpace

            raise EtcdNoSpace(cause=f"fsync: {e}") from e
        _faults.fail_stop(f"fsync failed, cannot trust the page "
                          f"cache any further: {e}", e)


def fsync_dir(dirpath: str) -> None:
    """fsync a directory so entry mutations inside it survive a crash.
    Best-effort: an OSError (including an injected one) is swallowed,
    as the reference's fileutil does."""
    try:
        _faults.hit("fsio.fsync_dir")
        fd = os.open(dirpath, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)
