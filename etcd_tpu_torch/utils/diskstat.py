"""Durable-state footprint of one server data dir (the port's copy of
``etcd_tpu/utils/diskstat.py``).

The single copy of the WAL/snap directory walk behind every
bounded-disk gate — the soak's per-report disk series and the dist
bench's artifact rows read the same fields, so a future on-disk
layout change moves them together instead of silently diverging the
gates."""

from __future__ import annotations

import os


def wal_snap_usage(data_dir: str) -> dict:
    """``{wal_bytes, wal_segments, snap_bytes, snap_files}`` for one
    data dir (total bytes include non-suffix files — ``.broken``
    quarantines count toward snap_bytes; the *counts* are the gated
    quantities and track only live ``.wal``/``.snap`` files)."""
    out = {"wal_bytes": 0, "wal_segments": 0,
           "snap_bytes": 0, "snap_files": 0}
    for sub, bkey, ckey, suffix in (
            ("wal", "wal_bytes", "wal_segments", ".wal"),
            ("snap", "snap_bytes", "snap_files", ".snap")):
        d = os.path.join(data_dir, sub)
        try:
            names = os.listdir(d)
        except OSError:
            continue
        total = 0
        for n in names:
            try:
                total += os.path.getsize(os.path.join(d, n))
            except OSError:  # racing a live server's purge/GC
                pass
        out[bkey] = total
        out[ckey] = sum(1 for n in names if n.endswith(suffix))
    return out


__all__ = ["wal_snap_usage"]
