"""Named failpoints of the WAL's I/O seams, and the fail-stop exit.

The port's copy of the part of ``etcd_tpu/utils/faults.py`` that the WAL
and the snapshotter call, with the same failpoint names.  A seam calls
``hit("wal.fsync")``; a configured rule makes that call raise
``OSError(errno)``: ``err(EIO)`` or ``enospc()``, on every matching
call or, with ``once``, on the first only.  Rules come from a spec
string such as ``"wal.fsync=err(EIO,once);wal.append=enospc()"`` set
with :func:`configure`.  Every activation is counted in
``etcd_fault_injected_total{point,action}``.

:func:`fail_stop` is the one exit taken when an fsync fails with
anything but ENOSPC: after a failed fsync the kernel may have dropped
the dirty pages while a retry reports success, so the process exits
(status :data:`FAIL_STOP_EXIT`) instead of retrying into silent loss.
"""

from __future__ import annotations

import errno as _errno
import logging
import os
import sys

from ..obs import metrics as _obs

log = logging.getLogger(__name__)

#: process exit status of a fail-stop
FAIL_STOP_EXIT = 66

#: the failpoint vocabulary of the seams the port has
FAULT_CATALOG: dict[str, str] = {
    "fsio.fsync": "file-content fsync helper (torn-tail repair); err => "
                  "fail-stop, enospc => EtcdNoSpace",
    "fsio.fsync_dir": "directory-entry fsync; injected errors are "
                      "swallowed (activation still counted)",
    "wal.append": "WAL.save entry (before any byte is written) + the "
                  "NOSPACE recovery probe",
    "wal.fsync": "WAL.sync before os.fsync; err(EIO) here must produce a "
                 "fail-stop exit",
    "wal.cut": "WAL segment cut entry",
    "wal.gc": "WAL segment GC entry",
    "snap.save": "Snapshotter save entry (before the file is opened); "
                 "enospc => EtcdNoSpace, err => fail-stop",
}


class FaultSpecError(ValueError):
    """Malformed spec, unknown failpoint/action/qualifier."""


class FailStopError(RuntimeError):
    """Raised instead of exiting when a test hook replaces the
    fail-stop exit (:func:`set_fail_stop`)."""


class _Rule:
    """One parsed failpoint rule: raise ``OSError(err_no)`` at
    ``point``, once or on every call."""

    def __init__(self, point: str, action: str, args: list[str],
                 spec: str):
        self.point, self.action, self.spec = point, action, spec
        args = [a.strip() for a in args if a.strip()]
        self.once = "once" in args
        names = [a for a in args if a != "once"]
        if action == "enospc" and not names:
            self.err_no = _errno.ENOSPC
        elif action == "err" and len(names) == 1 \
                and isinstance(getattr(_errno, names[0].upper(), None), int):
            self.err_no = getattr(_errno, names[0].upper())
        else:
            raise FaultSpecError(f"bad arguments in {spec!r}")
        self.spent = False


def _parse_spec(spec: str) -> tuple[_Rule, ...]:
    rules = []
    for part in (p.strip() for p in spec.split(";") if p.strip()):
        point, sep, rhs = (x.strip() for x in part.partition("="))
        if not sep:
            raise FaultSpecError(f"missing '=' in {part!r}")
        if point not in FAULT_CATALOG:
            raise FaultSpecError(f"unknown failpoint {point!r}")
        action, _, argstr = rhs.removesuffix(")").partition("(")
        if action.strip() not in ("err", "enospc"):
            raise FaultSpecError(f"unknown action {action!r}")
        rules.append(_Rule(point, action.strip(), argstr.split(","), part))
    return tuple(rules)


_rules: tuple[_Rule, ...] = ()


def configure(spec: str) -> None:
    """Replace the active rule set with ``spec`` (empty clears).  Raises
    :class:`FaultSpecError` on any bad name."""
    global _rules
    _rules = _parse_spec((spec or "").strip())


def clear() -> None:
    configure("")


def hit(point: str) -> None:
    """One failpoint crossing: returns to proceed, raises
    ``OSError(errno)`` where a rule fires.  The no-rules path is one
    tuple read."""
    for rule in _rules:
        if rule.point != point or rule.spent:
            continue
        rule.spent = rule.once
        _obs.registry.counter("etcd_fault_injected_total", point=point,
                              action=rule.action).inc()
        raise OSError(rule.err_no, f"fault injected: {rule.spec}")


_fail_stop_hook = None


def set_fail_stop(fn):
    """Test hook: replace the process exit.  The hook runs, then
    :class:`FailStopError` is raised so control still never returns to
    the failing I/O path.  Returns the previous hook."""
    global _fail_stop_hook
    prev, _fail_stop_hook = _fail_stop_hook, fn
    return prev


def fail_stop(reason: str, exc: BaseException | None = None):
    """Terminal exit for unrecoverable I/O errors (fsync EIO):
    ``os._exit(FAIL_STOP_EXIT)``, never a retry."""
    log.critical("FAIL-STOP: %s (%s)", reason,
                 exc if exc is not None else "no exception")
    if _fail_stop_hook is not None:
        _fail_stop_hook(reason, exc)
        raise FailStopError(reason)
    sys.stderr.flush()
    os._exit(FAIL_STOP_EXIT)


__all__ = [
    "FAIL_STOP_EXIT", "FAULT_CATALOG", "FailStopError", "FaultSpecError",
    "clear", "configure", "fail_stop", "hit", "set_fail_stop",
]
