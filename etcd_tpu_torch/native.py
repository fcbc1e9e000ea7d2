"""ctypes binding of the native WAL data-loader tier (``native/walscan.cc``).

The port's own copy of ``etcd_tpu/native/__init__.py``, trimmed to what
the replay lanes and the snapshot hash call: the framing scan
(``wal_scan``, ``scan_chunk``, ``wal_count_range``,
``alloc_scan_arrays``), the fused scan + chain verify (``scan_verify``),
the CRC-only chain sweep (``chain_verify``), row padding for the device
(``pad_rows``), the synthetic stream generator (``wal_gen``), the
SSE4.2 CRC (``crc32c_update``) and the co-hosted restart's GroupEntry
envelope sweep (``ge_scan``).

The library is built with ``g++`` from the repository's
``native/walscan.cc`` at first use, into ``etcd_tpu_torch/build/`` under
a name keyed by the source's bytes and the flags (as ``ops/crc_cuda.py``
keys the ``.cu`` files); nothing is written into ``native/``.
:func:`build` raises with the compiler's report when the build fails;
:func:`available` is False then, and every binding raises
:class:`NativeError` carrying that report.  Only ``read_all_device``
on route ``device`` or with no route scans in pure Python then
(``wal/replay_device.py:_scan_python``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG.parent / "native" / "walscan.cc"
BUILD_DIR = _PKG / "build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread",
             "-shared")

_lock = threading.Lock()
_lib = None
_tried = False
_error: Exception | None = None  # why the library did not load


class NativeError(RuntimeError):
    """Native-tier failure; ``code`` carries the C return code so
    wrappers can map classes of failure (torn tail, crc) onto the
    repo's typed exception vocabulary without message matching."""

    def __init__(self, msg: str, code: int = 0):
        super().__init__(msg)
        self.code = code


TRUNCATED = -1
PROTO_ERR = -2
CAPACITY = -3
CRC_MISMATCH = -4

_ERRORS = {
    TRUNCATED: "truncated stream",
    PROTO_ERR: "proto parse error",
    CAPACITY: "capacity exceeded",
    CRC_MISMATCH: "crc mismatch",
}


def _check(rc: int) -> int:
    if rc < 0:
        raise NativeError(_ERRORS.get(rc, f"native error {rc}"), rc)
    return rc


def library_path() -> Path:
    """Where the library built from ``SOURCE`` lives: keyed by the
    source's bytes and the compiler flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libwalscan_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``native/walscan.cc`` unless the library for its bytes
    exists; raises :class:`NativeError` with the compiler's stderr when
    the source, the compiler or the build fails."""
    if not SOURCE.exists():
        raise NativeError(f"{SOURCE} not found")
    so = library_path()
    if so.exists():
        return so
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeError(f"cannot run {cxx}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeError(f"{cxx} failed ({proc.returncode}) building "
                          f"{SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64, u32, i64 = ctypes.c_uint64, ctypes.c_uint32, ctypes.c_int64
    sigs = {
        "etcd_crc32c_update": (u32, [u32, u8p, u64]),
        "etcd_wal_count": (i64, [u8p, u64]),
        "etcd_wal_scan": (i64, [u8p, u64, i64p, u32p, u64p, u64p, u64p,
                                u64p, u64p, u64]),
        "etcd_chain_verify": (i64, [u8p, u64, u64p, u64p, u32p, u64, u32]),
        "etcd_chain_verify_mt": (i64, [u8p, u64, u64p, u64p, u32p, u64,
                                       u32, u64]),
        "etcd_wal_count_range": (i64, [u8p, u64, u64, u64, u64p]),
        "etcd_wal_scan_chunk": (i64, [u8p, u64, u64, u64, u32, i64, i64p,
                                      u32p, u64p, u64p, u64p, u64p, u64p,
                                      u64, u64p, i64p]),
        "etcd_wal_gen": (i64, [u64, u64, u64, u32, u8p, u64]),
        "etcd_pad_rows": (i64, [u8p, u64p, u64p, u64, u64, u8p]),
        "etcd_ge_scan": (i64, [u8p, u64, u64p, u64p, u64, i64p, i64p, i64p,
                               i64p, u64p, u64p]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    return lib


def _load():
    global _lib, _tried, _error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            _lib = _bind(ctypes.CDLL(str(build())))
        except (NativeError, OSError) as e:
            _lib, _error = None, e
        return _lib


def available() -> bool:
    return _load() is not None


def require():
    """The loaded library, or :class:`NativeError` with the reason it
    did not load (the compiler's report for a failed build)."""
    lib = _load()
    if lib is None:
        raise NativeError(f"native library unavailable: {_error}") \
            from _error
    return lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _u64(a: np.ndarray):
    return np.ascontiguousarray(a, np.uint64).ctypes.data_as(
        ctypes.POINTER(ctypes.c_uint64))


def crc32c_update(crc: int, data) -> int:
    """Go ``crc32.Update(crc, castagnoli, data)`` in one native sweep
    (SSE4.2 where the CPU has it)."""
    lib = _load()
    buf = np.frombuffer(memoryview(data), dtype=np.uint8) \
        if not isinstance(data, np.ndarray) else data
    if lib is None:
        from .crc import crc32c
        return crc32c.update(crc, buf.tobytes())
    buf = np.ascontiguousarray(buf).reshape(-1)
    return int(lib.etcd_crc32c_update(crc, _u8(buf), buf.size))


def wal_scan(blob: np.ndarray):
    """Framing pass: returns (types, crcs, data_off, data_len,
    ent_index, ent_term, ent_type) numpy arrays, one per record."""
    lib = require()
    # exact-size allocation via a cheap length-hop sweep
    cap = max(1, _check(lib.etcd_wal_count(_u8(blob), blob.size)))
    types, crcs, doff, dlen, eidx, eterm, etype = alloc_scan_arrays(cap)
    u64 = ctypes.POINTER(ctypes.c_uint64)
    n = _check(lib.etcd_wal_scan(
        _u8(blob), blob.size,
        types.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        crcs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        doff.ctypes.data_as(u64), dlen.ctypes.data_as(u64),
        eidx.ctypes.data_as(u64), eterm.ctypes.data_as(u64),
        etype.ctypes.data_as(u64), cap))
    return (types[:n], crcs[:n], doff[:n], dlen[:n], eidx[:n], eterm[:n],
            etype[:n])


def ge_scan(blob: np.ndarray, data_off: np.ndarray,
            data_len: np.ndarray):
    """Batched GroupEntry envelope parse over entry-data spans: returns
    (kind, group, gindex, gterm, payload_off, payload_len) int64/uint64
    arrays, the native sweep behind the co-hosted server's restart (one
    call instead of N ``GroupEntry.unmarshal``)."""
    lib = require()
    n = data_off.size
    kind, group, gindex, gterm = (np.empty(n, np.int64) for _ in range(4))
    poff = np.empty(n, np.uint64)
    plen = np.empty(n, np.uint64)
    i64 = ctypes.POINTER(ctypes.c_int64)
    u64 = ctypes.POINTER(ctypes.c_uint64)
    _check(lib.etcd_ge_scan(
        _u8(blob), blob.size, _u64(data_off), _u64(data_len), n,
        kind.ctypes.data_as(i64), group.ctypes.data_as(i64),
        gindex.ctypes.data_as(i64), gterm.ctypes.data_as(i64),
        poff.ctypes.data_as(u64), plen.ctypes.data_as(u64)))
    return kind, group, gindex, gterm, poff, plen


def chain_verify(blob: np.ndarray, data_off: np.ndarray,
                 data_len: np.ndarray, stored: np.ndarray,
                 seed: int = 0, threads: int = 1) -> int:
    """CRC-only rolling-chain verification over pre-scanned record
    spans (one native sweep; no re-parse).  ``threads > 1`` shards the
    sweep across record ranges (each link needs only its predecessor's
    *stored* value).  Returns ``stored.size`` when the chain verifies,
    else the index of the first bad record; raises on out-of-range
    spans."""
    lib = require()
    args = (
        _u8(blob), blob.size, _u64(data_off), _u64(data_len),
        np.ascontiguousarray(stored, np.uint32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint32)),
        data_off.size, seed)
    if threads > 1:
        return _check(lib.etcd_chain_verify_mt(*args, threads))
    return _check(lib.etcd_chain_verify(*args))


def wal_count_range(blob: np.ndarray, pos: int = 0,
                    budget: int | None = None) -> tuple[int, int]:
    """Length-hop record count over one chunk: ``(count, next_pos)``
    for the records a ``scan_chunk(pos, budget)`` call would emit."""
    lib = require()
    if budget is None:
        budget = blob.size
    nxt = ctypes.c_uint64()
    n = _check(lib.etcd_wal_count_range(_u8(blob), blob.size, pos,
                                        budget, ctypes.byref(nxt)))
    return n, nxt.value


_SCAN_DTYPES = (np.int64, np.uint32, np.uint64, np.uint64, np.uint64,
                np.uint64, np.uint64)


def alloc_scan_arrays(n: int) -> tuple:
    """Preallocated (types, crcs, data_off, data_len, ent_index,
    ent_term, ent_type) arrays for ``n`` records, which streaming
    callers hand to :func:`scan_chunk` via ``out``."""
    return tuple(np.empty(max(1, n), dt) for dt in _SCAN_DTYPES)


def scan_chunk(blob: np.ndarray, pos: int = 0,
               budget: int | None = None, seed: int = 0,
               verify: bool = False, out: tuple | None = None,
               out_base: int = 0):
    """One fused chunk sweep: frame + parse (+ rolling-chain CRC check
    when ``verify``) of the records starting at ``pos`` until at least
    ``budget`` bytes are consumed (a straddling record belongs to this
    chunk).  ``out``/``out_base`` write the records into preallocated
    whole-stream arrays starting at ``out_base``.  Returns ``(types,
    crcs, data_off, data_len, ent_index, ent_term, ent_type,
    next_pos)``; a CRC mismatch raises :class:`NativeError` with
    ``code == CRC_MISMATCH`` and ``bad_index`` = the chunk-local index
    of the first bad record."""
    lib = require()
    if budget is None:
        budget = blob.size
    if out is None:
        cap, _ = wal_count_range(blob, pos, budget)
        out = alloc_scan_arrays(cap)
        out_base = 0
        cap = max(1, cap)
    else:
        cap = out[0].size - out_base
        if cap <= 0:
            raise NativeError(_ERRORS[CAPACITY], CAPACITY)
    types, crcs, doff, dlen, eidx, eterm, etype = (
        a[out_base:] for a in out)
    u64 = ctypes.POINTER(ctypes.c_uint64)
    nxt = ctypes.c_uint64()
    bad = ctypes.c_int64()
    rc = lib.etcd_wal_scan_chunk(
        _u8(blob), blob.size, pos, budget, seed, 1 if verify else 0,
        types.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        crcs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        doff.ctypes.data_as(u64), dlen.ctypes.data_as(u64),
        eidx.ctypes.data_as(u64), eterm.ctypes.data_as(u64),
        etype.ctypes.data_as(u64), cap, ctypes.byref(nxt),
        ctypes.byref(bad))
    if rc == CRC_MISMATCH:
        e = NativeError(_ERRORS[CRC_MISMATCH], CRC_MISMATCH)
        e.bad_index = int(bad.value)
        e.bad_stored = int(crcs[bad.value]) if bad.value >= 0 else 0
        raise e
    n = _check(rc)
    return (types[:n], crcs[:n], doff[:n], dlen[:n], eidx[:n],
            eterm[:n], etype[:n], nxt.value)


def scan_verify(blob: np.ndarray, seed: int = 0):
    """Whole-stream FUSED scan + rolling-chain verify: parse and CRC in
    a single sweep over the blob.  Returns the same 7 arrays as
    :func:`wal_scan`; raises on corruption (CRC mismatches carry
    ``bad_index``/``bad_stored``)."""
    return scan_chunk(blob, 0, blob.size, seed=seed, verify=True)[:7]


def wal_gen(n_entries: int, payload_len: int, start_index: int = 1,
            seed: int = 0) -> np.ndarray:
    """A synthetic framed stream of ``n_entries`` entry records with
    ``payload_len`` pseudo-random payload bytes each, indexes from
    ``start_index``, its rolling CRC chain seeded with ``seed``."""
    lib = require()
    cap = n_entries * (payload_len + 64) + 64
    out = np.empty(cap, np.uint8)
    n = _check(lib.etcd_wal_gen(n_entries, payload_len, start_index,
                                seed, _u8(out), cap))
    return out[:n]


def pad_rows(blob: np.ndarray, data_off: np.ndarray, data_len: np.ndarray,
             width: int, out: np.ndarray | None = None) -> np.ndarray:
    """Right-align data spans into a zero-padded [n, width] buffer.

    ``out``, when given, is a writeable C-contiguous uint8 [n, width]
    destination, such as a pinned staging buffer of the stream lane."""
    lib = require()
    n = data_off.size
    if out is None:
        out = np.empty((n, width), np.uint8)
    elif (out.shape != (n, width) or out.dtype != np.uint8
          or not out.flags.c_contiguous or not out.flags.writeable):
        raise ValueError(
            "out must be writeable C-contiguous uint8 [n, width]")
    _check(lib.etcd_pad_rows(_u8(blob), _u64(data_off), _u64(data_len),
                             n, width, _u8(out)))
    return out
