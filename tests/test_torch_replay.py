"""The port's WAL replay lanes (etcd_tpu_torch.wal.replay_device) on the
CPU against the JAX package's ``read_all_device`` on the same
directories: every route (``host``, ``device``, ``stream``) returns the
same metadata, HardState, EntryBlock arrays and chain tail, raises the
same exception class for torn tails, gaps, unknown record types and
missing indexes, and names the same first bad record.  The stream lane
equals the monolithic scan, and its overlap is shown with a fake
transport that records the chunks in flight, not with a clock."""

import os
import struct

import numpy as np
import pytest
import torch

from etcd_tpu import native as jnative
from etcd_tpu.ops import crc_device as jcrc_device
from etcd_tpu.wal import WAL as JWAL
from etcd_tpu.wal import replay_device as jreplay
from etcd_tpu.wire import Entry as JEntry
from etcd_tpu.wire import HardState as JHardState
from etcd_tpu.wire import Record as JRecord

from etcd_tpu_torch import native
from etcd_tpu_torch.obs.devledger import DeviceLedger, ledger
from etcd_tpu_torch.obs.metrics import Registry
from etcd_tpu_torch.ops.crc_device import raw_crc_batch, u32_numpy
from etcd_tpu_torch.wal import WAL, replay_device
from etcd_tpu_torch.wal.backend_policy import ENV_KNOB, set_policy
from etcd_tpu_torch.wal.errors import (
    CRCMismatchError,
    FileNotFoundError_,
    TornTailError,
    WALError,
)
from etcd_tpu_torch.wal.replay_device import (
    DeviceTransport,
    _scan_python,
    open_replay_device,
    read_all_device,
    stream_scan_verify,
    verify_chain_device,
)
from etcd_tpu_torch.wire import Entry, HardState

ROUTES = ("host", "device", "stream")
_ERR_NAMES = ("CRCMismatchError", "TornTailError", "WALError",
              "IndexNotFoundError", "FileNotFoundError_",
              "MetadataConflictError")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(ENV_KNOB, raising=False)
    yield
    set_policy(None)


def _write_wal(d, n_entries=20, cuts=(7, 14), start=0, sizes=None):
    """The reference test's WAL, written by the reference's writer."""
    w = JWAL.create(str(d), b"meta-bytes")
    idx = start
    for i in range(n_entries):
        size = sizes[i] if sizes else 8 + i % 32
        w.save_entry(JEntry(term=1 + i // 10, index=idx,
                            data=bytes([i % 256]) * size))
        if i + 1 in cuts:
            w.save_state(JHardState(term=1 + i // 10, vote=3, commit=idx))
            w.cut()
        idx += 1
    w.save_state(JHardState(term=2, vote=3, commit=idx - 1))
    w.sync()
    w.close()


def _ref_read(d, index=0):
    """The reference's batched lane on the same directory (its native
    verifier stands in for the card, as its own tests run it)."""
    return jreplay.read_all_device(str(d), index, route="device")


def _assert_same(got, want):
    md, st, block = got
    jmd, jst, jblock = want
    assert md == jmd
    assert (st.term, st.vote, st.commit) == \
        (jst.term, jst.vote, jst.commit)
    for k in ("index", "term", "type", "data_off", "data_len", "blob"):
        a, b = getattr(block, k), getattr(jblock, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert block.last_crc == jblock.last_crc
    assert [(e.index, e.term, e.type, e.data) for e in block.entries()] \
        == [(e.index, e.term, e.type, e.data) for e in jblock.entries()]


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - compared by class and text
        return type(e).__name__, str(e)
    return None


# -- parity on good WALs -------------------------------------------------------


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", ["cuts", "mid_index", "no_cut",
                                  "mixed_50000", "two_130KiB"])
def test_read_all_device_parity(tmp_path, route, case):
    d = tmp_path / "wal"
    index = 0
    if case == "cuts":
        _write_wal(d)
    elif case == "mid_index":
        _write_wal(d)
        index = 9
    elif case == "no_cut":
        _write_wal(d, n_entries=33, cuts=())
    elif case == "mixed_50000":
        _write_wal(d, n_entries=60, cuts=(30,),
                   sizes=[16] * 50 + [50000] + [24] * 9)
    else:
        _write_wal(d, n_entries=3, cuts=(),
                   sizes=[130 << 10, 130 << 10, 64])
    got = read_all_device(str(d), index, route=route, device="cpu")
    _assert_same(got, _ref_read(d, index))


def test_parity_with_the_reference_batched_pass(tmp_path, monkeypatch):
    """Against the reference's own bit-matmul verify (its accelerator
    switch turned off, as its tests do) and its stream lane."""
    monkeypatch.setattr(jreplay, "_accelerator_absent", lambda: False)
    d = tmp_path / "wal"
    _write_wal(d, n_entries=40, cuts=(13, 27))
    for route in ("device", "stream"):
        _assert_same(read_all_device(str(d), 0, route=route, device="cpu"),
                     jreplay.read_all_device(str(d), 0, route=route))


@pytest.mark.parametrize("route", ROUTES)
def test_overwrite_dedup(tmp_path, route):
    d = tmp_path / "wal"
    w = JWAL.create(str(d), b"m")
    for i in range(6):
        w.save_entry(JEntry(term=1, index=i, data=b"a" * 8))
    for i in range(3, 8):
        w.save_entry(JEntry(term=2, index=i, data=b"b" * 8))
    w.sync()
    w.close()
    got = read_all_device(str(d), 0, route=route, device="cpu")
    _assert_same(got, _ref_read(d))
    assert got[2].entry(3).term == 2


@pytest.mark.parametrize("route", ROUTES)
def test_real_server_wal_replays(tmp_path, route):
    d = tmp_path / "wal"
    w = WAL.create(str(d), b"\x08\x01")
    w.save(HardState(term=1, vote=1, commit=2),
           [Entry(term=1, index=0), Entry(term=1, index=1, data=b"cc"),
            Entry(term=1, index=2, data=b"dd")])
    w.close()
    got = read_all_device(str(d), 0, route=route, device="cpu")
    _assert_same(got, _ref_read(d))
    assert [int(i) for i in got[2].index] == [0, 1, 2]


def test_small_byte_budget_and_wide_rows(tmp_path):
    """A width class wider than the byte budget verifies one row a
    batch, through the wide-row fold (256 KiB rows)."""
    d = tmp_path / "wal"
    _write_wal(d, n_entries=3, cuts=(), sizes=[130 << 10, 130 << 10, 64])
    blob = np.fromfile(d / sorted(os.listdir(d))[0], dtype=np.uint8)
    types, crcs, doff, dlen, *_ = native.wal_scan(blob)
    verify_chain_device(blob, types, crcs, doff, dlen,
                        byte_budget=1 << 17, device="cpu")
    bad = blob.copy()
    bad[int(doff[3]) + 1000] ^= 0x01
    want = _raised(lambda: jnative.scan_verify(bad))
    assert want is not None
    with pytest.raises(CRCMismatchError, match="at record 3 "):
        verify_chain_device(bad, types, crcs, doff, dlen,
                            byte_budget=1 << 17, device="cpu")


def test_python_scan_fallback(tmp_path, monkeypatch):
    d = tmp_path / "wal"
    _write_wal(d, n_entries=8, cuts=(4,))
    monkeypatch.setattr(native, "available", lambda: False)
    got = read_all_device(str(d), 0, device="cpu")
    _assert_same(got, _ref_read(d))


@pytest.mark.parametrize("route", ROUTES)
def test_open_replay_device_append_continuation(tmp_path, route):
    """Appending after a replay keeps the chain valid for the
    reference's host reader and its native replay."""
    d = tmp_path / "wal"
    _write_wal(d, n_entries=10, cuts=(5,))
    w, md, st, block = open_replay_device(str(d), 0, route=route,
                                          device="cpu")
    assert md == b"meta-bytes" and len(block) == 10
    w.save(HardState(term=3, vote=1, commit=11),
           [Entry(term=3, index=10, data=b"post-device-1"),
            Entry(term=3, index=11, data=b"post-device-2")])
    w.cut()
    w.save_entry(Entry(term=3, index=12, data=b"post-cut"))
    w.sync()
    w.close()
    jw = JWAL.open_at_index(str(d), 0)
    _, st2, ents = jw.read_all()
    jw.close()
    assert [e.index for e in ents][-3:] == [10, 11, 12]
    assert st2.commit == 11
    _assert_same(read_all_device(str(d), 0, route=route, device="cpu"),
                 _ref_read(d))


# -- the same errors -----------------------------------------------------------


def _corrupt(d, at=0.5, name_index=0):
    path = d / sorted(os.listdir(d))[name_index]
    raw = bytearray(path.read_bytes())
    raw[int(len(raw) * at)] ^= 0xFF
    path.write_bytes(bytes(raw))


def _assert_same_error(d, index=0):
    want = _raised(lambda: jreplay.read_all_device(str(d), index,
                                                   route="host"))
    assert want is not None and want[0] in _ERR_NAMES
    for route in ROUTES:
        got = _raised(lambda: read_all_device(str(d), index, route=route,
                                              device="cpu"))
        assert got is not None and got[0] == want[0], (route, got, want)
        if want[0] == "CRCMismatchError":
            # the same first bad record and its stored value
            assert got[1] == want[1], route
    return want


@pytest.mark.parametrize("at", [0.3, 0.5, 0.9])
def test_corruption_names_the_same_record(tmp_path, at):
    d = tmp_path / "wal"
    _write_wal(d, n_entries=40, cuts=())
    _corrupt(d, at)
    kind, msg = _assert_same_error(d)
    assert kind in ("CRCMismatchError", "WALError")


def test_payload_flip_names_the_same_record(tmp_path):
    d = tmp_path / "wal"
    _write_wal(d, n_entries=40, cuts=(20,))
    path = d / sorted(os.listdir(d))[0]
    blob = np.fromfile(path, dtype=np.uint8)
    _, _, doff, dlen, *_ = native.wal_scan(blob)
    raw = bytearray(path.read_bytes())
    raw[int(doff[11]) + int(dlen[11]) - 3] ^= 0x01
    path.write_bytes(bytes(raw))
    kind, msg = _assert_same_error(d)
    assert kind == "CRCMismatchError" and "at record 11 " in msg


@pytest.mark.parametrize("cut", [1, 5, 9, 30])
def test_torn_tail(tmp_path, cut):
    d = tmp_path / "wal"
    _write_wal(d, n_entries=12, cuts=(6,))
    path = d / sorted(os.listdir(d))[-1]
    path.write_bytes(path.read_bytes()[:-cut])
    assert _assert_same_error(d)[0] == "TornTailError"


def test_index_gap(tmp_path):
    d = tmp_path / "wal"
    w = JWAL.create(str(d), b"m")
    for i in (0, 1, 2, 5):
        w.save_entry(JEntry(term=1, index=i, data=b"g"))
    w.close()
    kind, msg = _assert_same_error(d)
    assert kind == "WALError" and "entry index gap" in msg


def test_unknown_record_type(tmp_path):
    from etcd_tpu.wal.wal import _Encoder

    d = tmp_path / "wal"
    _write_wal(d, n_entries=3, cuts=())
    fname = sorted(os.listdir(d))[0]
    blob = np.fromfile(d / fname, dtype=np.uint8)
    crcs = jnative.wal_scan(blob)[1]
    with open(d / fname, "ab") as f:
        _Encoder(f, int(crcs[-1])).encode(JRecord(type=9, data=b"future"))
    kind, msg = _assert_same_error(d)
    assert msg == "unexpected block type 9"


def test_index_not_found_and_missing_dir(tmp_path):
    d = tmp_path / "wal"
    _write_wal(d, n_entries=5, cuts=())
    assert _assert_same_error(d, 99)[0] == "IndexNotFoundError"
    os.makedirs(tmp_path / "empty")
    for route in ROUTES:
        with pytest.raises(FileNotFoundError_):
            read_all_device(str(tmp_path / "empty"), 0, route=route,
                            device="cpu")


def test_native_error_maps_by_code(tmp_path, monkeypatch):
    d = tmp_path / "wal"
    _write_wal(d, n_entries=3, cuts=())
    for msg, code, exc in (
            ("truncated stream", native.TRUNCATED, TornTailError),
            ("crc mismatch", native.CRC_MISMATCH, CRCMismatchError),
            ("proto parse error", native.PROTO_ERR, WALError)):
        def raiser(blob, *a, _msg=msg, _code=code, **k):
            raise native.NativeError(_msg, _code)
        monkeypatch.setattr(native, "wal_scan", raiser)
        monkeypatch.setattr(native, "scan_verify", raiser)
        for route in ("host", "device"):
            with pytest.raises(exc, match=msg.split()[0]):
                read_all_device(str(d), 0, route=route, device="cpu")


# -- the python scanner --------------------------------------------------------


def _blob(raw: bytes) -> np.ndarray:
    return np.frombuffer(raw, dtype=np.uint8).copy()


@pytest.mark.parametrize("raw", [
    struct.pack("<q", -8),                                     # negative
    struct.pack("<q", 8) + bytes([0x08, 0x01, 0x10, 0x00, 0x1A, 0x08])
    + b"xx",                                                   # overrun
    struct.pack("<q", 5) + bytes([0x0A, 0x01, 0x01, 0x10, 0x00]),  # wt
    struct.pack("<q", 10) + JRecord(type=1, crc=7, data=b"hello")
    .marshal()[:9] + b"\x00",                                  # tag 0
    struct.pack("<q", 40) + b"abc",                            # torn
    b"\x01\x02",                                               # torn hdr
])
def test_python_scan_rejects_like_the_reference(raw):
    want = _raised(lambda: jreplay._scan_python(_blob(raw)))
    got = _raised(lambda: _scan_python(_blob(raw)))
    assert want is not None and got == want


def test_python_scan_exact_offsets():
    recs = [JRecord(type=1, crc=0x01, data=b"\x01"),
            JRecord(type=2, crc=0x1A2B, data=b"\x10\x1a"),
            JRecord(type=1, crc=7, data=b"")]
    raw = b"".join(struct.pack("<q", len(m)) + m
                   for m in (r.marshal() for r in recs))
    got, want = _scan_python(_blob(raw)), jreplay._scan_python(_blob(raw))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got, native.wal_scan(_blob(raw)))


# -- the stream lane -----------------------------------------------------------


def _wal_blob(d, n_entries=120, cuts=(40, 80), sizes=None):
    w = JWAL.create(str(d), b"meta")
    for i in range(n_entries):
        size = sizes[i] if sizes else 30 + (i * 7) % 200
        w.save_entry(JEntry(term=1, index=i, data=bytes([i % 256]) * size))
        if i + 1 in cuts:
            w.save_state(JHardState(term=1, vote=3, commit=i))
            w.cut()
    w.sync()
    w.close()
    return np.concatenate([np.fromfile(os.path.join(str(d), f), np.uint8)
                           for f in sorted(os.listdir(str(d)))])


def _assert_arrays_equal(a, b):
    assert len(a) == len(b) == 7
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype, i
        np.testing.assert_array_equal(x, y, err_msg=f"array {i}")


@pytest.mark.parametrize("route", ["host", "stream"])
@pytest.mark.parametrize("chunk_bytes", [257, 513, 4096, 1 << 20])
def test_stream_lane_equals_monolithic_scan(tmp_path, route, chunk_bytes):
    blob = _wal_blob(tmp_path / "wal")
    got = stream_scan_verify(blob, route=route, chunk_bytes=chunk_bytes,
                             device="cpu")
    _assert_arrays_equal(native.wal_scan(blob), got)
    _assert_arrays_equal(jnative.wal_scan(blob), got)


def test_stream_corruption_names_the_reference_record(tmp_path):
    blob = _wal_blob(tmp_path / "wal", cuts=())
    bad = blob.copy()
    bad[bad.size // 2] ^= 0xFF
    want = _raised(lambda: jreplay.stream_scan_verify(
        bad, route="host", chunk_bytes=777))
    assert want[0] == "CRCMismatchError"
    for route in ("host", "stream"):
        got = _raised(lambda: stream_scan_verify(
            bad, route=route, chunk_bytes=777, device="cpu"))
        assert got == want, route


@pytest.mark.parametrize("route", ["host", "stream"])
@pytest.mark.parametrize("cut", [1, 5, 9])
def test_stream_torn_tail_in_last_chunk(tmp_path, route, cut):
    blob = _wal_blob(tmp_path / "wal", n_entries=30, cuts=())
    with pytest.raises(TornTailError):
        stream_scan_verify(blob[:blob.size - cut].copy(), route=route,
                           chunk_bytes=512, device="cpu")


def test_stream_empty_and_single_chunk(tmp_path):
    blob = _wal_blob(tmp_path / "wal", n_entries=3, cuts=())
    for route in ("host", "stream"):
        _assert_arrays_equal(native.wal_scan(blob), stream_scan_verify(
            blob, route=route, chunk_bytes=1 << 30, device="cpu"))
        got = stream_scan_verify(np.zeros(0, np.uint8), route=route,
                                 chunk_bytes=64, device="cpu")
        assert all(a.size == 0 for a in got)


class _CountingTransport(DeviceTransport):
    """The CPU transport, recording how many verifies are in flight
    (dispatched, not yet collected) each time one is dispatched."""

    def __init__(self):
        super().__init__(device="cpu")
        self.outstanding = 0
        self.at_dispatch = []
        self.staged = []

    def stage(self, n, width):
        self.staged.append((n, width))
        return super().stage(n, width)

    def verify(self, shipped, stored):
        self.at_dispatch.append(self.outstanding)
        self.outstanding += 1
        return super().verify(shipped, stored)

    def collect(self, handle):
        self.outstanding -= 1
        return super().collect(handle)


@pytest.mark.parametrize("depth", [2, 3, 4])
def test_stream_overlaps_chunks(tmp_path, depth):
    """Chunk k+1 is dispatched while chunk k..k-depth+2 are still in
    flight, never more: the double buffering holds ``depth - 1`` chunks
    open on the device seam, and the result stays bit-exact."""
    blob = _wal_blob(tmp_path / "wal", n_entries=40, cuts=(),
                     sizes=[64] * 40)
    fake = _CountingTransport()
    got = stream_scan_verify(blob, route="stream", chunk_bytes=1,
                             transport=fake, depth=depth)
    _assert_arrays_equal(native.wal_scan(blob), got)
    assert len(fake.at_dispatch) >= 40  # one verify a record-sized chunk
    assert max(fake.at_dispatch) == depth - 1
    assert fake.at_dispatch[:depth] == list(range(depth))
    assert fake.outstanding == 0
    assert all(w == 128 for _, w in fake.staged[2:])


def test_stream_fake_transport_catches_corruption(tmp_path):
    blob = _wal_blob(tmp_path / "wal", n_entries=20, cuts=())
    t, c, do, dl, *_ = native.wal_scan(blob)
    bad = blob.copy()
    bad[int(do[11]) + int(dl[11]) - 3] ^= 0x01
    with pytest.raises(CRCMismatchError, match="at record 11 "):
        stream_scan_verify(bad, route="stream", chunk_bytes=256,
                           transport=_CountingTransport())


def test_stream_progress_lands_in_the_ledger(tmp_path):
    blob = _wal_blob(tmp_path / "wal", n_entries=60, cuts=())
    before = ledger.snapshot().get("replay.stream", {})
    stream_scan_verify(blob, route="stream", chunk_bytes=1024,
                       device="cpu")
    after = ledger.snapshot()["replay.stream"]
    for key in ("dispatches", "h2d_bytes", "d2h_bytes"):
        assert after[key] > before.get(key, 0), key


def test_ledger_block_returns_its_value_and_bills_the_wait():
    led = DeviceLedger(Registry())
    t = torch.arange(5)
    assert led.block("s", t) is t
    assert led.block("s", "not a tensor") == "not a tensor"
    with led.dispatch("s"):
        pass
    led.h2d("s", np.zeros(7, np.uint8), b"abc")
    led.d2h("s", t)
    snap = led.snapshot()["s"]
    assert snap["dispatches"] == 1 and snap["block_seconds"] >= 0
    assert snap["h2d_bytes"] == 10 and snap["d2h_bytes"] == t.nbytes


# -- devices and routes ----------------------------------------------------------


def test_device_lanes_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is the card")
    d = tmp_path / "wal"
    _write_wal(d, n_entries=4, cuts=())
    for route in ("device", "stream"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            read_all_device(str(d), 0, route=route)
    blob = np.fromfile(d / sorted(os.listdir(d))[0], dtype=np.uint8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        stream_scan_verify(blob, route="stream")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        verify_chain_device(blob, *native.wal_scan(blob)[:4])
    # the host lane and the host verifier touch no device
    _assert_same(read_all_device(str(d), 0, route="host"), _ref_read(d))
    verify_chain_device(blob, *native.wal_scan(blob)[:4], route="host")


def test_router_sends_small_wals_to_the_host(tmp_path, monkeypatch):
    d = tmp_path / "wal"
    _write_wal(d)
    calls = []
    real = native.scan_verify
    monkeypatch.setattr(native, "scan_verify",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _assert_same(read_all_device(str(d), 0), _ref_read(d))
    assert calls == [1]
    monkeypatch.setenv(ENV_KNOB, "device")
    set_policy(None)
    _assert_same(read_all_device(str(d), 0, device="cpu"), _ref_read(d))
    assert calls == [1]
    with pytest.raises(ValueError, match="unknown replay route"):
        read_all_device(str(d), 0, route="tpu", device="cpu")


def test_host_verifier_names_the_same_record(tmp_path):
    blob = _wal_blob(tmp_path / "wal", n_entries=50, cuts=())
    types, crcs, doff, dlen, *_ = native.wal_scan(blob)
    bad = blob.copy()
    bad[int(doff[23]) + 2] ^= 0x04
    msgs = set()
    for route in ("host", "device"):
        with pytest.raises(CRCMismatchError) as e:
            verify_chain_device(bad, types, crcs, doff, dlen, route=route,
                                device="cpu")
        msgs.add(str(e.value))
    assert len(msgs) == 1 and "at record 23 " in msgs.pop()


# -- rows wider than the kernel ------------------------------------------------


_DLENS = np.array([0, 1, 60, 64, 65, 124, 125, 128, 129, 2044, 2045, 2048,
                   2049, 4092, 4093, 4096, 4097, 50_000, 130 << 10],
                  np.uint64)


def test_width_classes_match_the_reference():
    """The stream lane's classes are the reference's ``_width_classes``;
    the monolithic lane's are its ``verify_chain_device`` formula
    (``dlen``, at least 64)."""
    np.testing.assert_array_equal(
        replay_device._width_classes(_DLENS, spare=4, floor=128),
        jreplay._width_classes(_DLENS))
    mono = np.where(
        _DLENS <= 2048,
        np.maximum(64, -(-_DLENS.astype(np.int64) // 128) * 128),
        np.int64(1) << np.ceil(np.log2(np.maximum(_DLENS, 1).astype(
            np.float64))).astype(np.int64))
    np.testing.assert_array_equal(
        replay_device._width_classes(_DLENS, spare=0, floor=64), mono)


@pytest.mark.parametrize("length", [4097, 8192, 3 * 4096 + 17])
def test_wide_rows_match_the_jax_raw_crc(length):
    rng = np.random.default_rng(length)
    lens = np.array([length, 0, 1, 4096, 4097, length - 5])
    buf = rng.integers(0, 256, size=(lens.size, length), dtype=np.uint8)
    buf[np.arange(length)[None, :] < (length - lens)[:, None]] = 0
    want = np.asarray(jcrc_device.raw_crc_batch(buf, use_pallas=False))
    got = u32_numpy(raw_crc_batch(torch.from_numpy(buf)))
    np.testing.assert_array_equal(got, want)
    assert replay_device.raw_crc_batch is raw_crc_batch


@pytest.mark.parametrize("route", ["host", "stream"])
def test_named_host_lanes_need_the_native_scanner(tmp_path, monkeypatch,
                                                  route):
    """A failed build of the native scanner is an error naming the
    build's report on the lanes that run it, never a quiet switch to
    the pure-Python scan; an unknown route is refused before either."""
    d = tmp_path / "wal"
    _write_wal(d, n_entries=4, cuts=())
    report = native.NativeError("g++ failed (1) building walscan.cc: boom")
    monkeypatch.setattr(native, "_load", lambda: None)
    monkeypatch.setattr(native, "_error", report)
    assert not native.available()
    with pytest.raises(native.NativeError, match="walscan.cc: boom"):
        read_all_device(str(d), 0, route=route, device="cpu")
    blob = np.fromfile(d / sorted(os.listdir(d))[0], dtype=np.uint8)
    with pytest.raises(native.NativeError, match="walscan.cc: boom"):
        stream_scan_verify(blob, route=route, device="cpu")
    with pytest.raises(ValueError, match="unknown replay route"):
        read_all_device(str(d), 0, route="tpu", device="cpu")
    _assert_same(read_all_device(str(d), 0, route="device", device="cpu"),
                 _ref_read(d))
