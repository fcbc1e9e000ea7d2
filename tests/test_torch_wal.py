"""The port's WAL writer, its proto codecs and its failpoints
(etcd_tpu_torch.wal, .wire, .utils) against the JAX package's: the same
saves write byte-equal segment files, cuts included, and each package
reads the other's files back."""

import errno
import os

import numpy as np
import pytest

from etcd_tpu.wal import WAL as JWAL
from etcd_tpu.wire import Entry as JEntry
from etcd_tpu.wire import HardState as JHardState
from etcd_tpu.wire import Record as JRecord
from etcd_tpu.wire.proto import ProtoError as JProtoError

from etcd_tpu_torch.utils import faults
from etcd_tpu_torch.utils.errors import EtcdNoSpace
from etcd_tpu_torch.wal import WAL, CRCMismatchError, TornTailError
from etcd_tpu_torch.wire import Entry, HardState, Record
from etcd_tpu_torch.wire.proto import ProtoError


def _saves(seed: int, n: int = 40, cuts=(9, 25), base: int = 0):
    """A seeded script of WAL saves: entries of random sizes (0..600
    bytes) with indexes from ``base``, HardStates, cuts."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n):
        size = int(rng.integers(0, 600))
        ops.append(("entry", dict(term=1 + i // 7, index=base + i,
                                  data=rng.bytes(size))))
        if i % 5 == 4:
            ops.append(("state", dict(term=1 + i // 7, vote=int(
                rng.integers(1, 6)), commit=base + i)))
        if i + 1 in cuts:
            ops.append(("cut", {}))
    return ops


def _play(wal_cls, entry_cls, state_cls, d, ops, metadata=b"node-meta"):
    w = wal_cls.create(str(d), metadata)
    batch = []
    for kind, kw in ops:
        if kind == "entry":
            batch.append(entry_cls(**kw))
        elif kind == "state":
            w.save(state_cls(**kw), batch)
            batch = []
        else:
            if batch:
                w.save(state_cls(), batch)
                batch = []
            w.cut()
    if batch:
        w.save(state_cls(), batch)
    w.close()


def _files(d):
    return {name: (d / name).read_bytes() for name in sorted(os.listdir(d))}


@pytest.mark.parametrize("seed,cuts", [(0, ()), (1, (9, 25)),
                                       (2, (1, 2, 3, 39))])
def test_wal_files_byte_equal(tmp_path, seed, cuts):
    # indexes past 2^20 for multi-byte varints
    ops = _saves(seed, cuts=cuts, base=1 << 20)
    _play(JWAL, JEntry, JHardState, tmp_path / "ref", ops)
    _play(WAL, Entry, HardState, tmp_path / "port", ops)
    ref, port = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert list(ref) == list(port) and len(port) == len(cuts) + 1
    for name in ref:
        assert port[name] == ref[name], name


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("index", [0, 12])
def test_each_package_reads_the_others_files(tmp_path, writer, index):
    ops = _saves(3)
    if writer == "ref":
        _play(JWAL, JEntry, JHardState, tmp_path, ops)
    else:
        _play(WAL, Entry, HardState, tmp_path, ops)
    jw = JWAL.open_at_index(str(tmp_path), index)
    jmd, jst, jents = jw.read_all()
    jw.close()
    w = WAL.open_at_index(str(tmp_path), index)
    md, st, ents = w.read_all()
    w.close()
    assert md == jmd
    assert (st.term, st.vote, st.commit) == (jst.term, jst.vote, jst.commit)
    assert [(e.type, e.term, e.index, e.data) for e in ents] == \
        [(e.type, e.term, e.index, e.data) for e in jents]


def test_append_after_read_all_stays_byte_equal(tmp_path):
    for name, (wal_cls, entry_cls, state_cls) in {
            "ref": (JWAL, JEntry, JHardState),
            "port": (WAL, Entry, HardState)}.items():
        d = tmp_path / name
        _play(wal_cls, entry_cls, state_cls, d, _saves(4, n=12, cuts=(5,)))
        w = wal_cls.open_at_index(str(d), 0)
        w.read_all()
        w.save(state_cls(term=9, vote=1, commit=3),
               [entry_cls(term=9, index=12, data=b"tail")])
        w.cut()
        w.save_entry(entry_cls(term=9, index=13, data=b"cut"))
        w.close()
    assert _files(tmp_path / "ref") == _files(tmp_path / "port")


@pytest.mark.parametrize("seed", range(4))
def test_proto_round_trips_match(seed):
    rng = np.random.default_rng(seed)
    big = [0, 1, 127, 128, 300, (1 << 32) - 1, (1 << 63) + 5,
           (1 << 64) - 1]
    for _ in range(50):
        t, i, c = (big[int(rng.integers(len(big)))] if rng.random() < 0.5
                   else int(rng.integers(0, 1 << 40)) for _ in range(3))
        data = rng.bytes(int(rng.integers(0, 300)))
        pairs = [
            (Entry(type=t % 2, term=i, index=c, data=data),
             JEntry(type=t % 2, term=i, index=c, data=data)),
            (HardState(term=t, vote=i, commit=c),
             JHardState(term=t, vote=i, commit=c)),
            (Record(type=t, crc=c, data=data), JRecord(type=t, crc=c,
                                                      data=data)),
            (Record(type=t, crc=c), JRecord(type=t, crc=c)),
        ]
        for mine, ref in pairs:
            raw = mine.marshal()
            assert raw == ref.marshal()
            back = type(mine).unmarshal(raw)
            jback = type(ref).unmarshal(raw)
            for f in mine.__slots__:
                assert getattr(back, f) == getattr(jback, f) \
                    == getattr(mine, f)


@pytest.mark.parametrize("raw", [
    b"\x00",                   # illegal tag 0
    b"\x0a\x01\x01",           # field 1 sent length-delimited
    b"\x08",                   # truncated varint
    b"\x1a\x05ab",             # truncated bytes field
    b"\x08" + b"\xff" * 10,    # varint overflow
    b"\x0b",                   # unsupported wire type 3
])
def test_proto_rejects_what_the_reference_rejects(raw):
    with pytest.raises(JProtoError) as jerr:
        JRecord.unmarshal(raw)
    with pytest.raises(ProtoError) as err:
        Record.unmarshal(raw)
    assert str(err.value) == str(jerr.value)


def test_crc_mismatch_and_torn_tail_on_read(tmp_path):
    _play(WAL, Entry, HardState, tmp_path, _saves(5, n=10, cuts=()))
    path = tmp_path / sorted(os.listdir(tmp_path))[0]
    raw = bytearray(path.read_bytes())
    path.write_bytes(bytes(raw[:-3]))
    with pytest.raises(TornTailError):
        WAL.open_at_index(str(tmp_path), 0).read_all()
    raw[len(raw) // 2] ^= 0x40
    path.write_bytes(bytes(raw))
    with pytest.raises((CRCMismatchError, ProtoError)):
        WAL.open_at_index(str(tmp_path), 0).read_all()


def test_torn_tail_repair_matches_reference(tmp_path):
    for name, wal_cls in (("ref", JWAL), ("port", WAL)):
        d = tmp_path / name
        _play(wal_cls, *((JEntry, JHardState) if name == "ref"
                         else (Entry, HardState)), d,
              _saves(6, n=14, cuts=(7,)))
        last = d / sorted(os.listdir(d))[-1]
        last.write_bytes(last.read_bytes()[:-5])
        w = wal_cls.open_at_index(str(d), 0)
        w.read_all(repair=True)
        w.close()
    assert _files(tmp_path / "ref") == _files(tmp_path / "port")


def test_enospc_failpoint_rolls_back(tmp_path):
    w = WAL.create(str(tmp_path), b"m")
    w.save(HardState(term=1, vote=1, commit=0),
           [Entry(term=1, index=0, data=b"kept")])
    size = os.path.getsize(w._fpath)
    faults.configure("wal.append=enospc(once)")
    try:
        with pytest.raises(EtcdNoSpace):
            w.save(HardState(term=1, vote=1, commit=1),
                   [Entry(term=1, index=1, data=b"refused")])
    finally:
        faults.clear()
    assert os.path.getsize(w._fpath) == size
    w.save(HardState(term=1, vote=1, commit=1),
           [Entry(term=1, index=1, data=b"after")])
    w.close()
    _, st, ents = WAL.open_at_index(str(tmp_path), 0).read_all()
    assert [e.data for e in ents] == [b"kept", b"after"] and st.commit == 1


def test_fsync_error_is_fail_stop(tmp_path):
    w = WAL.create(str(tmp_path), b"m")
    seen = []
    prev = faults.set_fail_stop(lambda reason, exc: seen.append(exc))
    faults.configure("wal.fsync=err(EIO,once)")
    try:
        with pytest.raises(faults.FailStopError):
            w.save(HardState(term=1, vote=1, commit=0),
                   [Entry(term=1, index=0, data=b"x")])
    finally:
        faults.clear()
        faults.set_fail_stop(prev)
    assert seen and seen[0].errno == errno.EIO


def test_failpoint_names_are_the_references():
    from etcd_tpu.utils.faults import FAULT_CATALOG as JCATALOG

    assert set(faults.FAULT_CATALOG) <= set(JCATALOG)
    with pytest.raises(faults.FaultSpecError):
        faults.configure("wal.nope=err(EIO)")
    faults.clear()
