"""The port's dist-tier wire formats against the JAX package's:
``wire/schema.py`` (the DGB2 / DCB1 / DRH1 declarations), ``distmsg``
(DGB2 peer frames), ``clientmsg`` (DCB1 client batches) and ``rolemsg``
(DRH1 role handoff).

Random frames, built from the same seeded numpy draws by each package's
own writers, marshal to the same bytes; each package parses the other's
bytes to the same frame.  Seeded mutations of valid frames in the manner
of ``scripts/wire_fuzz.py`` (truncation at every offset, header
count-field extremes, byte flips, aligned signed extremes) either parse
to equal results in both packages or raise the same typed error class in
both.  Tolerance: exact (bytes).
"""

import importlib
import struct

import numpy as np
import pytest

EXTREMES = (0, 1, 255, (1 << 16) - 1, (1 << 31) - 1, (1 << 32) - 1,
            1 << 63, (1 << 64) - 1)


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def canon(x):
    """A package-neutral form of a parse result."""
    if isinstance(x, np.ndarray):
        return ("nd", x.dtype.str, x.tolist())
    if isinstance(x, (list, tuple)):
        return [canon(v) for v in x]
    if isinstance(x, dict):
        return {k: canon(v) for k, v in sorted(x.items())}
    if isinstance(x, BaseException):
        return ("exc", type(x).__name__, str(x))
    if hasattr(x, "marshal"):
        return ("frame", type(x).__name__, bytes(x.marshal()))
    if hasattr(x, "__dict__"):
        return (type(x).__name__, canon(vars(x)))
    return x


def outcome(fn, data):
    """``("ok", canon(result))`` or ``("err", error class name)``;
    anything but the format's typed error fails the test."""
    try:
        return ("ok", canon(fn(data)))
    except Exception as e:  # compared across packages below
        assert type(e).__name__ in ("FrameError", "ProtoError"), \
            f"{fn.__module__}.{fn.__name__}: untyped {e!r}"
        return ("err", type(e).__name__)


# -- seeded random frames, built by each package's writers ----------------


def dgb2_frames(pkg: str, seed: int):
    dm = mod(pkg, "wire.distmsg")
    rng = np.random.default_rng(seed)
    g = int(rng.integers(8, 17))
    e = int(rng.integers(1, 9))
    i32 = lambda lo, hi, n: rng.integers(lo, hi, n).astype("<i4")  # noqa
    n_ents = rng.integers(0, e + 1, g).astype("<i4")
    prev = i32(0, 1000, g)
    payloads = [[rng.bytes(int(rng.integers(0, 40)))
                 for _ in range(int(n_ents[gi]))] for gi in range(g)]
    ab = dm.AppendBatch(
        sender=int(rng.integers(0, 5)), term=i32(1, 50, g),
        prev_idx=prev, prev_term=i32(0, 50, g), n_ents=n_ents,
        commit=i32(0, 1000, g), active=rng.random(g) < 0.8,
        need_snap=rng.random(g) < 0.1,
        ent_terms=rng.integers(0, 50, (g, e)).astype("<i4"),
        payloads=payloads, seq=int(rng.integers(0, 1 << 31)),
        epoch=int(rng.integers(0, 1 << 31)))
    eg, ei = dm.flat_entry_table(ab.prev_idx, ab.n_ents)
    flat = [p for row in payloads for p in row]
    packed = dm.AppendBatch(**{
        **ab.__dict__, "ent_group": eg, "ent_gindex": ei,
        "payloads": dm.PackedPayloads.from_counts(flat, n_ents)})
    traced = dm.AppendBatch(**{**ab.__dict__, "trace": [
        (int(rng.integers(0, g)), int(rng.integers(0, 99)),
         int(rng.integers(1, 1 << 40)), int(rng.integers(0, 3)))
        for _ in range(int(rng.integers(1, 4)))]})
    resp = dm.AppendResp(
        sender=int(rng.integers(0, 5)), term=i32(1, 50, g),
        ok=rng.random(g) < 0.7, acked=i32(0, 1000, g),
        hint=i32(0, 1000, g), active=rng.random(g) < 0.9,
        seq=int(rng.integers(0, 1 << 31)),
        epoch=int(rng.integers(0, 1 << 31)))
    vote = dm.VoteReq(sender=int(rng.integers(0, 5)), term=i32(1, 50, g),
                      last=i32(0, 1000, g), lterm=i32(0, 50, g),
                      active=rng.random(g) < 0.9)
    vresp = dm.VoteResp(sender=int(rng.integers(0, 5)),
                        term=i32(1, 50, g), granted=rng.random(g) < 0.5,
                        active=rng.random(g) < 0.9)
    return [ab, packed, traced, resp, vote, vresp]


def dcb1_frames(pkg: str, seed: int):
    cm = mod(pkg, "wire.clientmsg")
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 12))
    paths = [f"/ns{int(rng.integers(0, 99))}/k{i}" for i in range(n)]
    vals = [None if rng.random() < 0.2 else
            (rng.bytes(int(rng.integers(0, 20))) if rng.random() < 0.5
             else f"v{int(rng.integers(0, 1 << 20))}") for _ in range(n)]
    errs = {int(i): (int(rng.integers(100, 110)), f"err {i}")
            for i in rng.choice(n, int(rng.integers(0, n + 1)),
                                replace=False)}
    return [cm.pack_get_request(paths), cm.pack_get_response(vals, errs),
            cm.pack_propose_response(n, errs)]


def drh1_frames(pkg: str, seed: int):
    rm = mod(pkg, "wire.rolemsg")
    ev_mod = mod(pkg, "store.event")
    req_mod = mod(pkg, "wire.requests")
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 8))
    blobs = [req_mod.Request(method="PUT", path=f"/k{i}",
                             val=f"v{int(rng.integers(0, 999))}").marshal()
             for i in range(n)]
    flags = [int(rng.integers(0, 2)) for _ in range(n)]
    errs = {int(i): (int(rng.integers(100, 110)), f"missing {i}")
            for i in rng.choice(n, int(rng.integers(0, n + 1)),
                                replace=False)}
    vals = [None if i in errs else f"leaf{i}" for i in range(n)]
    idx = int(rng.integers(1, 1000))
    ev = ev_mod.Event(
        action="set", node=ev_mod.NodeExtern(
            key="/k", value=f"v{idx}", modified_index=idx,
            created_index=idx), etcd_index=idx + 1)
    rows = [(int(rng.integers(0, 16)), int(rng.integers(1, 99)),
             rng.bytes(int(rng.integers(0, 24)))) for _ in range(n)]
    return [rm.pack_fwd_request(blobs, flags, rm.REPLY_VALS),
            rm.pack_fwd_acks(n, errs), rm.pack_fwd_vals(vals, errs),
            rm.pack_fwd_response([ev, RuntimeError("boom")]),
            rm.pack_commit(int(rng.integers(0, 1 << 40)), rows)]


def parsers(pkg: str, fmt: str):
    """Every parse entry point of format ``fmt`` in package ``pkg``."""
    if fmt == "dgb2":
        return [mod(pkg, "wire.distmsg").unmarshal_any]
    if fmt == "dcb1":
        cm = mod(pkg, "wire.clientmsg")
        return [cm.unpack_get_request, cm.unpack_get_response,
                cm.unpack_propose_response]
    rm = mod(pkg, "wire.rolemsg")
    return [rm.unpack_fwd_request, rm.unpack_fwd_acks,
            rm.unpack_fwd_vals, rm.unpack_fwd_response, rm.unpack_commit]


WRITERS = {"dgb2": dgb2_frames, "dcb1": dcb1_frames, "drh1": drh1_frames}
SEEDS = list(range(20261017, 20261017 + 6))


def _bytes(f) -> bytes:
    return bytes(f.marshal()) if hasattr(f, "marshal") else bytes(f)


@pytest.mark.parametrize("fmt", sorted(WRITERS))
@pytest.mark.parametrize("seed", SEEDS)
def test_random_frames_byte_equal_and_cross_parse(fmt, seed):
    ref = [_bytes(f) for f in WRITERS[fmt]("etcd_tpu", seed)]
    port = [_bytes(f) for f in WRITERS[fmt]("etcd_tpu_torch", seed)]
    assert port == ref
    for raw in ref:
        got = [outcome(p, raw) for p in parsers("etcd_tpu_torch", fmt)]
        want = [outcome(p, raw) for p in parsers("etcd_tpu", fmt)]
        assert got == want
        assert any(o[0] == "ok" for o in got), "no parser took the frame"


def test_schema_declarations_equal():
    js, ts = mod("etcd_tpu", "wire.schema"), mod("etcd_tpu_torch",
                                                 "wire.schema")
    for name in ("DGB2", "DCB1", "DRH1"):
        a, b = getattr(js, name), getattr(ts, name)
        assert a.magic == b.magic and a.error == b.error
        assert a.header_offsets() == b.header_offsets()
        assert a.kind_values() == b.kind_values()
        assert a.structs == b.structs
        assert [f.bit for f in a.flags] == [f.bit for f in b.flags]
        assert a.count_fields == b.count_fields
        assert [(x.name, x.cap) for x in a.bounds] == \
            [(x.name, x.cap) for x in b.bounds]
    assert js.BOUNDS == ts.BOUNDS
    for bound, cap in sorted(ts.BOUNDS.items()):
        for v in (-1, 0, cap, cap + 1):
            outs = []
            for sch in (js, ts):
                try:
                    sch.check_bound(bound, v)
                    outs.append("ok")
                except sch.FrameError:
                    outs.append("err")
            assert outs[0] == outs[1] == ("ok" if 0 <= v <= cap
                                          else "err"), (bound, v)


def _mutations(fmt: str, raw: bytes, rng: np.random.Generator):
    sch = getattr(mod("etcd_tpu_torch", "wire.schema"), fmt.upper())
    for end in range(0, len(raw) + 1, max(1, len(raw) // 40)):
        yield raw[:end]
    offs = sch.header_offsets() if sch.header else {}
    fmt_for = {1: "<B", 2: "<H", 4: "<I", 8: "<Q"}
    for field in list(sch.count_fields) + ["kind", "flags"]:
        if field not in offs:
            continue
        off, width, _signed = offs[field]
        for v in EXTREMES:
            m = bytearray(raw)
            struct.pack_into(fmt_for[width], m, off,
                             v & ((1 << (8 * width)) - 1))
            yield bytes(m)
    for _ in range(60):
        m = bytearray(raw)
        for _ in range(int(rng.integers(1, 4))):
            if rng.random() < 0.45 and len(m) >= 4:
                off = int(rng.integers(0, len(m) - 3)) & ~3
                struct.pack_into("<I", m, off, int(
                    EXTREMES[int(rng.integers(0, len(EXTREMES)))]
                    & 0xFFFFFFFF))
            elif m:
                m[int(rng.integers(0, len(m)))] ^= 1 << int(
                    rng.integers(0, 8))
        yield bytes(m)


@pytest.mark.parametrize("fmt", sorted(WRITERS))
def test_mutated_frames_same_outcome(fmt):
    rng = np.random.default_rng(77)
    n = 0
    for seed in SEEDS[:2]:
        for raw in map(_bytes, WRITERS[fmt]("etcd_tpu", seed)):
            for m in _mutations(fmt, raw, rng):
                got = [outcome(p, m) for p in parsers("etcd_tpu_torch",
                                                      fmt)]
                want = [outcome(p, m) for p in parsers("etcd_tpu", fmt)]
                assert got == want, (fmt, m[:64])
                n += 1
    assert n > 300
