"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's kernels from ``etcd_tpu_torch/csrc`` with nvcc (one
nvcc per source) and the native WAL scanner from ``native/walscan.cc``
with g++, all at once, measures the rate of the 1-bit and int8
``mma.sync`` forms that the raw-CRC kernel chose between
(``etcd_tpu_torch.scripts.mma_rate``), and holds each kernel bit for bit
against its plain torch version, the raw-CRC kernel also at rows wider
than its 4096 bytes (L = 4097, 8192, 65536: folded from 4096-byte
slabs).  Then it drives seven paths at full size:

1. the main path, ``etcd_tpu_torch.parallel.data_plane_step``: 1,048,576
   WAL records of 256-380 bytes in 384-byte rows (BASELINE config 1,
   "1M x 256B entries", in bench.py's 1M x 384 batch) and 100,000 Raft
   groups x 5 members with 64 log slots (config 4, bench.py C4_GROUPS
   and ``MultiRaft(g, m=5, cap=64)``).  It checks the step against the
   same step with the plain CRC, and that corrupted records are flagged;
2. the raw-CRC variant race (``etcd_tpu_torch.scripts.
   crc_variants_bench``) on the same records, seed-injected, every
   variant gated by the full chain verify, and the kernels' tile and
   operand-type sweep (``etcd_tpu_torch.scripts.kernel_sweep``) on
   [2^20, 384] random rows;
3. WAL replay (``etcd_tpu_torch.wal.replay_device.read_all_device``) at
   BASELINE config 1: 1,048,576 entries of 256-byte payloads (~300 MB)
   in 4 segment files, headed by the port's ``WAL.create`` and filled
   by ``native.wal_gen``, replayed on the ``host``, ``device`` and
   ``stream`` lanes, which must return equal results and name the same
   record when one payload byte is flipped; then ~4,096 entries of 1 B
   to 64 KiB payloads on all three lanes (rows wider than 4 KiB
   through the kernel).  Prints each lane's entries/s and GB/s of WAL,
   the stream lane's scan/H2D/verify seconds, and the lane the router
   picks for a replay with no route named, whose result must equal the
   host lane's;
4. the snapshot hash (``etcd_tpu_torch.ops.crc_kernel.device_crc32c``)
   of 1 GiB of random bytes (BASELINE config 3) against
   ``native.crc32c_update``, and ``snap.ChunkVerifier(route="device")``
   over its 4 MiB chunks with one chunk corrupted;
5. the co-hosted serving path (``etcd_tpu_torch.scripts.cohosted_bench``,
   whose docstring has the shapes): the ``MultiRaft`` engine at 100,000
   groups x 5 members (BASELINE config 4), held equal field for field to
   the same calls on the CPU; ``MultiGroupServer`` at 10,000 x 5 serving
   PUTs from 8 client threads with its default ``snap_count``, so that a
   snapshot cuts the WAL under the load, then a profiled burst that must
   record the engine's kernels, reads, a CAS, a DELETE and a watch; a
   restart data dir (GroupEntry records over 10,000 groups, >= 8 MiB of
   WAL, a snapshot store of >= 4 MiB) restarted under
   ``--storage-backend`` host, tpu and auto, which must agree, tpu
   launching the raw-CRC kernel; and ``python -m etcd_tpu_torch.cli
   --cohosted-groups 10000`` as a subprocess, served over HTTP, killed
   and restarted with ``--storage-backend tpu``;
6. the distributed tier (``etcd_tpu_torch.scripts.dist_bench.run``, whose
   docstring has the client): three ``python -m
   etcd_tpu_torch.scripts.dist_node`` processes on the one card (three
   CUDA contexts, time-sliced: the numbers are the dist tier on one
   H100, not on three machines), member slots 0-2 of 10,000 groups with
   1024 log slots each (config 4's group count, BASELINE config 2's
   membership), 16,000 proposals over ``/mraft/propose_many`` from 8
   connections with windows of 512 and the reference's pipeline depth
   of 8; every acked write read back from all three hosts; slot 2
   SIGKILLed, 2,000 more proposals on the quorum of 2, slot 2 restarted
   with ``--storage-backend tpu``, which must replay its WAL through the
   raw-CRC kernel on the stream lane, catch up and read every key back.
   The kernel is then held against its plain version at the largest
   batch the restart launched;
7. the sharded data plane, BASELINE config 5 (``etcd_tpu_torch.parallel.
   make_sharded_step`` and ``etcd_tpu_torch.scripts.config5_bench``) on
   virtual shards of the one card, so the numbers are the g x s
   decomposition on one H100, not eight cards: the main path's records
   and groups through the sharded step on a (g, s) = (4, 2) mesh of 8
   virtual shards, bit-equal to ``data_plane_step`` in every output, a
   byte flipped in the left byte-block of a record in the third
   group-block flagging that record only, and ``make_replay_commit_step``
   equal to ``replay_commit_local``; ``config5_bench.main`` at 100,000
   groups on the same mesh (its JSON line), its sharded ``MultiRaft``
   held field for field against an unsharded one driven alike; the
   co-hosted server at 10,000 groups x 5 on 2 virtual shards serving
   400 PUTs, restarted with ``storage_backend="tpu"`` through the kernel
   and every key read back; and ``DistMember`` at 10,000 groups on 2
   virtual shards held against unsharded members call for call.

Each path is driven with the kernels' launch counts set to 0 just
before it and read just after.  Prints, on its last lines: one JSON
line with every kernel's launches, error and times, the card's name and
power limit, and then ``{"ok": true, "device": {...}}``.  Exits
non-zero, with no result, when CUDA is absent or any phase fails.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

# Left alone, torch.profiler keeps CUPTI between sessions, and then a
# session often records none of the kernels that another thread (the
# co-hosted server's loop) launches, though it records that thread's
# copies; torn down after each session, every session records them
# (etcd_tpu_torch/scripts/profiler_sessions.py measures both).
os.environ["TEARDOWN_CUPTI"] = "1"

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from etcd_tpu_torch import native  # noqa: E402
from etcd_tpu_torch.entry import group_args  # noqa: E402
from etcd_tpu_torch.obs import roofline  # noqa: E402
from etcd_tpu_torch.obs.metrics import registry  # noqa: E402
from etcd_tpu_torch.ops import crc_cuda, crc_kernel, planes_cuda  # noqa: E402
from etcd_tpu_torch.ops.crc_device import (  # noqa: E402
    chain_verify_device, raw_crc_batch, u32_tensor)
from etcd_tpu_torch.parallel import (  # noqa: E402
    data_plane_step, make_replay_commit_step, make_sharded_step,
    place_step_inputs, replay_commit_local, shard_grid, shard_leading)
from etcd_tpu_torch.raft.batched import replication_round  # noqa: E402
from etcd_tpu_torch.scripts import (  # noqa: E402
    cohosted_bench, config5_bench, crc_variants_bench, dist_bench,
    kernel_sweep, mma_rate)
from etcd_tpu_torch.scripts.walgen import injected, make_wal  # noqa: E402
from etcd_tpu_torch.snap import ChunkVerifier  # noqa: E402
from etcd_tpu_torch.wal import WAL  # noqa: E402
from etcd_tpu_torch.wal.backend_policy import (  # noqa: E402
    DEFAULT_CHUNK_BYTES, get_policy)
from etcd_tpu_torch.wal.errors import CRCMismatchError  # noqa: E402
from etcd_tpu_torch.wal.replay_device import (  # noqa: E402
    _rows_per_chunk, read_all_device)
from etcd_tpu_torch.wire import Entry, HardState, Record  # noqa: E402

N, WIDTH, LEN_LO, LEN_HI = 1 << 20, 384, 256, 380
G, M, CAP = 100_000, 5, 64
SEED_VAL = 0xDEADBEEF
DATA_SEED = 20261016
RACE_ITERS = 8
SWEEP_K = 12
# WAL replay, BASELINE config 1: 1M entries x 256 B payloads
REPLAY_N, PAYLOAD, SEGMENTS = 1 << 20, 256, 4
MIXED_N = 4096
LANES = ("host", "device", "stream")
META = b"chip_smoke"
# snapshot hash, BASELINE config 3: 1 GiB, streamed in 4 MiB chunks
SNAP_BYTES, SNAP_CHUNK = 1 << 30, 4 << 20
# the co-hosted server at config 4's width; its restart dir
SERVE_G, SERVE_PUTS, SERVE_THREADS = 10_000, 2000, 8
RESTART_K_PER, RESTART_SNAP_KEYS = 20, 24_000
BACKENDS = ("host", "tpu", "auto")
# the distributed tier: 3 hosts x 10,000 groups x 1024 log slots,
# bench.py's dist_cluster client (8 connections x windows of 512)
DIST_G, DIST_CAP, DIST_TOTAL, DIST_EXTRA = 10_000, 1024, 16_000, 2_000
DIST_CONNS, DIST_WINDOW, DIST_DEPTH, DIST_BATCH_ENTS = 8, 512, 8, 128
# the sharded data plane (config 5): 8 virtual shards of the card as a
# (4, 2) mesh for the step and the engine; 2 for the server and the
# dist engine at 10,000 groups
MESH_SHARDS, C5_ITERS, C5_SERVE_SHARDS, C5_PUTS = 8, 10, 2, 400

# The kernels' designs, for the kernels line.
RAW_DESIGN = ("1-bit mma.sync m16n8k256 and.popc; rows as A, packed C "
              "resident in smem as B; cp.async.bulk ring per warp")
PLANES_DESIGN = {
    False: "wgmma m64n32k32 s8 / m64n32k16 bf16: planes in registers as A, "
           "C_k^T in smem as B (resident, or 64-byte K-chunks a 512-row "
           "pass)",
    True: "mma.sync m16n8k32 s8 / m16n8k16 bf16: C_k^T in smem via "
          "ldmatrix as A, planes in registers as B"}


def check(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def build_all() -> list:
    """Build every kernel source and the native WAL scanner at once,
    one compiler each; a failed build raises."""
    sources = (crc_cuda.SOURCE, planes_cuda.SOURCE, mma_rate.SOURCE)
    with ThreadPoolExecutor(len(sources) + 1) as ex:
        futures = [ex.submit(crc_cuda.build, src) for src in sources]
        walscan = ex.submit(native.build)
        libs = [f.result() for f in futures]
        walscan.result()
    native.require()  # raises with the reason the scanner did not load
    return libs


def reset_launches() -> None:
    for fn in (crc_cuda.raw_crc_cuda, planes_cuda.planes_crc_cuda):
        fn.launches = 0
        fn.launches_by = dict.fromkeys(fn.launches_by, 0)


def read_launches() -> dict:
    return {fn.__name__: (fn.launches, dict(fn.launches_by))
            for fn in (crc_cuda.raw_crc_cuda, planes_cuda.planes_crc_cuda)}


# -- timing ------------------------------------------------------------------


def time_ms(fn, reps: int, warm: int = 2) -> float:
    """Median over ``reps`` runs of one call's device time, by CUDA
    events, after ``warm`` calls."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# -- phases ------------------------------------------------------------------


def records(rng, n: int, length: int) -> np.ndarray:
    """``n`` right-aligned random records in ``length``-byte rows: an
    empty one, full-width ones and random lengths."""
    lens = rng.integers(0, length + 1, size=n)
    lens[0] = length
    lens[1:2] = 0
    lens[2:3] = length
    buf = rng.integers(0, 256, size=(n, length), dtype=np.uint8)
    buf[np.arange(length)[None, :] < (length - lens)[:, None]] = 0
    return buf


def kernel_parity(rng) -> int:
    """The raw-CRC kernel at every rows-per-tile against its plain
    version, bit for bit, over widths (multiples of 16 take the bulk-copy
    path up to about 1 KB, the others and 4096 the direct path), row
    counts that are and are not a multiple of the tile, all-zero rows,
    empty and full-width records, and a misaligned base."""
    cases = 0
    for length in (1, 8, 33, 64, 100, 256, 383, 384, 1040, 4096):
        for n in (1, 17, 255, 4097):
            x = torch.from_numpy(records(rng, n, length)).cuda()
            for rows in (x, torch.zeros_like(x)):
                want = crc_cuda.raw_crc_plain(rows)
                for per_tile in crc_cuda.ROWS_PER_TILE:
                    got = crc_cuda.raw_crc_cuda(rows, per_tile)
                    torch.cuda.synchronize()
                    check(torch.equal(got, want),
                          f"kernel != plain at L={length} N={n} "
                          f"rows={per_tile}")
                    cases += 1
    # a base one byte off a 16-byte boundary takes the byte-load path
    flat = torch.from_numpy(
        rng.integers(0, 256, size=255 * 384 + 1, dtype=np.uint8)).cuda()
    x = flat[1:].view(255, 384)
    for per_tile in crc_cuda.ROWS_PER_TILE:
        check(torch.equal(crc_cuda.raw_crc_cuda(x, per_tile),
                          crc_cuda.raw_crc_plain(x)),
              f"kernel != plain on a misaligned buffer, rows={per_tile}")
        cases += 1
    return cases


def planes_parity(rng) -> int:
    """The planes kernel against its plain version, bit for bit, in
    both orientations and operand types, at perturb 0, 3 and 255, over
    widths, row counts, all-zero rows, tiles and a misaligned base."""
    kinds = [(t, op) for t in (False, True) for op in planes_cuda.OPERANDS]
    cases = 0

    def held(rows, what, tile=1024, perturbs=(0, 3, 255)):
        nonlocal cases
        for p in perturbs:
            want = planes_cuda.planes_crc_plain(rows, perturb=p)
            for t, op in kinds:
                got = planes_cuda.planes_crc_cuda(rows, tile, t, p, op)
                torch.cuda.synchronize()
                check(torch.equal(got, want),
                      f"planes kernel != plain: {what} tile={tile} "
                      f"transposed={t} {op} perturb={p}")
                cases += 1

    for length in (4, 8, 33, 36, 64, 100, 132, 383, 384, 4096):
        for n in (1, 255, 4097):
            x = torch.from_numpy(records(rng, n, length)).cuda()
            held(x, f"L={length} N={n}")
            held(torch.zeros_like(x), f"zero rows L={length} N={n}")
    x = torch.from_numpy(records(rng, 4097, 384)).cuda()
    for tile in (64, 512, 1024, 2048):
        held(x, "L=384 N=4097", tile=tile, perturbs=(3,))
    flat = torch.from_numpy(
        rng.integers(0, 256, size=255 * 384 + 1, dtype=np.uint8)).cuda()
    held(flat[1:].view(255, 384), "misaligned base", perturbs=(0, 3))
    return cases


def wide_parity(rng) -> int:
    """``raw_crc_batch`` on rows wider than the kernel's 4096 bytes
    (slabs through the kernel, shifted and XOR-folded) against the plain
    version at full width, bit for bit; all-zero rows too."""
    cases = 0
    for length in (4097, 8192, 65536):
        x = torch.from_numpy(records(rng, 5, length)).cuda()
        for rows in (x, torch.zeros_like(x)):
            before = crc_cuda.raw_crc_cuda.launches
            got = raw_crc_batch(rows)
            check(crc_cuda.raw_crc_cuda.launches > before,
                  f"L={length} did not reach the kernel")
            check(torch.equal(got, crc_cuda.raw_crc_plain(rows)),
                  f"wide rows != plain at L={length}")
            cases += 1
    return cases


# -- recovery: WAL replay and the snapshot hash -----------------------------


def append_entries(path: str, payloads, first_index: int,
                   chain: int) -> tuple[int, int]:
    """Append entry records of ``payloads`` to the segment at ``path``,
    their rolling CRC chain continued from ``chain`` with the native
    CRC (the WAL encoder's format: int64 length, then the Record).
    Returns the chain's tail and how many entries are wider than the
    kernel's row."""
    out = bytearray()
    wide = 0
    for i, data in enumerate(payloads):
        ent = Entry(term=1, index=first_index + i, data=data).marshal()
        wide += len(ent) > crc_cuda.MAX_LENGTH
        chain = native.crc32c_update(chain, ent)
        rec = Record(type=2, crc=chain, data=ent).marshal()
        out += struct.pack("<q", len(rec)) + rec
    with open(path, "ab") as f:
        f.write(out)
    return chain, wide


def write_replay_wal(d: str, n: int, payload: int, segments: int) -> None:
    """A WAL of ``n`` entries of ``payload`` random bytes in
    ``segments`` files: each segment's head (crc and metadata records)
    by the port's WAL, its entries by ``native.wal_gen`` with the chain
    seeded from the head's last CRC, and a HardState at the end."""
    w = WAL.create(d, META)
    per, index = n // segments, 0
    for s in range(segments):
        w.close()
        gen = native.wal_gen(per, payload, start_index=index,
                             seed=w.encoder.crc.sum32())
        with open(w._fpath, "ab") as f:
            f.write(memoryview(gen))
        tail = int(native.wal_scan(gen)[1][-1])
        index += per
        w = WAL.open_at_end(d, META, tail, index - 1)
        if s < segments - 1:
            w.cut()
    w.save_state(HardState(term=1, vote=1, commit=index - 1))
    w.close()


def wal_bytes(d: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))


def same_replay(a, b) -> bool:
    (ma, sa, ba), (mb, sb, bb) = a, b
    return (ma == mb and sa == sb and ba.last_crc == bb.last_crc
            and all(np.array_equal(getattr(ba, k), getattr(bb, k))
                    for k in ("index", "term", "type", "data_off",
                              "data_len", "blob")))


def stream_stage_seconds() -> dict:
    return {s: registry.histogram("etcd_replay_stream_chunk_seconds",
                                  stage=s).sum
            for s in ("scan", "h2d", "verify")}


def replay_lanes(d: str, card: str, what: str) -> dict:
    """Replay ``d`` on every lane: equal results, and the raw-CRC
    kernel launched on the device lanes.  Returns per-lane (seconds,
    kernel launches, stream stage seconds) and prints the rates."""
    size = wal_bytes(d)
    out, ref = {}, None
    for lane in LANES:
        torch.cuda.synchronize()
        reset_launches()
        stages0 = stream_stage_seconds()
        t0 = time.perf_counter()
        got = read_all_device(d, 0, route=lane)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = crc_cuda.raw_crc_cuda.launches
        stages = {k: v - stages0[k] for k, v in stream_stage_seconds().items()}
        ref = ref or got
        check(same_replay(ref, got), f"{what}: lane {lane} != host lane")
        if lane != "host":
            check(launches > 0, f"{what}: lane {lane} did not launch the "
                  f"raw-CRC kernel")
        n = len(got[2])
        out[lane] = {"seconds": secs, "launches": launches,
                     "entries": n, "bytes": size}
        extra = ""
        if lane == "stream":
            out[lane]["stages"] = stages
            extra = (f"; stages scan {stages['scan']} s, h2d "
                     f"{stages['h2d']} s, verify {stages['verify']} s")
        print(f"replay {what} {lane}: {n} entries, {size} B in {secs} s = "
              f"{n / secs} entries/s, {size / secs / 1e9} GB/s of WAL, "
              f"{launches} kernel launches{extra} [{card}]", flush=True)
    return out


def routed_replay(d: str, card: str) -> None:
    """``read_all_device`` with no route: the process router probes on
    the card and picks a lane, whose result must equal the host lane's."""
    t0 = time.perf_counter()
    got = read_all_device(d, 0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(same_replay(got, read_all_device(d, 0, route="host")),
          "route=None != host lane")
    policy = get_policy()
    decision = policy.decisions["replay"]
    print(f"replay route=None: router picked {decision['route']} "
          f"({decision['why']}) in {secs} s, its probe included; probe "
          f"{json.dumps(policy.probe())} [{card}]", flush=True)


def replay_split(d: str, card: str) -> None:
    """The host-side parts every lane shares or runs: reading the
    segments, the fused native scan + CRC (the host lane's work) and the
    frame-only scan (the device lane's)."""
    names = sorted(f for f in os.listdir(d) if f.endswith(".wal"))
    t0 = time.perf_counter()
    blob = np.concatenate([np.fromfile(os.path.join(d, f), np.uint8)
                           for f in names])
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.scan_verify(blob)
    fused_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.wal_scan(blob)
    frame_s = time.perf_counter() - t0
    print(f"replay split: read segments {read_s} s, fused scan+CRC "
          f"{fused_s} s, frame-only scan {frame_s} s [{card}]", flush=True)


def idle_share(what: str, card: str, fn, reps: int = 3) -> None:
    p = cohosted_bench.profile_calls(fn, reps, torch.device("cuda"))
    wall_ms, busy_ms, top = p["wall_ms"], p["busy_ms"], p["top"]
    check(busy_ms > 0, f"the profiler saw no device time in {what}")
    print(f"profiled {what}: {wall_ms} ms wall, {busy_ms} ms device busy, "
          f"idle share {1 - busy_ms / wall_ms} [{card}]", flush=True)
    for ms, name in top[:3]:
        print(f"  {ms:.4f} ms/call  {name[:90]}")


def flip_named_alike(d: str) -> int:
    """Flip one payload byte in a middle entry record: every lane must
    raise CRCMismatchError naming that record.  Returns its index."""
    names = sorted(f for f in os.listdir(d) if f.endswith(".wal"))
    blob = np.concatenate([np.fromfile(os.path.join(d, f), np.uint8)
                           for f in names])
    types, _, doff, dlen, *_ = native.wal_scan(blob)
    mid = types.size // 2
    bad = mid + int(np.argmax(types[mid:] == 2))  # an entry record
    off = int(doff[bad]) + int(dlen[bad]) - 7
    for name in names:
        size = os.path.getsize(os.path.join(d, name))
        if off < size:
            break
        off -= size
    path = os.path.join(d, name)

    def flip():
        with open(path, "r+b") as f:
            f.seek(off)
            byte = f.read(1)[0]
            f.seek(off)
            f.write(bytes([byte ^ 0x10]))

    flip()
    try:
        for lane in LANES:
            try:
                read_all_device(d, 0, route=lane)
            except CRCMismatchError as e:
                check(f"at record {bad} " in str(e),
                      f"lane {lane} named another record: {e}")
            else:
                check(False, f"lane {lane} missed the flipped byte")
    finally:
        flip()
    return bad


def mixed_wal(d: str, rng) -> int:
    """~MIXED_N entries of 1 B to 64 KiB payloads (log-uniform) in one
    segment.  Returns how many are wider than the kernel's row."""
    sizes = np.exp(rng.uniform(0, np.log(1 << 16), MIXED_N)).astype(int)
    sizes[:3] = (1, 1 << 16, 50_000)
    w = WAL.create(d, META)
    chain = w.encoder.crc.sum32()
    w.close()
    payloads = [rng.bytes(int(s)) for s in sizes]
    tail, wide = append_entries(w._fpath, payloads, 0, chain)
    w = WAL.open_at_end(d, META, tail, MIXED_N - 1)
    w.save_state(HardState(term=1, vote=1, commit=MIXED_N - 1))
    w.close()
    return wide


def kernel_at(rows: torch.Tensor, reps: int = 10) -> dict:
    """The raw-CRC kernel alone on ``rows``: ms, the plain version's
    ms, max |kernel - plain| and the bound."""
    want = crc_cuda.raw_crc_plain(rows)
    err = int((crc_cuda.raw_crc_cuda(rows) - want).abs().max())
    n, length = rows.shape
    b = roofline.crc_bound(n, length)
    ms = time_ms(lambda: crc_cuda.raw_crc_cuda(rows), reps=reps)
    return {"ms": ms, "plain_ms": time_ms(
                lambda: crc_cuda.raw_crc_plain(rows), reps=3),
            "max_abs_err": err, "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "pct_of_bound": 100 * b["bound_ms"] / ms,
            "shape": [n, length]}


def snapshot_hash(rng, card: str) -> dict:
    """device_crc32c of SNAP_BYTES random bytes against the native CRC,
    and ChunkVerifier(route="device") over its SNAP_CHUNK chunks with
    one corrupted.  Returns times, launches and the kernel at
    [ROW_BATCH, CHUNK]."""
    data = rng.integers(0, 256, SNAP_BYTES, dtype=np.uint8)
    t0 = time.perf_counter()
    want = native.crc32c_update(0, data)
    host_s = time.perf_counter() - t0
    crc_kernel.device_crc32c(data[:1 << 20])  # warm
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    got = crc_kernel.device_crc32c(data)
    dev_s = time.perf_counter() - t0
    hash_launches = crc_cuda.raw_crc_cuda.launches
    check(got == want, f"device_crc32c {got:#x} != native {want:#x}")
    check(hash_launches > 0, "device_crc32c did not launch the kernel")
    idle_share("snapshot hash", card,
               lambda: crc_kernel.device_crc32c(data), reps=2)
    print(f"snapshot hash: {SNAP_BYTES} B, device {dev_s} s = "
          f"{SNAP_BYTES / dev_s / 1e9} GB/s, native host {host_s} s = "
          f"{SNAP_BYTES / host_s / 1e9} GB/s, {hash_launches} kernel "
          f"launches, crc {got:#010x} [{card}]", flush=True)

    chunks = [data[o:o + SNAP_CHUNK].tobytes()
              for o in range(0, SNAP_BYTES, SNAP_CHUNK)]
    crcs, prev = [], 0
    for c in chunks:
        prev = native.crc32c_update(prev, c)
        crcs.append(prev)
    check(crcs[-1] == want, "chunk chain tail != whole-blob CRC")
    prevs = [0] + crcs[:-1]
    bad = len(chunks) // 3
    chunks[bad] = chunks[bad][:99] + bytes([chunks[bad][99] ^ 1]) \
        + chunks[bad][100:]
    verifier = ChunkVerifier(route="device")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    verdicts = verifier.verify(chunks, prevs, crcs)
    ver_s = time.perf_counter() - t0
    ver_launches = crc_cuda.raw_crc_cuda.launches
    check(verdicts == [k != bad for k in range(len(chunks))],
          f"ChunkVerifier flagged {[k for k, v in enumerate(verdicts) if not v]}"
          f", not [{bad}]")
    check(ver_launches > 0, "ChunkVerifier did not launch the kernel")
    print(f"ChunkVerifier(device): {len(chunks)} chunks of {SNAP_CHUNK} B in "
          f"{ver_s} s = {SNAP_BYTES / ver_s / 1e9} GB/s, flagged chunk "
          f"[{bad}] only, {ver_launches} kernel launches [{card}]",
          flush=True)
    rows = torch.from_numpy(data[:crc_kernel.ROW_BATCH * crc_kernel.CHUNK]
                            .reshape(crc_kernel.ROW_BATCH, crc_kernel.CHUNK)
                            ).cuda()
    return {"hash_s": dev_s, "host_s": host_s, "verify_s": ver_s,
            "launches": hash_launches + ver_launches,
            "kernel": kernel_at(rows)}


def recovery(rng, card: str) -> tuple[dict, dict]:
    """Phases (b)-(d): replay at config 1 and mixed widths, the
    snapshot hash at config 3.  Returns the kernels-line entries'
    numbers for the replay and snapshot paths."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_wal_")
    try:
        d = os.path.join(tmp, "wal")
        t0 = time.perf_counter()
        write_replay_wal(d, REPLAY_N, PAYLOAD, SEGMENTS)
        print(f"replay WAL: {REPLAY_N} entries x {PAYLOAD} B payloads, "
              f"{wal_bytes(d)} B in {len(os.listdir(d))} segments, written "
              f"in {time.perf_counter() - t0} s [{card}]", flush=True)
        replay_lanes(d, card, "warm-up")
        lanes = replay_lanes(d, card, "1M x 256B")
        routed_replay(d, card)
        replay_split(d, card)
        for lane in ("device", "stream"):
            idle_share(f"replay {lane} lane", card, lambda: read_all_device(
                d, 0, route=lane), reps=2)
        bad = flip_named_alike(d)
        print(f"corruption: all lanes name record {bad}", flush=True)

        dm = os.path.join(tmp, "mixed")
        wide = mixed_wal(dm, rng)
        mixed = replay_lanes(dm, card, f"mixed 1B-64KiB ({wide} rows "
                             f"> 4096 B)")
        check(wide > 0, "no mixed-width entry wider than 4096 B")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the kernel at the lanes' batch shapes: the device lane's
    # [131072, 384] and a 4 MiB stream chunk's
    per_chunk, _ = native.wal_count_range(
        native.wal_gen(REPLAY_N // 64, PAYLOAD), 0, DEFAULT_CHUNK_BYTES)
    shapes = {"device": _rows_per_chunk(384, REPLAY_N, 1 << 17, 1 << 28),
              "stream": _rows_per_chunk(384, per_chunk, 1 << 17, 1 << 28)}
    timed = {}
    for lane, n in shapes.items():
        rows = torch.from_numpy(records(rng, n, 384)).cuda()
        timed[lane] = kernel_at(rows, reps=20)
        print(f"raw_crc at the {lane} lane's batch {timed[lane]['shape']}: "
              f"{timed[lane]['ms']} ms, bound {timed[lane]['bound_ms']} ms "
              f"({timed[lane]['pct_of_bound']}%), plain "
              f"{timed[lane]['plain_ms']} ms [{card}]", flush=True)
    replay = {"lanes": lanes, "mixed": mixed, "kernel": timed,
              "launches": sum(lanes[x]["launches"] for x in LANES)
              + sum(mixed[x]["launches"] for x in LANES)}

    snap = snapshot_hash(rng, card)
    k = snap["kernel"]
    print(f"raw_crc at the snapshot batch {k['shape']}: {k['ms']} ms, bound "
          f"{k['bound_ms']} ms ({k['pct_of_bound']}%), plain {k['plain_ms']} "
          f"ms [{card}]", flush=True)
    return replay, snap


def cohosted(rng, card: str) -> dict:
    """Phases 9-12: the co-hosted engine, the server in process, its
    restart through the kernel, and the CLI.  Returns the raw-CRC
    numbers of the restart path for the kernels line."""
    # 9. the engine at config 4, and the same calls on the CPU
    eng = cohosted_bench.engine(g=G, m=M, cap=CAP)
    pr = eng["profile"]
    check(pr["busy_ms"] > 0, "the profiler saw no device time in a round")
    print(f"engine {G} x {M} cap {CAP}: per-dispatch p50 {eng['p50_ms']} ms "
          f"max {eng['max_ms']} ms; propose_rounds x22 {eng['round_ms']} "
          f"ms/round = {eng['group_commits_per_s']} group-commits/s; "
          f"profiled dispatch {pr['wall_ms']} ms wall, {pr['busy_ms']} ms "
          f"busy, idle share {pr['idle_share']}, "
          f"{pr['launches_per_call']} kernel launches and "
          f"{pr['copies_per_call']} copies per round [{card}]", flush=True)
    for ms, name in pr["top"][:3]:
        print(f"  {ms:.4f} ms/round  {name[:90]}")
    t0 = time.perf_counter()
    ref = cohosted_bench.engine(g=G, m=M, cap=CAP, device="cpu")
    bad = cohosted_bench.same_states(eng, ref)
    check(not bad, f"engine on the card != on the CPU in {bad[:8]}")
    print(f"engine: every field of every member slot equals the CPU run's "
          f"({time.perf_counter() - t0} s on the CPU)", flush=True)
    del eng, ref

    # 10. the server in process at config 4's width, its default
    # snap_count: a snapshot cuts the WAL during the load
    sv = cohosted_bench.serving(g=SERVE_G, m=M, cap=1024, puts=SERVE_PUTS,
                                threads=SERVE_THREADS)
    check(sv["snapshots"] >= 1, "no snapshot during the serving load")
    pr = sv["profile"]
    print(f"serving {SERVE_G} x {M} cap 1024 ({sv['state_bytes']} B of "
          f"engine state): start {sv['start_s']} s; {SERVE_PUTS} PUTs from "
          f"{SERVE_THREADS} threads in {sv['load_s']} s = "
          f"{sv['acked_writes_per_s']} acked writes/s, p50 {sv['p50_ms']} "
          f"ms, p99 {sv['p99_ms']} ms, max {sv['max_ms']} ms, "
          f"{sv['rounds']} persisted rounds, {sv['snapshots']} snapshot(s) "
          f"under the load ({sv['snapshot_s']} s, snap_count "
          f"{sv['snap_count']}); every key read back after the cut, CAS, "
          f"DELETE and a watch held [{card}]", flush=True)
    print(f"serving time: consensus-round stage {sv['round_stage_s']} s, "
          f"persist {sv['persist_s']} s, apply {sv['apply_s']} s, the rest "
          f"of the loop {sv['other_s']} s; the WAL's host CRC "
          f"({'google_crc32c' if sv['crc_fast_path'] else 'pure Python'}) "
          f"over the load's {sv['crc_bytes']} B of records re-run alone: "
          f"{sv['wal_crc_s']} s; {sv['syncs_per_round']} host syncs per "
          f"round; profiled burst: {pr['rounds']} rounds, "
          f"{pr['launches_per_round']} kernel launches per round, idle "
          f"share {pr['idle_share']} [{card}]", flush=True)

    # 11. restart through the kernel, under each backend
    tmp = tempfile.mkdtemp(prefix="chip_smoke_restart_")
    try:
        src = os.path.join(tmp, "data")
        t0 = time.perf_counter()
        made = cohosted_bench.write_restart_dir(
            src, g=SERVE_G, k_per=RESTART_K_PER,
            snap_keys=RESTART_SNAP_KEYS)
        check(made["wal_bytes"] >= 8 << 20, "restart WAL under 8 MiB")
        check(made["snap_bytes"] >= 4 << 20, "restart snapshot under 4 MiB")
        print(f"restart dir: {made['records']} records, {made['wal_bytes']} "
              f"B of WAL, a {made['snap_bytes']} B snapshot, written in "
              f"{time.perf_counter() - t0} s", flush=True)
        outs = {}
        for b in BACKENDS:
            o = cohosted_bench.restart(src, b, g=SERVE_G, m=M,
                                       records=made["records"])
            outs[b] = o
            print(f"restart --storage-backend {b}: {o['seconds']} s = "
                  f"{o['records_per_s']} records/s, lane {o['lane']} "
                  f"({o['why']}), {o['launches']} raw_crc launches; "
                  f"auto_crc32c's race: device wins "
                  f"{o['device_hash_wins']} [{card}]", flush=True)
        check(outs["host"]["launches"] == 0, "the host backend launched "
              "the kernel")
        check(outs["tpu"]["launches"] > 0, "the tpu restart did not launch "
              "the raw-CRC kernel")
        for b in BACKENDS[1:]:
            check(outs[b]["raft_index"] == outs["host"]["raft_index"]
                  and np.array_equal(outs[b]["frontier"],
                                     outs["host"]["frontier"])
                  and outs[b]["store"] == outs["host"]["store"],
                  f"restart under {b} != under host")
        store = outs["tpu"]["server"].store
        for k in made["window_keys"] + made["snap_key_sample"]:
            check(store.get(k, False, False).node.value, f"{k} lost")
        loaded = cohosted_bench.snapshot_load(src)
        print(f"snapshot load through auto_crc32c: {loaded['bytes']} B in "
              f"{loaded['seconds']} s, {loaded['launches']} raw_crc "
              f"launches (device wins the race: "
              f"{loaded['device_hash_wins']}) [{card}]", flush=True)
        per_chunk, _ = native.wal_count_range(np.concatenate(
            [np.fromfile(os.path.join(src, "wal", f), np.uint8)
             for f in sorted(os.listdir(os.path.join(src, "wal")))]),
            0, DEFAULT_CHUNK_BYTES)
        window = len(made["window_keys"])
        records_n = made["records"]
        for o in outs.values():
            del o["server"]
        del store
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"restart: all backends give raft_index {outs['host']['raft_index']}"
          f", equal frontier and store; {window} window keys and the "
          f"snapshot's keys read back", flush=True)
    # the kernel at the stream lane's batch for these records (width
    # class 128) and at the snapshot hash's [rows, 4096]
    rows = torch.from_numpy(records(rng, _rows_per_chunk(
        128, per_chunk, 1 << 17, 1 << 28), 128)).cuda()
    k_stream = kernel_at(rows, reps=20)
    rows = torch.from_numpy(records(
        rng, -(-loaded["bytes"] // crc_kernel.CHUNK), crc_kernel.CHUNK)).cuda()
    k_snap = kernel_at(rows, reps=20)
    print(f"raw_crc at the restart's stream batch {k_stream['shape']}: "
          f"{k_stream['ms']} ms, bound {k_stream['bound_ms']} ms; at the "
          f"snapshot load's {k_snap['shape']}: {k_snap['ms']} ms, bound "
          f"{k_snap['bound_ms']} ms [{card}]", flush=True)

    # 12. the normal entry point, as a subprocess on the card
    c = cohosted_bench.cli(g=SERVE_G, m=M)
    print(f"cli --cohosted-groups {SERVE_G} --cohosted-members {M}: "
          f"listening after {c['listen_s']} s, {c['keys']} PUTs (median "
          f"{statistics.median(c['put_ms'])} ms) and GETs and /v2/machines "
          f"held; killed (exit {c['exit_codes'][0]}), restarted with "
          f"--storage-backend tpu, listening after {c['restart_listen_s']} s, "
          f"every key read back [{card}]", flush=True)
    return {"restarts": outs, "snapshot_load": loaded, "stream": k_stream,
            "snapshot": k_snap, "records": records_n}


def dist(rng, card: str) -> dict:
    """Phase 13: the distributed tier in three processes, and the
    raw-CRC kernel at the largest batch its restart launched.  Returns
    the run and the kernel's numbers for the kernels line."""
    torch.cuda.empty_cache()
    r = dist_bench.run(groups=DIST_G, cap=DIST_CAP, total=DIST_TOTAL,
                       conns=DIST_CONNS, window=DIST_WINDOW,
                       extra=DIST_EXTRA, depth=DIST_DEPTH,
                       max_batch_ents=DIST_BATCH_ENTS)
    rs = r["restart"]
    check(r["device"] == "cuda", f"the nodes ran on {r['device']}")
    check(rs["lane"] == "stream", f"the tpu restart took lane {rs['lane']}")
    check(rs["raw_crc_launches"] > 0, "the dist restart did not launch the "
          "raw-CRC kernel")
    for name in ("load", "load_one_down"):
        x = r[name]
        print(f"dist {name}: {x['acked']} of {x['proposals']} proposals "
              f"acked in {x['seconds']} s = {x['acked_writes_per_s']} "
              f"acked writes/s; client ack p50 {x['ack_p50_ms']} ms, p99 "
              f"{x['ack_p99_ms']} ms; refused {x['refused']} [{card}]",
              flush=True)
    for slot, h in enumerate(r["hosts_stats"]):
        print(f"dist host {slot}: applied {h['applied_per_s']} entries/s "
              f"during the load; ack RTT p50 {h['ack_rtt_p50_ms']} ms p99 "
              f"{h['ack_rtt_p99_ms']} ms ({h['ack_rtt_count']} samples); "
              f"{h['rounds']} rounds ({h['leader_rounds']} leader, "
              f"{h['frames_handled']} frames handled); "
              f"{h['reads_per_round']} host reads of device state per "
              f"round {h['reads_by_stage']}; leads {h['lanes_led']} lanes "
              f"({h['odd_lanes_led']} odd); {h['campaign_lanes']} campaign "
              f"lanes, {h['won_lanes']} won; snapshot installs "
              f"{h['snapshot_installs']} [{card}]", flush=True)
    h = r["restarted_host_stats"]
    print(f"dist restart of slot 2 (--storage-backend tpu): "
          f"{rs['seconds']} s over {rs['wal_bytes']} B of WAL, lane "
          f"{rs['lane']}, {rs['raw_crc_launches']} raw_crc launches "
          f"(largest batch {rs['raw_crc_largest']}), READY after "
          f"{rs['ready_s']} s, caught up in {rs['catch_up_s']} s; "
          f"{r['read_back']} acked keys read back from all three hosts; "
          f"then {h['reads_per_round']} host reads per round over "
          f"{h['rounds']} rounds, snapshot installs "
          f"{h['snapshot_installs']} [{card}]", flush=True)
    n, length = rs["raw_crc_largest"]
    k = kernel_at(torch.from_numpy(records(rng, n, length)).cuda(), reps=20)
    check(k["max_abs_err"] == 0, f"raw_crc != plain at {k['shape']}")
    print(f"raw_crc at the dist restart's largest batch {k['shape']}: "
          f"{k['ms']} ms, bound {k['bound_ms']} ms, plain {k['plain_ms']} "
          f"ms [{card}]", flush=True)
    return {"run": r, "kernel": k}


def sharded(buf_h, lens_h, stored_h, rng, card: str) -> dict:
    """Phase 14: the sharded data plane on virtual shards of the card
    (module docstring, path 7).  Returns the kernels-line numbers."""
    dev = torch.device("cuda")
    buf = torch.from_numpy(buf_h).to(dev)
    lens = torch.from_numpy(lens_h).to(dev)
    stored = u32_tensor(stored_h, dev)
    state, *raft = group_args(G, M, CAP, dev)
    args = (buf, lens, stored, SEED_VAL, state, *raft)
    ref = data_plane_step(*args)
    mesh = config5_bench.virtual_mesh(MESH_SHARDS)
    ng, ns = mesh.shape["g"], mesh.shape["s"]
    check((ng, ns) == (4, 2), f"mesh {mesh.shape}, not (4, 2)")
    placed = place_step_inputs(mesh, args)
    step = make_sharded_step(mesh)
    torch.cuda.synchronize()

    # (a) the sharded step at config 5's width
    reset_launches()
    links, st, err, ncomm, commit_all = step(*placed)
    torch.cuda.synchronize()
    launches = crc_cuda.raw_crc_cuda.launches
    check(launches == ng * ns, f"the sharded step launched raw_crc "
          f"{launches} times, not {ng * ns}")
    check(torch.equal(torch.cat(links), ref[0]) and bool(ref[0].all()),
          "sharded links != the unsharded step's")
    check(all(torch.equal(torch.cat(a), b) for a, b in zip(st, ref[1])),
          "sharded state != the unsharded step's")
    check(torch.equal(torch.cat(err), ref[2])
          and torch.equal(torch.cat(ncomm), ref[3]),
          "sharded err/ncomm != the unsharded step's")
    check(torch.equal(commit_all, ref[1].commit), "commit_all != commit")
    per_g, half = N // ng, WIDTH // ns
    long_rows = np.nonzero(lens_h[2 * per_g:3 * per_g] > half)[0]
    check(long_rows.size > 0, "no record longer than one byte-block")
    r = int(long_rows[long_rows.size // 2])
    col = WIDTH - int(lens_h[2 * per_g + r])  # the record's first byte
    block = placed[0][2][0]
    block[r, col] ^= 0x80
    fails = torch.cat([~x for x in step(*placed)[0]]).nonzero().flatten()
    block[r, col] ^= 0x80
    check(fails.tolist() == [2 * per_g + r], f"byte flip in record "
          f"{2 * per_g + r} (column {col}): links {fails.tolist()} failed")
    s2 = ref[1]
    raft_in = (s2.match, s2.nmembers, s2.commit, s2.term, s2.log_term,
               s2.offset)
    want = replay_commit_local(buf, lens, stored, SEED_VAL, *raft_in)
    got = make_replay_commit_step(mesh)(
        shard_grid(mesh, buf), *(shard_leading(mesh, x) for x in (
            lens, stored)), SEED_VAL,
        *(shard_leading(mesh, x) for x in raft_in))
    check(torch.equal(torch.cat(got[0]), want[0])
          and torch.equal(got[1], want[1]),
          "make_replay_commit_step != replay_commit_local")
    sharded_ms = time_ms(lambda: step(*placed), reps=C5_ITERS)
    unsharded_ms = time_ms(lambda: data_plane_step(*args), reps=C5_ITERS)
    k = kernel_at(placed[0][0][0], reps=20)
    check(k["max_abs_err"] == 0, f"raw_crc != plain at {k['shape']}")
    print(f"sharded step {N} x {WIDTH} B, {G} x {M} on a {ng}x{ns} mesh of "
          f"{MESH_SHARDS} virtual shards on one card: {sharded_ms} ms "
          f"(unsharded {unsharded_ms} ms), {launches} raw_crc launches a "
          f"step; bit-equal to the unsharded step, commit_all == commit, "
          f"a flip in record {2 * per_g + r} flags it alone, replay-commit "
          f"step equal; raw_crc per block {k['shape']}: {k['ms']} ms, bound "
          f"{k['bound_ms']} ms, plain {k['plain_ms']} ms [{card}]",
          flush=True)
    del buf, lens, stored, state, raft, args, ref, placed, links, st, got
    torch.cuda.empty_cache()

    # (b) config5_bench at 100,000 groups on the same mesh, and the
    # serving form unsharded, driven alike
    c5 = config5_bench.main(groups=G, iters=C5_ITERS, n_devices=MESH_SHARDS)
    sv = c5.pop("serving")
    print(json.dumps(c5), flush=True)
    one = config5_bench.serving(c5["groups"], None, trains=max(
        2, C5_ITERS // 2), device=dev)
    bad = cohosted_bench.same_states(sv, one)
    check(not bad, f"sharded MultiRaft != unsharded in {bad[:8]}")
    check(sv["reads_per_round"] == one["reads_per_round"],
          f"host reads a round: sharded {sv['reads_per_round']}, "
          f"unsharded {one['reads_per_round']}")
    print(f"config5 serving {c5['groups']} x 5 cap 32: sharded over "
          f"{sv['blocks']} g-blocks {sv['round_ms']} ms/round, "
          f"{sv['profile']['launches_per_round']} kernel launches and "
          f"{sv['reads_per_round']} host reads a round; unsharded "
          f"{one['round_ms']} ms/round, "
          f"{one['profile']['launches_per_round']} launches and "
          f"{one['reads_per_round']} reads a round; every field equal "
          f"({MESH_SHARDS} virtual shards on one card) [{card}]", flush=True)

    # (c) the sharded co-hosted server, restarted through the kernel
    small = config5_bench.virtual_mesh(C5_SERVE_SHARDS)
    srv = config5_bench.served(SERVE_G, small, puts=C5_PUTS,
                               threads=SERVE_THREADS)
    check(srv["restart_launches"] > 0, "the sharded server's tpu restart "
          "did not launch the raw-CRC kernel")
    print(f"sharded server {SERVE_G} x {M} on {C5_SERVE_SHARDS} virtual "
          f"shards: {C5_PUTS} PUTs from {SERVE_THREADS} threads in "
          f"{srv['load_s']} s = {srv['acked_writes_per_s']} acked writes/s, "
          f"p50 {srv['p50_ms']} ms; restart (tpu) {srv['restart_s']} s, "
          f"{srv['restart_launches']} raw_crc launches, {srv['blocks']} "
          f"g-blocks, {srv['read_back']} keys read back [{card}]",
          flush=True)

    # (d) the sharded dist engine against unsharded members
    de = config5_bench.dist_engine(SERVE_G, small)
    check(de["reads"]["sharded"] == de["reads"]["unsharded"],
          f"dist host reads differ: {de['reads']}")
    print(f"sharded DistMember {SERVE_G} groups x {de['m']} slots on "
          f"{de['blocks']} virtual shards: {de['calls']} calls, every field, "
          f"payload and frame equal to unsharded members; host reads "
          f"{de['reads']} [{card}]", flush=True)
    return {"launches": launches, "kernel": k, "step_ms": sharded_ms,
            "unsharded_step_ms": unsharded_ms, "config5": c5,
            "serving_unsharded_round_ms": one["round_ms"],
            "serving_unsharded_launches_per_round":
                one["profile"]["launches_per_round"]}


def plain_step(buf, lens, stored, seed, state, *raft):
    """data_plane_step with the plain CRC in place of the kernel."""
    raw = crc_cuda.raw_crc_plain(buf)
    links_ok = chain_verify_device(seed, stored, raw, lens)
    state, err, ncomm = replication_round(state, *raft)
    return links_ok, state, err, ncomm


def same_outputs(a, b) -> bool:
    la, sa, ea, na = a
    lb, sb, eb, nb = b
    return (torch.equal(la, lb) and torch.equal(ea, eb)
            and torch.equal(na, nb)
            and all(torch.equal(x, y) for x, y in zip(sa, sb)))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 1. build, every source at once
    t0 = time.perf_counter()
    libs = build_all()
    print(f"kernel build: {time.perf_counter() - t0:.3f} s "
          f"({', '.join(so.name for so in libs)})")
    for so in libs:
        log = so.with_suffix(".log")
        if log.exists():
            print(f"{so.name}:\n{log.read_text().strip()}")

    # the 1-bit and int8 mma.sync rates raw_crc.cu's route rests on
    rate = mma_rate.main()
    b1, s8 = rate["b1_and_popc_m16n8k256"], rate["s8_m16n8k32"]
    print(f"mma rate: 1-bit m16n8k256 and.popc {b1['tops']} TOP/s "
          f"({b1['instr_per_ns']} instructions/ns), int8 m16n8k32 "
          f"{s8['tops']} TOP/s ({s8['instr_per_ns']} instructions/ns); "
          f"SASS {rate['sass_mma_opcodes']} [{card}]", flush=True)

    # 2. kernels vs plain versions on the card
    rng = np.random.default_rng(DATA_SEED)
    print(f"parity: raw_crc {kernel_parity(rng)} cases bit-exact",
          flush=True)
    print(f"parity: planes_crc {planes_parity(rng)} cases bit-exact",
          flush=True)
    print(f"parity: raw_crc_batch on rows of 4097-65536 B {wide_parity(rng)} "
          f"cases bit-exact", flush=True)

    # 3. the slice at real size
    t0 = time.perf_counter()
    buf_h, lens_h, stored_h = make_wal(N, WIDTH, LEN_LO, LEN_HI, SEED_VAL,
                                       DATA_SEED)
    print(f"host data: {N} records x {WIDTH} B in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    buf = torch.from_numpy(buf_h).to(dev)
    lens = torch.from_numpy(lens_h).to(dev)
    stored = u32_tensor(stored_h, dev)
    state, *raft = group_args(G, M, CAP, dev)
    args = (buf, lens, stored, SEED_VAL, state, *raft)
    torch.cuda.synchronize()

    reset_launches()
    out = data_plane_step(*args)
    torch.cuda.synchronize()
    launches = crc_cuda.raw_crc_cuda.launches
    check(launches >= 1, "the step did not launch the raw-CRC kernel")
    links_ok, state2, err, ncomm = out
    check(links_ok.shape == (N,) and bool(links_ok.all()),
          "a good WAL chain failed to verify")
    check(not bool(err.any()), "error lanes raised")
    check(bool((ncomm == 2).all()), "commit did not advance by 2")
    check(bool((state2.commit == 2).all()) and bool((state2.last == 2).all()),
          "commit/last not at 2")
    ref = plain_step(*args)
    torch.cuda.synchronize()
    check(same_outputs(out, ref), "step != step with the plain CRC")

    # corruption: a flipped stored CRC fails its link and the next; a
    # flipped data byte fails its own link only
    i, j = N // 3, 2 * N // 3
    bad = stored.clone()
    bad[i] ^= 1
    fails = (~data_plane_step(buf, lens, bad, SEED_VAL, state, *raft)[0]
             ).nonzero().flatten().tolist()
    check(fails == [i, i + 1], f"stored flip at {i}: links {fails} failed")
    buf[j, -1] ^= 0x80
    fails = (~data_plane_step(*args)[0]).nonzero().flatten().tolist()
    buf[j, -1] ^= 0x80
    check(fails == [j], f"data flip in row {j}: links {fails} failed")
    print(f"step: {N} links ok, {G} groups committed 2, matches the plain "
          f"step; corruption flags links [{i}, {i + 1}] and [{j}]",
          flush=True)

    # 4. times at the main path's shapes
    got = crc_cuda.raw_crc_cuda(buf)
    want = crc_cuda.raw_crc_plain(buf)
    max_abs_err = int((got - want).abs().max())
    check(max_abs_err == 0, "kernel != plain at full size")
    kernel_ms = time_ms(lambda: crc_cuda.raw_crc_cuda(buf), reps=20)
    plain_ms = time_ms(lambda: crc_cuda.raw_crc_plain(buf), reps=5)
    raw = crc_cuda.raw_crc_cuda(buf)
    chain_ms = time_ms(
        lambda: chain_verify_device(SEED_VAL, stored, raw, lens), reps=10)
    raft_ms = time_ms(lambda: replication_round(state, *raft), reps=10)
    step_ms = time_ms(lambda: data_plane_step(*args), reps=10)
    # the least time for the function: rows read once, uint32 states
    # written once, the packed [8L] word contribution matrix read once;
    # or its GF(2) contraction, 2 N 8L 32 int8 operations, at the
    # tensor-core rate.  The kernel's int64 output and nibble tables are
    # its own choices, not the function's, and are not counted.
    bound = roofline.crc_bound(N, WIDTH)
    bound_ms, nbytes, ops = bound["bound_ms"], bound["bytes"], bound["ops"]
    print(f"raw_crc kernel {kernel_ms} ms, plain {plain_ms} ms, bound "
          f"{bound_ms} ms ({nbytes} B, {ops} int8 ops) [{card}]")
    print(f"step {step_ms} ms = raw CRC kernel + chain verify {chain_ms} ms "
          f"+ replication round {raft_ms} ms [{card}]")
    p = cohosted_bench.profile_calls(lambda: data_plane_step(*args), 5, dev)
    wall_ms, busy_ms, top = p["wall_ms"], p["busy_ms"], p["top"]
    check(busy_ms > 0, "the profiler saw no device time in the step")
    print(f"profiled step: {wall_ms} ms wall, {busy_ms} ms device busy, "
          f"idle share {1 - busy_ms / wall_ms} [{card}]")
    for ms, name in top:
        print(f"  {ms:.4f} ms/step  {name[:90]}")
    print("library_ms: none -- no single PyTorch call computes a raw CRC")

    # 5. the sweep's rows per block and the planes kernel, timed alone
    # at the main path's shape: (ms, max_abs_err[, plain ms])
    rows_timed, planes_timed = {}, {}
    swept = [r for r in crc_cuda.ROWS_PER_TILE if r != crc_cuda.DEFAULT_ROWS]
    for per_tile in swept:
        err_ = int((crc_cuda.raw_crc_cuda(buf, per_tile) - want).abs().max())
        check(err_ == 0, f"raw_crc rows={per_tile} != plain at full size")
        rows_timed[per_tile] = (time_ms(
            lambda: crc_cuda.raw_crc_cuda(buf, per_tile), reps=20), err_)
        print(f"raw_crc rows={per_tile}: {rows_timed[per_tile][0]} ms "
              f"[{card}]", flush=True)
    for t in (False, True):
        want_t = planes_cuda.planes_crc_plain(buf, transposed=t)
        plain_t = time_ms(
            lambda: planes_cuda.planes_crc_plain(buf, transposed=t), reps=3)
        for op in planes_cuda.OPERANDS:
            got = planes_cuda.planes_crc_cuda(buf, 1024, t, 0, op)
            err_ = int((got - want_t).abs().max())
            check(err_ == 0, f"planes_crc transposed={t} {op} != plain at "
                  f"full size")
            ms = time_ms(
                lambda: planes_cuda.planes_crc_cuda(buf, 1024, t, 0, op),
                reps=20)
            planes_timed[(t, op)] = (ms, err_, plain_t)
            print(f"planes_crc transposed={t} {op}: {ms} ms, plain "
                  f"{plain_t} ms [{card}]", flush=True)

    # 6. the race: every variant on the step's records, seed-injected
    rows_inj = injected(buf_h, lens_h, stored_h, SEED_VAL)
    reset_launches()
    race = crc_variants_bench.main(rows_inj, stored_h, RACE_ITERS, dev)
    torch.cuda.synchronize()
    race_counts = read_launches()
    del rows_inj
    failed = {k: v["error"] for k, v in race.items() if "error" in v}
    check(not failed, f"race variants failed: {failed}")
    for name, (count, _) in race_counts.items():
        check(count >= RACE_ITERS, f"the race launched {name} {count} "
              f"times, fewer than its {RACE_ITERS} iterations")

    # 7. the sweep of tiles and operand types on [2^20, 384] random rows
    reset_launches()
    sweep = kernel_sweep.main(SWEEP_K, 20, dev)
    torch.cuda.synchronize()
    sweep_counts = read_launches()
    check(len(sweep) == len(kernel_sweep.sweep_rows(dev)),
          "the sweep lost a row")

    raw_by = {r: sweep_counts["raw_crc_cuda"][1][r] for r in swept}
    planes_by = {k: race_counts["planes_crc_cuda"][1][k]
                 + sweep_counts["planes_crc_cuda"][1][k] for k in planes_timed}
    for what, count in [*raw_by.items(), *planes_by.items()]:
        check(count > 0, f"no launch of {what} in the race or the sweep")
    del buf, lens, stored, state, raft, args, out, ref, want, raw
    torch.cuda.empty_cache()

    # 8. recovery: WAL replay (config 1, mixed widths), snapshot hash
    replay, snap = recovery(rng, card)
    # 9-12. the co-hosted serving path
    served = cohosted(rng, card)
    # 13. the distributed tier
    dist_run = dist(rng, card)
    # 14. the sharded data plane (config 5)
    mesh_run = sharded(buf_h, lens_h, stored_h, rng, card)
    kernels = [{
        "name": "raw_crc", "route": "cuda",
        "source": "etcd_tpu_torch/csrc/raw_crc.cu",
        "replaces": "etcd_tpu/ops/crc_pallas.py:40",
        "launches": launches, "max_abs_err": max_abs_err,
        "bit_exact": max_abs_err == 0,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound["bound_by"],
        "library_ms": None,
        "design": RAW_DESIGN, "rows": crc_cuda.DEFAULT_ROWS,
        "shape": [N, WIDTH], "step_ms": step_ms,
    }]
    for per_tile in swept:
        ms, err_ = rows_timed[per_tile]
        kernels.append({
            "name": f"raw_crc@{per_tile}", "route": "cuda",
            "source": "etcd_tpu_torch/csrc/raw_crc.cu",
            "replaces": "scripts/pallas_sweep.py:150",
            "launches": raw_by[per_tile], "max_abs_err": err_,
            "bit_exact": err_ == 0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound["bound_by"],
            "library_ms": None, "design": RAW_DESIGN, "rows": per_tile,
            "shape": [N, WIDTH]})
    replaces = {(False, "int8"): "etcd_tpu/ops/crc_variants.py:149",
                (True, "int8"): "etcd_tpu/ops/crc_variants.py:167",
                (False, "bf16"): "scripts/pallas_sweep.py:102",
                (True, "bf16"): "scripts/pallas_sweep.py:102"}
    for (t, op), (ms, err_, plain_t) in planes_timed.items():
        b = roofline.crc_bound(N, WIDTH, op)
        kernels.append({
            "name": f"planes_crc{'_t' if t else ''} {op}", "route": "cuda",
            "source": "etcd_tpu_torch/csrc/planes_crc.cu",
            "replaces": replaces[(t, op)], "launches": planes_by[(t, op)],
            "max_abs_err": err_, "bit_exact": err_ == 0, "ms": ms,
            "plain_ms": plain_t, "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "library_ms": None,
            "design": PLANES_DESIGN[t], "shape": [N, WIDTH], "tile": 1024})
    # raw_crc on the recovery paths: launches of the replay lanes
    # (config 1 and mixed widths) and of the snapshot hash and chunk
    # verifier, timed at each path's batch shape
    lanes = replay["lanes"]
    for name, k, count, extra in (
            ("raw_crc/replay", replay["kernel"]["device"],
             replay["launches"],
             {"stream_shape": replay["kernel"]["stream"]["shape"],
              "stream_ms": replay["kernel"]["stream"]["ms"],
              "stream_bound_ms": replay["kernel"]["stream"]["bound_ms"],
              "launches_by_lane": {
                  x: [lanes[x]["launches"], replay["mixed"][x]["launches"]]
                  for x in LANES},
              "entries_per_s": {x: lanes[x]["entries"] / lanes[x]["seconds"]
                                for x in LANES},
              "stream_stage_s": lanes["stream"]["stages"]}),
            ("raw_crc/snapshot", snap["kernel"], snap["launches"],
             {"hash_gbps": SNAP_BYTES / snap["hash_s"] / 1e9,
              "host_gbps": SNAP_BYTES / snap["host_s"] / 1e9,
              "verifier_gbps": SNAP_BYTES / snap["verify_s"] / 1e9})):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "etcd_tpu_torch/csrc/raw_crc.cu",
            "replaces": "etcd_tpu/ops/crc_pallas.py:40", "launches": count,
            "max_abs_err": k["max_abs_err"],
            "bit_exact": k["max_abs_err"] == 0, "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "pct_of_bound": k["pct_of_bound"],
            "library_ms": None, "design": RAW_DESIGN,
            "rows": crc_cuda.DEFAULT_ROWS, "shape": k["shape"], **extra})
    # raw_crc on the co-hosted server's restart: the tpu and auto
    # restarts (WAL replay and the snapshot hash) and the snapshot load
    # alone, timed at the restart's stream batch
    rs, k = served["restarts"], served["stream"]
    kernels.append({
        "name": "raw_crc/restart", "route": "cuda",
        "source": "etcd_tpu_torch/csrc/raw_crc.cu",
        "replaces": "etcd_tpu/ops/crc_pallas.py:40",
        "launches": rs["tpu"]["launches"] + rs["auto"]["launches"]
        + served["snapshot_load"]["launches"],
        "max_abs_err": k["max_abs_err"], "bit_exact": k["max_abs_err"] == 0,
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "pct_of_bound": k["pct_of_bound"],
        "library_ms": None, "design": RAW_DESIGN,
        "rows": crc_cuda.DEFAULT_ROWS, "shape": k["shape"],
        "launches_by_backend": {b: rs[b]["launches"] for b in BACKENDS},
        "lane_by_backend": {b: rs[b]["lane"] for b in BACKENDS},
        "records_per_s": {b: rs[b]["records_per_s"] for b in BACKENDS},
        "snapshot_load_launches": served["snapshot_load"]["launches"],
        "snapshot_shape": served["snapshot"]["shape"],
        "snapshot_ms": served["snapshot"]["ms"],
        "snapshot_plain_ms": served["snapshot"]["plain_ms"],
        "snapshot_bound_ms": served["snapshot"]["bound_ms"]})
    # raw_crc on the distributed tier's restart (slot 2's WAL replay on
    # the stream lane and the snapshot load), timed at its largest batch
    rs, k = dist_run["run"]["restart"], dist_run["kernel"]
    kernels.append({
        "name": "raw_crc/dist_restart", "route": "cuda",
        "source": "etcd_tpu_torch/csrc/raw_crc.cu",
        "replaces": "etcd_tpu/ops/crc_pallas.py:40",
        "launches": rs["raw_crc_launches"],
        "max_abs_err": k["max_abs_err"], "bit_exact": k["max_abs_err"] == 0,
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "pct_of_bound": k["pct_of_bound"],
        "library_ms": None, "design": RAW_DESIGN,
        "rows": crc_cuda.DEFAULT_ROWS, "shape": k["shape"],
        "lane": rs["lane"], "restart_s": rs["seconds"],
        "wal_bytes": rs["wal_bytes"]})
    # raw_crc on the sharded step: one launch per (g, s) block, timed
    # at a block's shape
    k = mesh_run["kernel"]
    kernels.append({
        "name": "raw_crc/sharded_step", "route": "cuda",
        "source": "etcd_tpu_torch/csrc/raw_crc.cu",
        "replaces": "etcd_tpu/ops/crc_pallas.py:40",
        "launches": mesh_run["launches"],
        "max_abs_err": k["max_abs_err"], "bit_exact": k["max_abs_err"] == 0,
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "pct_of_bound": k["pct_of_bound"],
        "library_ms": None, "design": RAW_DESIGN,
        "rows": crc_cuda.DEFAULT_ROWS, "shape": k["shape"],
        "mesh": f"4x2, {MESH_SHARDS} virtual shards on one card",
        "step_ms": mesh_run["step_ms"],
        "unsharded_step_ms": mesh_run["unsharded_step_ms"],
        "serving_sharded_round_ms":
            mesh_run["config5"]["serving_sharded_round_ms"],
        "serving_unsharded_round_ms": mesh_run["serving_unsharded_round_ms"],
        "serving_launches_per_round": {
            "sharded": mesh_run["config5"]["serving_launches_per_round"],
            "unsharded": mesh_run["serving_unsharded_launches_per_round"]}})
    print(f"wall: {time.perf_counter() - t_start} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
