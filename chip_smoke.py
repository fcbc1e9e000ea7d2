"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's kernels from ``etcd_tpu_torch/csrc`` with nvcc (one
nvcc per source, all at once), measures the rate of the 1-bit and int8
``mma.sync`` forms that the raw-CRC kernel chose between
(``etcd_tpu_torch.scripts.mma_rate``), and holds each kernel bit for bit
against its plain torch version.  Then it drives two paths at full size:

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
   [2^20, 384] random rows.

Each path is driven with the kernels' launch counts set to 0 just
before it and read just after.  Prints, on its last lines: one JSON
line with every kernel's launches, error and times, the card's name and
power limit, and then ``{"ok": true, "device": {...}}``.  Exits
non-zero, with no result, when CUDA is absent or any phase fails.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from etcd_tpu_torch.entry import group_args  # noqa: E402
from etcd_tpu_torch.obs import roofline  # noqa: E402
from etcd_tpu_torch.ops import crc_cuda, planes_cuda  # noqa: E402
from etcd_tpu_torch.ops.crc_device import (  # noqa: E402
    chain_verify_device, u32_tensor)
from etcd_tpu_torch.parallel import data_plane_step  # noqa: E402
from etcd_tpu_torch.raft.batched import replication_round  # noqa: E402
from etcd_tpu_torch.scripts import (  # noqa: E402
    crc_variants_bench, kernel_sweep, mma_rate)
from etcd_tpu_torch.scripts.walgen import injected, make_wal  # noqa: E402

N, WIDTH, LEN_LO, LEN_HI = 1 << 20, 384, 256, 380
G, M, CAP = 100_000, 5, 64
SEED_VAL = 0xDEADBEEF
DATA_SEED = 20261016
RACE_ITERS = 8
SWEEP_K = 12

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
    """Build every kernel source at once, one nvcc each."""
    sources = (crc_cuda.SOURCE, planes_cuda.SOURCE, mma_rate.SOURCE)
    with ThreadPoolExecutor(len(sources)) as ex:
        futures = [ex.submit(crc_cuda.build, src) for src in sources]
        return [f.result() for f in futures]


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


def profile_step(args, reps: int = 5):
    """Device busy time per step and the kernels that take it, from
    torch.profiler over ``reps`` steps: (wall ms, busy ms, [(ms, name)])
    per step.  The profiler's own host cost is in the wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            data_plane_step(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time
    busy_ms = sum(by_name.values()) / 1e3 / reps
    top = sorted(((us / 1e3 / reps, name) for name, us in by_name.items()),
                 reverse=True)[:6]
    return wall * 1e3 / reps, busy_ms, top


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
    wall_ms, busy_ms, top = profile_step(args)
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
    print(f"wall: {time.perf_counter() - t_start} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
