"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the raw-CRC kernel from ``etcd_tpu_torch/csrc`` with nvcc, holds
it bit for bit against its plain torch version, then drives the port's
main path, ``etcd_tpu_torch.parallel.data_plane_step``, at full size:
1,048,576 WAL records of 256-380 bytes in 384-byte rows (BASELINE config
1, "1M x 256B entries", in bench.py's 1M x 384 batch) and 100,000 Raft
groups x 5 members with 64 log slots (config 4, bench.py C4_GROUPS and
``MultiRaft(g, m=5, cap=64)``).  It checks the step against the same
step with the plain CRC, and that corrupted records are flagged.

Prints, on its last lines: one JSON line with the kernel's launches,
error and times, the card's name and power limit, and then
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result,
when CUDA is absent or any phase fails.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from etcd_tpu_torch.crc import crc32c, gf2  # noqa: E402
from etcd_tpu_torch.entry import group_args  # noqa: E402
from etcd_tpu_torch.ops import crc_cuda  # noqa: E402
from etcd_tpu_torch.ops.crc_device import (  # noqa: E402
    chain_verify_device, u32_tensor)
from etcd_tpu_torch.parallel import data_plane_step  # noqa: E402
from etcd_tpu_torch.raft.batched import replication_round  # noqa: E402

N, WIDTH, LEN_LO, LEN_HI = 1 << 20, 384, 256, 380
G, M, CAP = 100_000, 5, 64
SEED_VAL = 0xDEADBEEF
DATA_SEED = 20261016
# One H100 SXM (NVIDIA data sheet): HBM rate, int8 tensor-core rate.
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
_MASK32 = 0xFFFFFFFF


def check(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


# -- host data, vectorised ---------------------------------------------------


def raw_crcs(buf: np.ndarray) -> np.ndarray:
    """Raw CRC32C state of every right-aligned row: a column-serial walk
    of the byte table over all rows at once (uint32 [N])."""
    table = crc32c.TABLE
    s = np.zeros(buf.shape[0], np.uint32)
    for col in np.ascontiguousarray(buf.T):
        s = table[(s ^ col) & 0xFF] ^ (s >> 8)
    return s


def _shift_tables(length: int) -> list[list[int]]:
    """t[k][b] = Z^length @ (b << 8k): Z^length applied to a 32-bit state
    as four byte lookups."""
    z = gf2.zero_operator(length)
    cols = gf2.from_bits(z.T)  # word j = image of state bit j
    b = np.arange(256, dtype=np.uint32)
    out = []
    for k in range(4):
        t = np.zeros(256, np.uint32)
        for m in range(8):
            t ^= np.where((b >> m) & 1, cols[8 * k + m], np.uint32(0))
        out.append([int(x) for x in t])
    return out


def chain(raw: np.ndarray, lens: np.ndarray, seed_val: int) -> np.ndarray:
    """The WAL's rolling CRC chain, stored[i] = update(stored[i-1],
    data_i) with stored[-1] = seed_val, from the raw CRCs:
    update(p, m) = Z^len(m) (p ^ ~0) ^ raw(m) ^ ~0, folded in order."""
    tabs = {int(l): _shift_tables(int(l)) for l in np.unique(lens)}
    out = np.empty(raw.size, np.uint32)
    prev = seed_val
    for i, (r, l) in enumerate(zip(raw.tolist(), lens.tolist())):
        t0, t1, t2, t3 = tabs[l]
        x = prev ^ _MASK32
        prev = (t0[x & 0xFF] ^ t1[(x >> 8) & 0xFF] ^ t2[(x >> 16) & 0xFF]
                ^ t3[x >> 24] ^ r ^ _MASK32)
        out[i] = prev
    return out


def make_wal(n: int, width: int, lo: int, hi: int, seed_val: int,
             seed: int, n_check: int = 1000):
    """``n`` records of ``lo``..``hi`` random bytes right-aligned in
    ``width``-byte rows, and their rolling CRC chain from ``seed_val``;
    ``n_check`` sampled links are checked against ``crc32c.update``."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, size=n).astype(np.int32)
    buf = rng.integers(0, 256, size=(n, width), dtype=np.uint8)
    buf[np.arange(width)[None, :] < (width - lens)[:, None]] = 0
    stored = chain(raw_crcs(buf), lens, seed_val)
    for i in rng.choice(n, size=min(n, n_check), replace=False):
        prev = seed_val if i == 0 else int(stored[i - 1])
        data = buf[i, width - lens[i]:].tobytes()
        check(crc32c.update(prev, data) == int(stored[i]),
              f"host chain disagrees with crc32c.update at record {i}")
    return buf, lens, stored


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


def kernel_parity(rng) -> int:
    """The kernel against its plain version, bit for bit, over widths,
    row counts that are and are not a multiple of the block, all-zero
    rows, empty and full-width records, and a misaligned base."""
    cases = 0
    for length in (8, 64, 256, 384, 4096):
        for n in (1, 255, 4097):
            lens = rng.integers(0, length + 1, size=n)
            lens[0] = length
            lens[1:2] = 0
            lens[2:3] = length
            buf = rng.integers(0, 256, size=(n, length), dtype=np.uint8)
            buf[np.arange(length)[None, :] < (length - lens)[:, None]] = 0
            x = torch.from_numpy(buf).cuda()
            for rows in (x, torch.zeros_like(x)):
                got = crc_cuda.raw_crc_cuda(rows)
                want = crc_cuda.raw_crc_plain(rows)
                torch.cuda.synchronize()
                check(torch.equal(got, want),
                      f"kernel != plain at L={length} N={n}")
                cases += 1
    # a base one byte off a 16-byte boundary takes the byte-load path
    flat = torch.from_numpy(
        rng.integers(0, 256, size=255 * 384 + 1, dtype=np.uint8)).cuda()
    x = flat[1:].view(255, 384)
    check(torch.equal(crc_cuda.raw_crc_cuda(x), crc_cuda.raw_crc_plain(x)),
          "kernel != plain on a misaligned buffer")
    return cases + 1


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
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 1. build
    t0 = time.perf_counter()
    so = crc_cuda.build()
    print(f"kernel build: {time.perf_counter() - t0:.3f} s ({so.name})")
    log = so.with_suffix(".log")
    if log.exists():
        print(log.read_text().strip())

    # 2. kernel vs plain version on the card
    rng = np.random.default_rng(DATA_SEED)
    print(f"parity: {kernel_parity(rng)} cases bit-exact", flush=True)

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

    crc_cuda.raw_crc_cuda.launches = 0
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
    nbytes = buf.numel() + 4 * N + 4 * 8 * WIDTH
    ops = 2 * N * 8 * WIDTH * 32
    bytes_ms, ops_ms = nbytes / HBM_BYTES_S * 1e3, ops / INT8_OPS_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
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
    kernels = [{
        "name": "raw_crc", "route": "cuda",
        "source": "etcd_tpu_torch/csrc/raw_crc.cu",
        "replaces": "etcd_tpu/ops/crc_pallas.py:40",
        "launches": launches, "max_abs_err": max_abs_err,
        "bit_exact": max_abs_err == 0,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "shape": [N, WIDTH], "step_ms": step_ms,
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
