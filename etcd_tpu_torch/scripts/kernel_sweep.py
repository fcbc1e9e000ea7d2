"""Sweep the raw-CRC kernels' tile and operand type on one device.

    python -m etcd_tpu_torch.scripts.kernel_sweep [K_ITERS] [N_ROWS_LOG2]

The port of ``scripts/pallas_sweep.py``, on uniform random ``[2^20,
384]`` rows (generator seed 0).  Each row of the sweep runs ``K``
iterations of ``fn(buf ^ i)``, launch after launch, timed by CUDA events
(a host clock on the CPU), and reports GB/s of input rows.  Before it is
timed, each row's output over the whole batch must equal the plain
version's bit for bit (and the plain version's must equal the host CRC
on 64 rows); a mismatch raises.

Each row's ``pct_of_bound`` holds it against the function's bound at
the rate of its operand type (``roofline.crc_bound``).  Rows:
``xla_int8`` and ``xla_bf16`` are the plain versions (the unpack
+ one product, and the plane-by-plane products that the bf16 kernel
computes, in float32 since a bf16 product in torch rounds its output);
``pallas_current`` is ``csrc/raw_crc.cu`` at the main path's rows a
tile; ``pallas_cat`` is it at 16/32/64 rows a warp tile (TPU kernel 5's
tile);
``pallas_pl8`` and ``pallas_bf16`` are ``csrc/planes_crc.cu`` at tiles
512/1024/2048 in int8 and 1024/2048 in bf16 (TPU kernel 4), and
``pallas_bf16_t`` its transposed bf16 form.  On the CPU only the plain
rows run.  ``main(k, n_log2, device)`` returns the rows.
"""

from __future__ import annotations

import functools
import json
import sys

import numpy as np
import torch

from ..crc import crc32c
from ..obs import roofline
from ..ops.crc_cuda import ROWS_PER_TILE, raw_crc_cuda, raw_crc_plain
from ..ops.planes_cuda import planes_crc_cuda, planes_crc_plain
from .crc_variants_bench import device_name, time_loop

L = 384


def sweep_rows(device: torch.device) -> list[tuple[str, object, str]]:
    """``(name, fn, operand)`` of every row swept on ``device``; the
    operand type sets the row's bound."""
    rows = [("xla_int8", raw_crc_plain, "int8"),
            ("xla_bf16", functools.partial(planes_crc_plain,
                                           operand="bf16"), "bf16")]
    if device.type != "cuda":
        return rows
    rows.append(("pallas_current", raw_crc_cuda, "int8"))
    rows += [(f"pallas_cat t{r}", functools.partial(raw_crc_cuda, rows=r),
              "int8") for r in ROWS_PER_TILE]
    rows += [(f"pallas_pl8 t{t}", functools.partial(planes_crc_cuda,
                                                    tile=t), "int8")
             for t in (512, 1024, 2048)]
    rows += [(f"pallas_bf16 t{t}", functools.partial(
        planes_crc_cuda, tile=t, operand="bf16"), "bf16")
        for t in (1024, 2048)]
    rows.append(("pallas_bf16_t t1024", functools.partial(
        planes_crc_cuda, tile=1024, transposed=True, operand="bf16"),
        "bf16"))
    return rows


def main(k: int = 12, n_log2: int = 20, device=None) -> list[dict]:
    """Run the sweep; print and return one dict per row."""
    dev = torch.device("cuda" if device is None else device)
    n = 1 << n_log2
    kind = device_name(dev)
    rng = np.random.default_rng(0)
    host = rng.integers(0, 256, size=(n, L), dtype=np.uint8)
    buf = torch.from_numpy(host).to(dev)
    want = raw_crc_plain(buf)
    spot = np.array([crc32c.raw_update(0, r.tobytes()) for r in host[:64]],
                    np.int64)
    if not np.array_equal(want[:64].cpu().numpy(), spot):
        raise RuntimeError("kernel_sweep: the plain raw CRC disagrees with "
                           "the host CRC")
    print(json.dumps({"sweep": "start", "device": kind, "n": n, "width": L,
                      "k": k}), flush=True)
    out = []
    for name, fn, operand in sweep_rows(dev):
        if not torch.equal(fn(buf), want):
            raise RuntimeError(f"kernel_sweep: {name} is not bit-exact "
                               f"with the plain raw CRC")
        fn(buf ^ 1)  # warm
        secs = time_loop(dev, lambda i: fn(buf ^ (i & 0xFF)), 0, k)
        ms = secs * 1e3 / k
        bound = roofline.crc_bound(n, L, operand)["bound_ms"]
        row = {"sweep": name, "device": kind, "bit_exact": True,
               "gbps": n * L * k / secs / 1e9,
               "entries_per_sec": n * k / secs, "ms_per_iter": ms,
               "bound_ms": bound if dev.type == "cuda" else None,
               "pct_of_bound": (100.0 * bound / ms
                                if dev.type == "cuda" else None)}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 12,
         int(sys.argv[2]) if len(sys.argv) > 2 else 20)
