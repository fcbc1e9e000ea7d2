"""Race the raw-CRC formulations on one device.

    python -m etcd_tpu_torch.scripts.crc_variants_bench [N_ROWS] [WIDTH] [ITERS]

The port of ``scripts/crc_variants_bench.py``.  The data are seed-injected
chained WAL records (lengths in ``[W//2, W-4)``, generator seed 3, chain
from 0), so every variant's gate is the full rolling-chain verify:
iteration 0 must verify all n links or the variant is reported as
``{"error": "gate k/n"}`` and the script exits non-zero.  The other
iterations run launch after launch with no sync, timed by CUDA events
around the loop (a host clock on the CPU).  Iteration ``i`` changes the
input so that no two iterations are the same work: inside the kernel
(its perturb byte) for the packed-planes kernels, as ``rows ^ i`` (a
full extra pass over the batch) for the others.

On a CUDA device the names are ``xla`` (the plain unpack + product,
``raw_crc_plain``), ``pallas`` (``csrc/raw_crc.cu``), the plain
``planes``, ``transposed`` and ``planes_t``, and the tensor-core planes
kernel (``csrc/planes_crc.cu``) at several tiles.  On the CPU they are
``xla`` and the sorted ``VARIANTS``, each through its plain version.

Prints one JSON line per variant (``variant``, ``route``,
``entries_per_sec``, ``gbps``, ``ms_per_iter``, ``bound_ms``,
``pct_of_bound`` and the roofline's MFU fields against the ceilings the
run measured), then a ``best`` line.  ``main(rows, stored, iters,
device)`` runs the race on prepared data and returns the rows.
"""

from __future__ import annotations

import json
import sys
import time
import traceback

import numpy as np
import torch

from ..ops.crc_cuda import raw_crc_plain
from ..ops.crc_device import chain_links_injected, raw_crc_batch, u32_tensor
from ..ops.crc_variants import (
    VARIANTS,
    _planes_env_tile,
    pallas_planes_perturbed,
    parse_variant,
)
from ..obs import roofline
from .walgen import injected, make_wal

#: the race on a CUDA device
CARD_NAMES = ("xla", "pallas", "planes", "transposed", "planes_t",
              "pallas_planes@512", "pallas_planes@1024",
              "pallas_planes@2048", "pallas_planes_t@1024",
              "pallas_planes_t@2048")


def variant_names(device: torch.device) -> list[str]:
    """The names raced on ``device``."""
    if device.type == "cuda":
        return list(CARD_NAMES)
    return ["xla"] + sorted(VARIANTS)


def make_fn(name: str, device: torch.device):
    """``(fn, route)`` for one variant: ``fn(rows, i)`` gives the raw
    CRCs of ``rows ^ uint8(i)``; ``route`` names what runs it."""
    on_card = device.type == "cuda"
    base, tile = parse_variant(name)
    if base.startswith("pallas_planes"):
        fn = pallas_planes_perturbed(base, tile or _planes_env_tile())
        return fn, "cuda:planes_crc" if on_card else "plain"
    raw = {"xla": raw_crc_plain, "pallas": raw_crc_batch, **VARIANTS}[base]

    def outer(rows, i):
        return raw(rows if i == 0 else rows ^ (i & 0xFF))

    return outer, "cuda:raw_crc" if on_card and base == "pallas" \
        else "plain"


def time_loop(device: torch.device, body, first: int, last: int) -> float:
    """Seconds to run ``body(i)`` for ``first <= i < last``, launch
    after launch: CUDA events around the loop on a card, the host clock
    on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(first, last):
            body(i)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for i in range(first, last):
        body(i)
    return time.perf_counter() - t0


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def main(rows, stored, iters: int = 8, device=None) -> dict:
    """Race every variant of :func:`variant_names` on seed-injected
    ``rows`` (uint8 [n, W]) against their ``stored`` chain CRCs,
    ``iters`` iterations each (at least 2: the gate and one timed).
    Prints the JSON lines and returns ``{name: row}``; a row with an
    ``error`` key failed."""
    if iters < 2:
        raise ValueError("the race needs iters >= 2: a gated iteration "
                         "and at least one timed")
    dev = torch.device("cuda" if device is None else device)
    rows = torch.as_tensor(rows).to(dev)
    stored = u32_tensor(stored, dev)
    n, width = rows.shape
    on_card = dev.type == "cuda"
    kind = device_name(dev)
    ceilings = {}
    if on_card:
        ceilings = {"bf16_tflops": roofline.probe_matmul_ceiling("bf16"),
                    "int8_tops": roofline.probe_matmul_ceiling("int8")}
        print(json.dumps({"env_matmul_tflops_bf16": ceilings["bf16_tflops"],
                          "env_matmul_tops_int8": ceilings["int8_tops"],
                          "device": kind}), flush=True)
    bound = roofline.crc_bound(n, width)

    results = {}
    for name in variant_names(dev):
        try:
            fn, route = make_fn(name, dev)
            n_ok = int(chain_links_injected(fn(rows, 0), stored).sum())
            if n_ok != n:
                results[name] = {"error": f"gate {n_ok}/{n}"}
            else:
                secs = time_loop(dev, lambda i: chain_links_injected(
                    fn(rows, i), stored), 1, iters)
                timed = iters - 1
                ms = secs * 1e3 / timed
                eps = n * timed / secs
                row = {"route": route, "entries_per_sec": eps,
                       "gbps": n * width * timed / secs / 1e9,
                       "ms_per_iter": ms,
                       "bound_ms": bound["bound_ms"] if on_card else None,
                       "bound_by": bound["bound_by"] if on_card else None,
                       "pct_of_bound": (100.0 * bound["bound_ms"] / ms
                                        if on_card else None)}
                row.update(roofline.mfu_fields(
                    eps, width,
                    measured_tflops_bf16=ceilings.get("bf16_tflops"),
                    measured_tops_int8=ceilings.get("int8_tops"),
                    provenance={"probe": "roofline.probe_matmul_ceiling",
                                **ceilings, "device": kind}))
                results[name] = row
        except Exception as e:  # per-variant isolation; reported below
            traceback.print_exc()
            results[name] = {"error": repr(e)[:200]}
        print(json.dumps({"variant": name, "device": kind,
                          **results[name]}), flush=True)

    ok = {k: v for k, v in results.items() if "error" not in v}
    if ok:
        best = max(ok, key=lambda k: ok[k]["entries_per_sec"])
        print(json.dumps({"best": best, "device": kind, "n": n,
                          "width": width, "iters": iters, **ok[best]}),
              flush=True)
    return results


def make_data(n: int, width: int):
    """The race's records: ``n`` rows of lengths in ``[W//2, W-4)``
    from generator seed 3, chained from 0 and seed-injected.  Returns
    (rows, stored) as numpy."""
    buf, lens, stored = make_wal(n, width, width // 2, width - 5,
                                 seed_val=0, seed=3, n_check=256)
    return injected(buf, lens, stored, 0), stored


if __name__ == "__main__":
    n_rows = int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 18
    row_width = int(sys.argv[2]) if len(sys.argv) > 2 else 384
    n_iters = int(sys.argv[3]) if len(sys.argv) > 3 else 8
    t0 = time.perf_counter()
    data = make_data(n_rows, row_width)
    print(json.dumps({"generated": n_rows,
                      "seconds": time.perf_counter() - t0}), flush=True)
    out = main(*data, n_iters)
    sys.exit(1 if any("error" in r for r in out.values()) else 0)
