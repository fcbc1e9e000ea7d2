"""Measure the card's rate of the 1-bit and the int8 warp-level
tensor-core products (``csrc/mma_probe.cu``).

    python -m etcd_tpu_torch.scripts.mma_rate

``raw_crc.cu`` computes a GF(2) contraction, which the 1-bit
``mma.sync ... b1.b1.s32.and.popc`` form takes with no unpacking, and
the int8 form takes after the bit planes are made.  NVIDIA's H100 data
sheet gives no 1-bit rate, so this probe measures both forms on the
card.  It also reads the probe's SASS with ``cuobjdump`` (where the
toolkit has it) and counts the tensor-core opcodes, to tell a native
1-bit instruction from an emulated one.  Prints and returns one JSON
object: TOP/s of each form, operations counted as 2 M N K an
instruction.
"""

from __future__ import annotations

import ctypes
import functools
import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

import torch

from ..ops.crc_cuda import CSRC, build, library

SOURCE = CSRC / "mma_probe.cu"

#: name, kind argument, 2 M N K operations an instruction
FORMS = (("b1_and_popc_m16n8k256", 0, 2 * 16 * 8 * 256),
         ("s8_m16n8k32", 1, 2 * 16 * 8 * 32))


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = library(SOURCE)
    lib.mma_probe_launch.argtypes = [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_void_p]
    lib.mma_probe_launch.restype = ctypes.c_int
    lib.mma_probe_chains.restype = ctypes.c_int
    return lib


def sass_opcodes(so: Path) -> dict[str, int]:
    """Tensor-core opcodes (``*MMA*``) in the library's SASS, counted;
    empty when the toolkit has no ``cuobjdump``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    return dict(Counter(re.findall(r"\b([A-Z]*MMA[A-Z0-9.]*)", sass)))


def main(reps: int = 5, iters: int = 4096) -> dict:
    """Time each form on the current CUDA device; returns the result."""
    if not torch.cuda.is_available():
        raise RuntimeError("mma_rate needs a CUDA device")
    lib = _library()
    dev = torch.device("cuda")
    props = torch.cuda.get_device_properties(dev)
    blocks = props.multi_processor_count * 8
    out = torch.empty(blocks * 128, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    chains = lib.mma_probe_chains()
    result = {"device": torch.cuda.get_device_name(dev), "blocks": blocks,
              "iters": iters}
    for name, kind, ops in FORMS:
        times = []
        for _ in range(reps + 1):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            err = lib.mma_probe_launch(kind, blocks, iters, out.data_ptr(),
                                       stream)
            b.record()
            if err != 0:
                raise RuntimeError(f"mma_probe {name}: cudaError {err}")
            b.synchronize()
            times.append(a.elapsed_time(b))
        ms = sorted(times[1:])[reps // 2]
        n_mma = blocks * 4 * iters * chains  # 4 warps a block
        result[name] = {"ms": ms, "tops": n_mma * ops / ms / 1e9,
                        "instr_per_ns": n_mma / ms / 1e6}
    result["sass_mma_opcodes"] = sass_opcodes(build(SOURCE))
    print(json.dumps({"mma_rate": result}), flush=True)
    return result


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:3]))
