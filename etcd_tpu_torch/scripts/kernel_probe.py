"""What the port's two raw-CRC kernels spend their time on, on the card.

    python -m etcd_tpu_torch.scripts.kernel_probe [READING ...]
    PYTHONPATH=<checkout> python etcd_tpu_torch/scripts/kernel_probe.py times

Prints one JSON line a reading; READING is any of ``times``, ``parts``
and ``sass`` (all three when none is given):

- ``times``: each kernel alone on uniform random ``[2^20, 384]`` rows
  (torch generator seed 0) through its wrapper: ``raw_crc.cu`` at every
  rows a tile, ``planes_crc.cu`` at tile 1024 in both orientations and
  both operand types.  A time is the median over 15 runs of 10 launches
  back to back, by CUDA events, over 10, so the host's cost of a launch
  hides behind the kernels before it.  This reading calls nothing but
  the wrappers, so it also runs against another checkout of the port
  (the second form above) to compare two trees in one call.
- ``parts``: ``planes_crc.cu`` built with each ``PLANES_PROBE`` mask (1
  no products, 2 no row copies, 3 neither, 4 no plane making; 0 is the
  kernel itself) and timed as above, in every orientation and operand
  type.  What a part costs is the kernel's time less the time without
  it; the masked builds' results are wrong by design and not checked.
- ``sass``: the SASS of every kernel function of both libraries, by
  ``cuobjdump -sass`` (under the CUDA toolkit): instructions counted by
  class over the whole function and over the span from its first to
  its last tensor-core instruction (the unrolled product loop), local
  memory (spills and stack) included, and whether nvcc's report holds ptxas's
  warning that it serialized ``wgmma`` (C7520).
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from etcd_tpu_torch.ops import crc_cuda, planes_cuda

N_LOG2, L, TILE = 20, 384, 1024
FORMS = [(t, op) for t in (False, True) for op in ("int8", "bf16")]
MASKS = {0: "kernel", 1: "no products", 2: "no row copies",
         3: "neither", 4: "no plane making"}

#: instruction classes of the sass reading, by opcode (the part before
#: the first dot)
CLASSES = {
    "tensor": ("HGMMA", "IGMMA", "QGMMA", "IMMA", "HMMA", "BMMA"),
    "ldmatrix": ("LDSM",),
    "smem_load": ("LDS",),
    "smem_store": ("STS",),
    "async_copy": ("LDGSTS", "UBLKCP", "UTMALDG", "LDGDEPBAR", "DEPBAR"),
    "global": ("LDG", "STG"),
    "barrier": ("BAR", "SYNCS", "WARPGROUP", "WARPSYNC"),
    "integer": ("LOP3", "SHF", "IADD3", "IMAD", "ISETP", "SEL", "PRMT",
                "LEA", "IMNMX", "IABS", "FLO", "POPC"),
    "shuffle": ("SHFL",),
    "local_memory": ("STL", "LDL"),
}


# "/*0a40*/  @!P0 HGMMA.64x32x32.S32.S8 R24, ..." -> "HGMMA.64x32x32.S32.S8"
_INSTRUCTION = re.compile(
    r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Za-z0-9_.]*)")


def _rows(dev: torch.device) -> torch.Tensor:
    gen = torch.Generator(device=dev).manual_seed(0)
    return torch.randint(0, 256, (1 << N_LOG2, L), dtype=torch.uint8,
                         device=dev, generator=gen)


def time_ms(fn, reps: int = 15, batch: int = 10) -> float:
    """Median device time of one ``fn()`` over ``reps`` runs of
    ``batch`` calls back to back, after two warm runs."""
    for _ in range(2 * batch):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def times(buf: torch.Tensor) -> dict:
    """Each kernel alone through its wrapper: ms by name."""
    out = {}
    for rows in crc_cuda.ROWS_PER_TILE:
        out[f"raw_crc@{rows}"] = time_ms(
            lambda: crc_cuda.raw_crc_cuda(buf, rows))
    for t, op in FORMS:
        out[f"planes_crc{'_t' if t else ''} {op}"] = time_ms(
            lambda: planes_cuda.planes_crc_cuda(buf, TILE, t, 0, op))
    return out


def parts(buf: torch.Tensor) -> dict:
    """``planes_crc.cu`` under every ``PLANES_PROBE`` mask: ms by form,
    then by what the build leaves out."""
    defines = {m: () if m == 0 else (f"PLANES_PROBE={m}",) for m in MASKS}
    with ThreadPoolExecutor(len(MASKS)) as ex:
        built = dict(zip(MASKS, ex.map(
            lambda m: crc_cuda.build(planes_cuda.SOURCE, defines[m]),
            MASKS)))
    libs = {m: planes_cuda.bind(ctypes.CDLL(str(so)))
            for m, so in built.items()}
    n, length = buf.shape
    ck = planes_cuda._columns_on(length, buf.device)
    res = torch.empty(n, dtype=torch.int64, device=buf.device)
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    out = {}
    for t, op in FORMS:
        row = {}
        for m, lib in libs.items():
            def launch(lib=lib):
                err = lib.planes_crc_launch(
                    buf.data_ptr(), ck.data_ptr(), res.data_ptr(), n, length,
                    TILE, int(t), 0 if op == "int8" else 1, 0, stream)
                if err != 0:
                    raise RuntimeError(f"kernel_probe: PLANES_PROBE={m} "
                                       f"launch failed: cudaError {err}")
            row[MASKS[m]] = time_ms(launch)
        out[f"planes_crc{'_t' if t else ''} {op}"] = row
    return out


def _tool(name: str) -> str | None:
    tool = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    return tool if Path(tool).exists() else None


def _demangle(names: list[str]) -> dict[str, str]:
    """Names as C++ reads them, where the toolkit or binutils can
    demangle them; else as they are."""
    tool = _tool("cu++filt") or _tool("c++filt")
    if tool is not None and names:
        proc = subprocess.run([tool], input="\n".join(names),
                              capture_output=True, text=True)
        text = proc.stdout.splitlines()
        if proc.returncode == 0 and len(text) == len(names):
            return dict(zip(names, text))
    return {n: n for n in names}


def _classes(opcodes: list[str]) -> dict[str, int]:
    counts = Counter()
    for op in opcodes:
        base = op.split(".")[0]
        for cls, members in CLASSES.items():
            if base in members:
                counts[cls] += 1
                break
    counts["all"] = len(opcodes)
    return dict(counts)


def sass_reading(so: Path) -> dict:
    """Instruction classes of every kernel function in ``so``, over the
    function and over its product loop (first to last tensor-core
    instruction)."""
    tool = _tool("cuobjdump")
    if tool is None:
        return {"error": "no cuobjdump in the CUDA toolkit"}
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    funcs: dict[str, list[str]] = {}
    name = None
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            funcs[name] = []
            continue
        ins = _INSTRUCTION.match(line)
        if name and ins:
            funcs[name].append(ins.group(1))
    names = _demangle(list(funcs))
    out = {}
    for mangled, ops in funcs.items():
        tensor = [i for i, op in enumerate(ops)
                  if op.split(".")[0] in CLASSES["tensor"]]
        loop = ops[tensor[0]:tensor[-1] + 1] if tensor else []
        out[names[mangled]] = {
            "function": _classes(ops), "product_loop": _classes(loop),
            "tensor_opcodes": dict(Counter(ops[i] for i in tensor))}
    log = so.with_suffix(".log")
    return {"library": so.name, "kernels": out,
            "wgmma_serialized_warning": log.exists()
            and "C7520" in log.read_text()}


def main(readings=("times", "parts", "sass")) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_probe needs a CUDA device")
    dev = torch.device("cuda")
    result = {"device": torch.cuda.get_device_name(dev),
              "shape": [1 << N_LOG2, L], "tile": TILE}
    buf = _rows(dev) if {"times", "parts"} & set(readings) else None
    for reading in readings:
        if reading == "times":
            result[reading] = times(buf)
        elif reading == "parts":
            result[reading] = parts(buf)
        elif reading == "sass":
            result[reading] = [sass_reading(crc_cuda.build(src)) for src in
                               (crc_cuda.SOURCE, planes_cuda.SOURCE)]
        else:
            raise ValueError(f"kernel_probe: no reading {reading!r}")
        print(json.dumps({reading: result[reading],
                          "device": result["device"]}), flush=True)
    return result


if __name__ == "__main__":
    main(tuple(sys.argv[1:]) or ("times", "parts", "sass"))
