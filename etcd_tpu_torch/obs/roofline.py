"""Roofline accounting: FLOPs per WAL entry, the card's ceilings, a
measured matmul ceiling, and the MFU fields of a measured rate.

The port of ``etcd_tpu/obs/roofline.py``.  Every MFU field goes through
:func:`mfu_fields`, which refuses to emit a ceiling fraction above 100%
as a clean row: the value is still reported, but the row is tagged
``ceiling_suspect: true`` with the probe's provenance.

FLOP definitions: the CRC contraction is bits ``[N, 8W] @ C [8W, 32]``,
``2 * 8W * 32 = 512 * W`` FLOPs per row, W the padded row width (the
generous definition: padding counts as work).  The honest definition
charges only the 256-byte reference payload (``512 * 256``).

:func:`crc_bound` is the least time one H100 SXM could take for the
raw CRC of a batch: the larger of its bytes over the memory rate and
its contraction over the tensor-core rate of the operand type.
"""

from __future__ import annotations

#: FLOPs per padded row byte: 2 * 8 bits * 32 output columns
FLOPS_PER_ROW_BYTE = 512

#: the reference workload's entry payload (BASELINE configs)
HONEST_PAYLOAD_BYTES = 256

#: vendor data-sheet ceilings, dense (the measured probe is always the
#: MFU denominator); h100_sxm: NVIDIA H100 SXM data sheet, at 700 W
SPEC_CEILINGS = {
    "v5e": {"bf16_tflops": 197.0, "int8_tops": 394.0},
    "h100_sxm": {"bf16_tflops": 989.0, "int8_tops": 1979.0,
                 "hbm_tbps": 3.35},
}


def flops_per_entry(width_bytes: int) -> int:
    """Generous (padded-matmul) FLOPs per entry at row width W."""
    return FLOPS_PER_ROW_BYTE * int(width_bytes)


def flops_per_entry_honest(
        payload_bytes: int = HONEST_PAYLOAD_BYTES) -> int:
    """Honest FLOPs per entry: only the payload bytes count."""
    return FLOPS_PER_ROW_BYTE * int(payload_bytes)


def mfu_fields(entries_per_sec: float, row_width_bytes: int, *,
               payload_bytes: int = HONEST_PAYLOAD_BYTES,
               measured_tflops_bf16: float | None = None,
               measured_tops_int8: float | None = None,
               provenance=None) -> dict:
    """Every MFU field of one measurement, ready to merge into a row:

    - ``flops_per_entry`` / ``sustained_useful_tflops``: the generous
      (padded) definition;
    - ``flops_per_entry_honest`` / ``sustained_honest_tflops``: the
      256-byte-payload definition, side by side;
    - ``entries_per_sec_per_tflop``: the rate over the bf16 ceiling;
    - ``pct_of_measured_ceiling`` (+ ``_honest``, ``_int8``): against
      the ceilings measured in the same run.

    If any ceiling fraction exceeds 100 the row gains
    ``ceiling_suspect: true`` and ``ceiling_provenance`` (the probe
    record the caller passed, or "unspecified").
    """
    eps = float(entries_per_sec)
    width = int(row_width_bytes)
    fpe = flops_per_entry(width)
    fpe_honest = flops_per_entry_honest(payload_bytes)
    out = {
        "flops_per_entry": fpe,
        "flops_per_entry_honest": fpe_honest,
        "honest_payload_bytes": int(payload_bytes),
        "row_width_bytes": width,
        "sustained_useful_tflops": round(eps * fpe / 1e12, 4),
        "sustained_honest_tflops": round(eps * fpe_honest / 1e12, 4),
    }
    pcts = []
    if measured_tflops_bf16:
        tf = float(measured_tflops_bf16)
        out["entries_per_sec_per_tflop"] = round(eps / tf, 1)
        out["pct_of_measured_ceiling"] = round(
            100.0 * eps * fpe / 1e12 / tf, 2)
        out["pct_of_measured_ceiling_honest"] = round(
            100.0 * eps * fpe_honest / 1e12 / tf, 2)
        pcts += [out["pct_of_measured_ceiling"],
                 out["pct_of_measured_ceiling_honest"]]
    if measured_tops_int8:
        t8 = float(measured_tops_int8)
        out["pct_of_measured_ceiling_int8"] = round(
            100.0 * eps * fpe / 1e12 / t8, 2)
        pcts.append(out["pct_of_measured_ceiling_int8"])
    if any(p > 100.0 for p in pcts):
        out["ceiling_suspect"] = True
        out["ceiling_provenance"] = (provenance if provenance
                                     is not None else "unspecified")
    return out


def crc_bound(n: int, width: int, operand: str = "int8",
              card: str = "h100_sxm") -> dict:
    """The least time ``card`` could take for the raw CRC of ``n`` rows
    of ``width`` bytes: rows read once, uint32 states written once, the
    packed ``8 * width``-word contribution matrix read once, over the
    memory rate; or the GF(2) contraction, ``2 n 8width 32``
    operations, over the tensor-core rate of ``operand`` (``int8`` or
    ``bf16``).  Returns ``bound_ms`` (the larger), ``bound_by``
    (``"bytes"`` or ``"operations"``), ``bytes`` and ``ops``."""
    spec = SPEC_CEILINGS[card]
    rate = {"int8": spec["int8_tops"], "bf16": spec["bf16_tflops"]}[operand]
    nbytes = n * width + 4 * n + 4 * 8 * width
    ops = 2 * n * 8 * width * 32
    bytes_ms = nbytes / (spec["hbm_tbps"] * 1e12) * 1e3
    ops_ms = ops / (rate * 1e12) * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": ops}


def probe_matmul_ceiling(dtype_name: str = "bf16", k: int = 64,
                         device="cuda") -> float:
    """Measured dense 2048^3 matrix-product rate of a CUDA device:
    TFLOP/s for ``bf16`` (``torch.matmul``), TOP/s for ``int8``
    (``torch._int_mm``, int32 sums).

    A chain of ``k`` products, each on an operand perturbed by its
    index (``a + i``, made before the clock starts so that only the
    products are timed), timed with CUDA events after one warm product.
    A yardstick only: nothing on the kernels' path calls it.  Raises on
    a device that is not CUDA."""
    import numpy as np
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the ceiling probe measures a CUDA device, not "
                         f"{dev}")
    rng = np.random.default_rng(3)
    if dtype_name == "bf16":
        a = torch.from_numpy(rng.standard_normal((2048, 2048)).astype(
            np.float32)).to(dev, torch.bfloat16)

        def product(x):
            return torch.matmul(x, a)
    elif dtype_name == "int8":
        a = torch.from_numpy(rng.integers(
            -4, 4, size=(2048, 2048)).astype(np.int8)).to(dev)

        def product(x):
            return torch._int_mm(x, a)
    else:
        raise ValueError(f"unknown probe type {dtype_name!r}")
    xs = [a + i for i in range(k)]
    product(a)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for x in xs:
        product(x)
    end.record()
    end.synchronize()
    seconds = start.elapsed_time(end) / 1e3
    return 2 * 2048 ** 3 * k / seconds / 1e12


__all__ = [
    "FLOPS_PER_ROW_BYTE", "HONEST_PAYLOAD_BYTES", "SPEC_CEILINGS",
    "crc_bound", "flops_per_entry", "flops_per_entry_honest",
    "mfu_fields", "probe_matmul_ceiling",
]
