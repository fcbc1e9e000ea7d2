"""The port's kernel builds keyed by their defines and headers, and the
SASS reading of ``etcd_tpu_torch.scripts.kernel_probe`` on a canned
``cuobjdump`` listing (no GPU, no CUDA toolkit)."""

import re
import shutil
import stat

import pytest
import torch

from etcd_tpu_torch.ops import crc_cuda, planes_cuda
from etcd_tpu_torch.scripts import kernel_probe

SASS = """
\tcode for sm_90a
\t\tFunction : _Z6kernelILi32ELb1EEvPKh
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /* 0x000fe40000000f00 */
        /*0010*/                   LDS.128 R4, [R2] ;
        /*0020*/                   BMMA.168256.AND.POPC R8, R4, R12, R8 ;
        /*0030*/                   LOP3.LUT R5, R5, 0x1, RZ, 0xc0, !PT ;
        /*0040*/              @!P0 BMMA.168256.AND.POPC R8, R6, R14, R8 ;
        /*0050*/                   STL.64 [R1], R8 ;
        /*0060*/                   EXIT ;
\t\tFunction : _Z6kernelILi16ELb0EEvPKh
        /*0000*/                   LDG.E.128 R4, desc[UR4][R2.64] ;
        /*0010*/               @P1 BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0020*/                   EXIT ;
"""


def test_build_keys_hold_defines_and_headers(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    shutil.copy(crc_cuda.SOURCE, src)
    shutil.copy(crc_cuda.CSRC / "grid.cuh", tmp_path / "grid.cuh")
    monkeypatch.setattr(crc_cuda, "CSRC", tmp_path)
    plain = crc_cuda.library_path(src)
    assert plain == crc_cuda.library_path(src, ())
    probe = crc_cuda.library_path(src, ("PLANES_PROBE=1",))
    assert probe != plain
    assert probe != crc_cuda.library_path(src, ("PLANES_PROBE=2",))
    (tmp_path / "grid.cuh").write_text("// changed\n")
    assert crc_cuda.library_path(src) != plain


def test_kernel_sources_include_only_headers_of_csrc():
    """Every quoted include of a kernel source is a header under csrc/,
    so the build key covers it."""
    for src in (crc_cuda.SOURCE, planes_cuda.SOURCE):
        for header in re.findall(r'#include "([^"]+)"', src.read_text()):
            assert (crc_cuda.CSRC / header).exists(), (src.name, header)
            assert header.endswith(".cuh")


@pytest.mark.parametrize("line, opcode", [
    ("        /*0a40*/              @!P0 HGMMA.64x32x32.S32.S8 R24, R88, "
     "gdesc[UR4], R24, gsb0 ;", "HGMMA.64x32x32.S32.S8"),
    ("        /*0050*/                   LDS.128 R4, [R2] ;", "LDS.128"),
    ("        /*0100*/              @UP0 BAR.SYNC.DEFER_BLOCKING 0x0 ;",
     "BAR.SYNC.DEFER_BLOCKING"),
    ("        /* 0x000fe200078e00ff */", None),
])
def test_sass_lines_give_their_opcode(line, opcode):
    m = kernel_probe._INSTRUCTION.match(line)
    assert (m.group(1) if m else None) == opcode


def test_instruction_classes():
    got = kernel_probe._classes(["IGMMA.64x32x32.S8.S8", "LDS.128",
                                 "LOP3.LUT", "STL.64", "MOV",
                                 "HGMMA.64x32x16.F32.BF16"])
    assert got == {"tensor": 2, "smem_load": 1, "integer": 1,
                   "local_memory": 1, "all": 6}


def test_sass_reading_counts_each_function_and_its_product_loop(
        tmp_path, monkeypatch):
    listing = tmp_path / "listing.txt"
    listing.write_text(SASS)
    tool = tmp_path / "cuobjdump"
    tool.write_text(f"#!/bin/sh\ncat {listing}\n")
    tool.chmod(tool.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(kernel_probe, "_tool",
                        lambda name: str(tool) if name == "cuobjdump"
                        else None)
    so = tmp_path / "k.so"
    so.write_bytes(b"")
    so.with_suffix(".log").write_text("ptxas info: 0 bytes spill stores\n")
    got = kernel_probe.sass_reading(so)
    assert got["library"] == "k.so"
    assert got["wgmma_serialized_warning"] is False
    first = got["kernels"]["_Z6kernelILi32ELb1EEvPKh"]
    assert first["function"] == {"tensor": 2, "smem_load": 1, "integer": 1,
                                 "local_memory": 1, "all": 7}
    assert first["product_loop"] == {"tensor": 2, "integer": 1, "all": 3}
    assert first["tensor_opcodes"] == {"BMMA.168256.AND.POPC": 2}
    second = got["kernels"]["_Z6kernelILi16ELb0EEvPKh"]
    assert second["function"] == {"global": 1, "barrier": 1, "all": 3}
    assert second["product_loop"] == {"all": 0}


def test_sass_reading_without_cuobjdump(tmp_path, monkeypatch):
    monkeypatch.setattr(kernel_probe, "_tool", lambda name: None)
    assert "error" in kernel_probe.sass_reading(tmp_path / "k.so")


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no CUDA")
def test_probe_refuses_to_run_without_cuda():
    with pytest.raises(RuntimeError, match="CUDA"):
        kernel_probe.main(("times",))
