"""CPU tests of chip_smoke.py's host-side helpers: the ptxas summary of the
kernel build and the work / bound arithmetic behind the kernels line."""

import chip_smoke
import torch

from nerf_mae_torch import kernels

PTXAS_LOG = """ptxas info    : Compiling entry function '_ZN4swin9sum_partsEPKfixPf' for 'sm_90a'
ptxas info    : Function properties for _ZN4swin9sum_partsEPKfixPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z4gemmv' for 'sm_90a'
ptxas info    : Function properties for _Z4gemmv
    16 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 1056 bytes smem, 400 bytes cmem[0]
"""


def test_ptxas_summary_reads_registers_smem_and_spills(monkeypatch, capsys):
    monkeypatch.setattr(kernels, "BUILD_LOG", {"lib": PTXAS_LOG})
    chip_smoke.ptxas_summary()
    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    assert len(lines) == 2
    assert "32 registers, 0 B static smem, 0 B stack, spills 0/0 B" in lines[0]
    assert "255 registers, 1056 B static smem, 16 B stack, spills 12/16 B" in lines[1]


def test_work_and_bound_of_the_block_backward():
    # one stage-2 call at batch 8: FLOPs of the real tokens only
    flops, nbytes = chip_smoke.work("block_bwd", (8, 10, 10, 10, 512), 16, torch.bfloat16)
    assert flops == 8000 * (72 * 512 * 512 + 12 * 64 * 512)
    ms, by = chip_smoke.bound(flops, nbytes, torch.bfloat16)
    assert by == "operations" and abs(ms - flops / 989e12 * 1e3) < 1e-12


def test_cached_build_reads_its_ptxas_report_back(monkeypatch, tmp_path):
    """A library built by an earlier process (its .so already in the build
    directory) is not rebuilt, and its nvcc log kept beside it fills
    BUILD_LOG, so phase 2 still prints registers, smem and spills."""
    monkeypatch.setattr(kernels, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(kernels, "BUILD_LOG", {})
    out = kernels._build_dir()
    out.mkdir(parents=True)
    for name in kernels.SOURCES:
        (out / f"lib{name}.so").write_bytes(b"")
        (out / f"lib{name}.log").write_text(PTXAS_LOG)
    assert kernels.build_all() == 0.0
    assert kernels.BUILD_LOG == {name: PTXAS_LOG for name in kernels.SOURCES}


def test_work_and_bound_of_the_swin_s_stage0_block():
    """swin_s at 160^3, batch 8, stage 0 (40^3 tokens, C = 96, 3 heads):
    about 0.127 ms forward and 0.382 ms backward at 989 TFLOP/s, both
    bound by operations."""
    shape, heads = (8, 40, 40, 40, 96), 3
    fwd, fwd_bytes = chip_smoke.work("block", shape, heads, torch.bfloat16)
    bwd, bwd_bytes = chip_smoke.work("block_bwd", shape, heads, torch.bfloat16)
    assert fwd == 512000 * (24 * 96 * 96 + 4 * 64 * 96)
    assert bwd == 512000 * (72 * 96 * 96 + 12 * 64 * 96)
    fwd_ms, fwd_by = chip_smoke.bound(fwd, fwd_bytes, torch.bfloat16)
    bwd_ms, bwd_by = chip_smoke.bound(bwd, bwd_bytes, torch.bfloat16)
    assert fwd_by == bwd_by == "operations"
    assert abs(fwd_ms - 0.1272) < 5e-4 and abs(bwd_ms - 0.3817) < 5e-4
