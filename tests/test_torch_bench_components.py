"""`python -m nerf_mae_torch.tools.bench_components`, the port of
scripts/bench_components.py, on the CPU at swin_nano 32^3, batch 1: its
rows carry the JAX script's names (the same formula, from the JAX preset),
every time is finite, --only filters, the default output names the device
(never the JAX script's runs/component_breakdown.json), and no kernel is
counted on the CPU."""

import json
import math

import pytest
import torch

from nerf_mae_tpu.config import SWIN_PRESETS as JPRESETS
from nerf_mae_torch.tools import bench_components

torch.set_num_threads(1)
SMALL = ["--preset", "swin_nano", "--resolution", "32", "--batch", "1", "--reps", "1",
         "--device", "cpu"]


def _jax_row_names(preset, resolution, b):
    """scripts/bench_components.py's rows (:116-181), in its order."""
    swin = JPRESETS[preset]
    t = resolution // swin.patch_size[0]
    names = ["patch_embed_patched_k256", "patch_embed_flat256_arg"]
    for i in range(len(swin.depths)):
        dim, g = swin.stage_dims[i], t // 2**i
        names.append(f"stage{i}_pair_[{b},{g}^3,{dim}]")
        if i < len(swin.depths) - 1:
            names.append(f"merge{i}_[{b},{g}^3,{dim}]")
    dims = swin.stage_dims
    for lvl, (ci, gi) in enumerate([(dims[3], t // 8), (dims[2], t // 4), (dims[1], t // 2)]):
        names.append(f"decoder{4 - lvl}_[{b},{gi}^3,{ci}]")
    return names + ["subpixel_head_patched"]


def test_rows_match_the_jax_names_and_are_finite(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = bench_components.main(SMALL)
    assert list(out["rows"]) == _jax_row_names("swin_nano", 32, 1)
    for name, row in out["rows"].items():
        assert math.isfinite(row["fwd"]) and row["fwd"] > 0, name
        assert math.isfinite(row["fwd_bwd"]) and row["fwd_bwd"] > 0, name
        assert row["launches"] == {"fwd": {}, "fwd_bwd": {}}, name  # no kernel on the CPU
    assert out["meta"] == {"preset": "swin_nano", "resolution": 32, "batch": 1, "reps": 1,
                           "unit": "ms", "device": "cpu"}
    written = tmp_path / "runs" / "component_breakdown_cpu.json"
    assert json.loads(written.read_text()) == out
    assert not (tmp_path / "runs" / "component_breakdown.json").exists()


@pytest.mark.parametrize("only,want", [
    ("stage1", ["stage1_pair_[1,4^3,24]"]),
    ("merge", ["merge0_[1,8^3,12]", "merge1_[1,4^3,24]", "merge2_[1,2^3,48]"]),
    ("patch_embed", ["patch_embed_patched_k256", "patch_embed_flat256_arg"]),
])
def test_only_filters_the_rows(tmp_path, only, want):
    out = bench_components.main([*SMALL, "--only", only, "--out", str(tmp_path / "c.json")])
    assert list(out["rows"]) == want


def test_cuda_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_components.main(["--preset", "swin_nano", "--resolution", "32",
                               "--out", str(tmp_path / "c.json")])
