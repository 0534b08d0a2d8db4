"""The one rule that picks a layer's hand-written kernel or its plain
composition (nerf_mae_torch/kernels.py `wanted`), and that every Swin block
and UNETR res block of a model asks it with the configuration's
attention_impl."""

import dataclasses
import sys

import pytest
import torch

from nerf_mae_torch import kernels
from nerf_mae_torch.config import SWIN_PRESETS, MAEConfig
from nerf_mae_torch.models.heads import VoxelSemantics3D
from nerf_mae_torch.models.mae import SwinMAE3D, init_weights
from nerf_mae_torch.models.swin import SwinBlock3D
from nerf_mae_torch.models.unetr import UnetResBlock3D


class _CudaTensor:
    """Stands in for a CUDA tensor: the rule reads only `is_cuda`."""
    is_cuda = True


class _Mesh:
    """Stands in for the mesh of a space axis."""
    space = 2


# (impl, on a space axis, a CUDA tensor): the kernel wanted
RULE = {
    ("auto", False, False): False, ("auto", False, True): True,
    ("auto", True, False): False, ("auto", True, True): False,
    ("kernel", False, False): True, ("kernel", False, True): True,
    ("kernel", True, False): False, ("kernel", True, True): False,
    ("plain", False, False): False, ("plain", False, True): False,
    ("plain", True, False): False, ("plain", True, True): False,
}


@pytest.mark.parametrize("impl,spatial,cuda", list(RULE))
def test_wanted(impl, spatial, cuda):
    """Never under "plain" or on a space axis, always under "kernel",
    under "auto" on a CUDA tensor."""
    x = _CudaTensor() if cuda else torch.zeros(2)
    assert kernels.wanted(x, impl, _Mesh() if spatial else None) is RULE[impl, spatial, cuda]


@pytest.mark.parametrize("impl", ["auto", "kernel", "plain"])
@pytest.mark.parametrize("kind", ["mae", "semantics"])
def test_every_block_asks_the_rule(monkeypatch, kind, impl):
    """A swin_nano MAE forward and a semantics forward: every Swin block and
    every res block asks kernels.wanted, with the configuration's impl and
    no space axis."""
    asked, rule = [], kernels.wanted

    def spy(x, impl, spatial=None):
        asked.append((sys._getframe(1).f_locals.get("self"), impl, spatial))
        return rule(x, impl, spatial)

    monkeypatch.setattr(kernels, "wanted", spy)
    swin = dataclasses.replace(SWIN_PRESETS["swin_nano"], attention_impl=impl)
    cfg = MAEConfig(swin=swin, resolution=32, compute_dtype="float32")
    model = (SwinMAE3D(cfg, device="cpu") if kind == "mae"
             else VoxelSemantics3D(cfg, 5, device="cpu"))
    init_weights(model, 0).eval()
    gen = torch.Generator().manual_seed(1)
    grids = torch.rand((1, 32, 32, 32, 4), generator=gen)
    with torch.no_grad():
        model(grids, generator=gen) if kind == "mae" else model(grids)
    blocks = [m for m in model.modules() if isinstance(m, (SwinBlock3D, UnetResBlock3D))]
    assert sum(isinstance(m, UnetResBlock3D) for m in blocks) >= 4
    assert {id(m) for m, _, _ in asked} == {id(m) for m in blocks}
    assert {(i, s) for _, i, s in asked} == {(impl, None)}
