"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips where torch sees no CUDA device (the card
is looked for inside the fixture, never at import). Imports no JAX, so on
a machine without JAX it runs with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: bf16 kernel and plain version round at the same points and
differ only in float32 summation order (max error 4 bf16 ulps of the
largest output, relative L2 5e-3); float32 differs by summation order only
(relative L2 1e-5). The backward kernels' gradients: relative L2 1e-2 in
bf16 (a summation-order difference can move a float32 gradient across a
bf16 rounding boundary before it feeds the next product, and those flips
accumulate down the chain) and 1e-5 in float32.
"""

import math

import pytest
import torch

import dataclasses

from nerf_mae_torch.config import SWIN_PRESETS, MAEConfig, SwinConfig
from nerf_mae_torch.models.mae import SwinMAE3D, init_weights, mae_loss
from nerf_mae_torch.ops.fused_attention import (
    fused_window_attention,
    fused_window_attention_bwd,
    fused_window_attention_bwd_plain,
    fused_window_attention_plain,
)
from nerf_mae_torch.ops.fused_block import (
    fused_swin_block,
    fused_swin_block_bwd,
    fused_swin_block_bwd_plain,
    fused_swin_block_plain,
)

pytestmark = pytest.mark.cuda
WINDOW = (4, 4, 4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    got, want = got.float(), want.float()
    rel = ((got - want).norm() / want.norm()).item()
    if dtype == torch.bfloat16:
        scale = want.abs().max().item()
        ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)
        assert (got - want).abs().max().item() <= 4 * ulp
        assert rel <= 5e-3
    else:
        assert rel <= 1e-5


def _weights(c, heads, gen, dev):
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    return (1 + 0.1 * r(c), 0.1 * r(c), r(3 * c, c) / c ** 0.5, 0.1 * r(3 * c),
            r(c, c) / c ** 0.5, 0.1 * r(c), 1 + 0.1 * r(c), 0.1 * r(c),
            r(4 * c, c) / c ** 0.5, 0.1 * r(4 * c), r(c, 4 * c) / (2 * c ** 0.5),
            0.1 * r(c), r(343, heads))


CASES = [  # shape, heads, shift, dtype
    ((2, 8, 8, 8, 128), 4, (2, 2, 2), torch.bfloat16),
    ((2, 10, 10, 10, 64), 2, (2, 2, 2), torch.bfloat16),  # padded
    ((1, 12, 4, 4, 32), 2, (0, 0, 0), torch.bfloat16),    # odd window count
    ((1, 6, 6, 6, 32), 4, (2, 2, 2), torch.float32),
]


@pytest.mark.parametrize("shape,heads,shift,dtype", CASES)
def test_fused_block_kernel_matches_plain(dev, shape, heads, shift, dtype):
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    w = _weights(shape[-1], heads, gen, dev)
    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    keep = 1 + 0.25 * torch.rand((shape[0], 2), generator=gen, device=dev)
    before = fused_swin_block.launches
    got = fused_swin_block(x, *w, keep, WINDOW, shift, heads, 1e-5)
    torch.cuda.synchronize()
    assert fused_swin_block.launches == before + 1
    _close(got, fused_swin_block_plain(x, *w, keep, WINDOW, shift, heads, 1e-5), dtype)


@pytest.mark.parametrize("shape,heads,shift,dtype", CASES)
def test_fused_attention_kernel_matches_plain(dev, shape, heads, shift, dtype):
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    w = _weights(shape[-1], heads, gen, dev)
    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    args = (x, w[2], w[3], w[4], w[5], w[12], WINDOW, shift, heads)
    before = fused_window_attention.launches
    got = fused_window_attention(*args)
    torch.cuda.synchronize()
    assert fused_window_attention.launches == before + 1
    _close(got, fused_window_attention_plain(*args), dtype)


@pytest.mark.parametrize("gelu", ["tanh", "erf"])
def test_model_kernels_match_plain_composition(dev, gelu):
    """A small 4-stage model in bf16: every kernel stage runs, and the whole
    reconstruction agrees with the plain composition (relative L2 5e-2:
    bf16 rounding order across 8 blocks and the decoder)."""
    # C = 96..768: stages 0-2 run a kernel, stage 3 (C > 512) the plain path
    swin = dict(embed_dim=96, depths=(2, 2, 2, 2), num_heads=(3, 6, 12, 24), gelu=gelu)
    cfg = MAEConfig(swin=SwinConfig(**swin), resolution=64)
    plain_cfg = MAEConfig(swin=SwinConfig(**swin, attention_impl="plain"), resolution=64)
    model = init_weights(SwinMAE3D(cfg, device=dev), seed=0).eval()
    plain = SwinMAE3D(plain_cfg, device=dev).eval()
    plain.load_state_dict(model.state_dict())
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    grids = torch.rand((1, 64, 64, 64, 4), generator=gen, device=dev)
    counts = (fused_swin_block.launches, fused_window_attention.launches)
    with torch.inference_mode():
        pred, mask = model(grids, generator=gen)
        want, _ = plain(grids, token_mask=mask)
    launched = (fused_swin_block.launches - counts[0],
                fused_window_attention.launches - counts[1])
    assert launched == ((6, 0) if gelu == "tanh" else (0, 6))
    assert torch.isfinite(pred).all()
    assert ((pred - want).norm() / want.norm()).item() < 5e-2


def _grads_close(got, want, dtype):
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.float(), w.float()
        assert g.shape == w.shape, i
        assert torch.isfinite(g).all(), i
        rel = ((g - w).norm() / w.norm().clamp_min(1e-30)).item()
        assert rel <= (1e-2 if dtype == torch.bfloat16 else 1e-5), (i, rel)


@pytest.mark.parametrize("shape,heads,shift,dtype", CASES)
def test_fused_block_bwd_kernel_matches_plain(dev, shape, heads, shift, dtype):
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    w = _weights(shape[-1], heads, gen, dev)  # float32, as the model passes them
    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    dy = torch.randn(shape, generator=gen, device=dev).to(dtype)
    keep = torch.tensor([[1.25, 0.0], [0.0, 1.25]], device=dev)[: shape[0]]
    args = (x, *w, keep, dy, WINDOW, shift, heads, 1e-5)
    before = fused_swin_block_bwd.launches
    got = fused_swin_block_bwd(*args)
    torch.cuda.synchronize()
    assert fused_swin_block_bwd.launches == before + 1
    assert got[0].dtype == dtype and all(g.dtype == torch.float32 for g in got[1:])
    _grads_close(got, fused_swin_block_bwd_plain(*args), dtype)


@pytest.mark.parametrize("shape,heads,shift,dtype", CASES)
def test_fused_attention_bwd_kernel_matches_plain(dev, shape, heads, shift, dtype):
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    w = _weights(shape[-1], heads, gen, dev)
    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    dy = torch.randn(shape, generator=gen, device=dev).to(dtype)
    args = (x, w[2].to(dtype), w[3], w[4].to(dtype), w[12], dy, WINDOW, shift, heads)
    before = fused_window_attention_bwd.launches
    got = fused_window_attention_bwd(*args)
    torch.cuda.synchronize()
    assert fused_window_attention_bwd.launches == before + 1
    _grads_close(got, fused_window_attention_bwd_plain(*args), dtype)


@pytest.mark.parametrize("gelu", ["tanh", "erf"])
def test_every_parameter_gets_a_gradient(dev, gelu):
    """One training step of swin_b (full width, 64^3) through the kernels,
    stochastic depth off, some tokens masked: every parameter ends with a
    finite gradient that is not all zeros, and each of the 22 kernel blocks
    ran its forward and its backward kernel once."""
    swin = dataclasses.replace(SWIN_PRESETS["swin_b"], gelu=gelu,
                               stochastic_depth_prob=0.0)
    cfg = MAEConfig(swin=swin, resolution=64, remat=False, remat_stages=None)
    model = init_weights(SwinMAE3D(cfg, device=dev), seed=0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    grids = torch.rand((2, 64, 64, 64, 4), generator=gen, device=dev)
    sizes = torch.full((2, 3), 64, device=dev)
    fns = ((fused_swin_block, fused_swin_block_bwd) if gelu == "tanh"
           else (fused_window_attention, fused_window_attention_bwd))
    before = [f.launches for f in fns]
    pred, mask = model(grids, deterministic=False, generator=gen, patched_pred=True)
    assert mask.any() and not mask.all()
    loss, _ = mae_loss(pred, grids, mask, sizes, cfg)
    loss.backward()
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(fns, before)] == [22, 22]
    for name, prm in model.named_parameters():
        assert prm.grad is not None, name
        assert torch.isfinite(prm.grad).all(), name
        assert prm.grad.abs().max() > 0, name
