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

import ctypes
import dataclasses
import math

import pytest
import torch
import torch.nn.functional as F

from nerf_mae_torch import kernels

from nerf_mae_torch.config import SWIN_PRESETS, MAEConfig, SwinConfig, TrainConfig
from nerf_mae_torch.models.mae import SwinMAE3D, init_weights, mae_loss
from nerf_mae_torch.models.unetr import UnetResBlock3D
from nerf_mae_torch.ops.fused_attention import (
    fused_window_attention,
    fused_window_attention_bwd,
    fused_window_attention_bwd_plain,
    fused_window_attention_plain,
)
from nerf_mae_torch.ops.fused_block import (
    FusedSwinBlockFn,
    fused_swin_block,
    fused_swin_block_bwd,
    fused_swin_block_bwd_plain,
    fused_swin_block_plain,
    row_views,
)
from nerf_mae_torch.ops import res_norm
from nerf_mae_torch.train.head_trainer import VoxelSemanticsTrainer
from nerf_mae_torch.train.trainer import MAETrainer

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


def _weights(c, heads, gen, dev, window=WINDOW):
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    table = math.prod(2 * w - 1 for w in window)
    return (1 + 0.1 * r(c), 0.1 * r(c), r(3 * c, c) / c ** 0.5, 0.1 * r(3 * c),
            r(c, c) / c ** 0.5, 0.1 * r(c), 1 + 0.1 * r(c), 0.1 * r(c),
            r(4 * c, c) / c ** 0.5, 0.1 * r(4 * c), r(c, 4 * c) / (2 * c ** 0.5),
            0.1 * r(c), r(table, heads))


CASES = [  # shape, heads, shift, dtype
    ((2, 8, 8, 8, 128), 4, (2, 2, 2), torch.bfloat16),
    ((2, 10, 10, 10, 64), 2, (2, 2, 2), torch.bfloat16),  # padded
    ((1, 12, 4, 4, 32), 2, (0, 0, 0), torch.bfloat16),    # odd window count
    ((1, 6, 6, 6, 32), 4, (2, 2, 2), torch.float32),
    # rows not a multiple of the 128-row GEMM tile, 3C = 288 not a multiple
    # of the 128-column tile, padded and shifted
    ((1, 9, 7, 5, 96), 3, (2, 2, 2), torch.bfloat16),
    ((1, 10, 10, 10, 512), 16, (2, 2, 2), torch.bfloat16),  # stage 2, padded
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


# the swin_b stages' widths and heads on small grids, stage 2's 10^3
# padded to 12^3, each with and without the shift
KEEP_CASES = [  # shape, heads, shift
    ((2, 8, 8, 8, 128), 4, (0, 0, 0)),
    ((2, 8, 8, 8, 128), 4, (2, 2, 2)),
    ((2, 8, 8, 8, 256), 8, (0, 0, 0)),
    ((2, 8, 8, 8, 256), 8, (2, 2, 2)),
    ((2, 10, 10, 10, 512), 16, (0, 0, 0)),
    ((2, 10, 10, 10, 512), 16, (2, 2, 2)),
]


@pytest.mark.parametrize("shape,heads,shift", KEEP_CASES)
def test_function_keeps_rows_and_matches_plain(dev, shape, heads, shift):
    """FusedSwinBlockFn under autograd, bf16, stochastic-depth keep factors
    with a dropped branch of each kind: the kept row sets match the plain
    forward's at the forward tolerance; the forward keeps its rows once,
    the backward kernel runs once from them, dx and the 13 gradients match
    the plain backward at the backward tolerance and equal the standalone
    backward's bitwise, and a second run gives bitwise equal outputs and
    gradients. Under no_grad nothing is kept and the output is bitwise the
    keeping forward's."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    c = shape[-1]
    w = _weights(c, heads, gen, dev)  # float32, as the model passes them
    x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    dy = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    keep = torch.tensor([[1 / 0.9, 0.0], [0.0, 1 / 0.9]], device=dev)
    static = (WINDOW, shift, heads, 1e-5)
    m = shape[0] * math.prod(-(-g // 4) * 4 for g in shape[1:4])  # padded rows
    got_out, rows = fused_swin_block(x, *w, keep, *static, keep_rows=True)
    want_out, want_rows = fused_swin_block_plain(x, *w, keep, *static, keep_rows=True)
    assert rows.shape == want_rows.shape and rows.dtype == torch.bfloat16
    _close(got_out, want_out, torch.bfloat16)
    for got, want in zip(row_views(rows, m, c, 4 * c), row_views(want_rows, m, c, 4 * c)):
        _close(got, want, torch.bfloat16)

    def train_call():
        leaves = [t.clone().requires_grad_() for t in (x, *w)]
        before = (fused_swin_block.kept, fused_swin_block.kept_bytes,
                  fused_swin_block_bwd.launches)
        out = FusedSwinBlockFn.apply(*leaves, keep, *static)
        out.backward(dy)
        torch.cuda.synchronize()
        assert (fused_swin_block.kept - before[0], fused_swin_block.kept_bytes - before[1],
                fused_swin_block_bwd.launches - before[2]) == (1, rows.numel() * 2, 1)
        return out.detach(), [t.grad for t in leaves]

    out, grads = train_call()
    out2, grads2 = train_call()
    assert torch.equal(out, out2)
    for i, (a, b) in enumerate(zip(grads, grads2)):
        assert torch.equal(a, b), i
    standalone = fused_swin_block_bwd(x, *w, keep, dy, *static)
    for i, (a, b) in enumerate(zip(grads, standalone)):
        assert torch.equal(a, b), i
    _grads_close(grads, fused_swin_block_bwd_plain(x, *w, keep, dy, *static), torch.bfloat16)
    assert torch.equal(out, got_out)
    kept = fused_swin_block.kept
    with torch.no_grad():
        served = FusedSwinBlockFn.apply(x, *w, keep, *static)
    torch.cuda.synchronize()
    assert fused_swin_block.kept == kept
    assert torch.equal(served, out)


def test_fused_block_bwd_kernel_is_bitwise_repeatable(dev):
    """Two backward calls on the same inputs give bitwise equal dx and
    gradients: every cross-CTA sum is a fixed-order sum of partials."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    shape, heads = (2, 10, 10, 10, 128), 4
    w = _weights(shape[-1], heads, gen, dev)
    x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    dy = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    keep = torch.tensor([[1.25, 0.0], [0.0, 1.25]], device=dev)
    args = (x, *w, keep, dy, WINDOW, (2, 2, 2), heads, 1e-5)
    first = fused_swin_block_bwd(*args)
    second = fused_swin_block_bwd(*args)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(first, second)):
        assert torch.equal(a, b), i


# bf16 shapes off the swin_b path, each through both kernels forward and
# backward: 128-token windows and heads of 64 and 128 (the general attention
# kernels, or the 64-token kernels at their widest), and a head dim that is
# not a multiple of 8 (element-wise staging of q, k, v and do)
OTHER_CASES = [  # shape, heads, window, shift
    ((1, 8, 8, 12, 64), 2, (4, 4, 8), (2, 2, 4)),     # N = 128, hd 32, padded
    ((1, 8, 8, 8, 256), 4, (4, 4, 8), (0, 0, 0)),     # N = 128, hd 64
    ((1, 8, 8, 8, 256), 4, (4, 4, 4), (2, 2, 2)),     # N = 64, hd 64
    ((1, 8, 8, 8, 512), 4, (4, 4, 4), (2, 2, 2)),     # N = 64, hd 128
    ((1, 6, 6, 6, 48), 4, (4, 4, 4), (2, 2, 2)),      # hd 12, padded
    ((1, 6, 6, 10, 48), 4, (4, 4, 8), (2, 2, 4)),     # N = 128, hd 12, padded
]


def _other_inputs(dev, shape, heads, window, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    w = _weights(shape[-1], heads, gen, dev, window)
    x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    dy = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    return w, x, dy


@pytest.mark.parametrize("shape,heads,window,shift", OTHER_CASES)
def test_kernels_match_plain_at_other_shapes(dev, shape, heads, window, shift):
    w, x, dy = _other_inputs(dev, shape, heads, window, 7)
    keep = torch.tensor([[1.25, 0.75]], device=dev)
    blk = (x, *w, keep, window, shift, heads, 1e-5)
    _close(fused_swin_block(*blk), fused_swin_block_plain(*blk), torch.bfloat16)
    attn = (x, w[2], w[3], w[4], w[5], w[12], window, shift, heads)
    _close(fused_window_attention(*attn), fused_window_attention_plain(*attn), torch.bfloat16)
    blk_b = (x, *w, keep, dy, window, shift, heads, 1e-5)
    _grads_close(fused_swin_block_bwd(*blk_b), fused_swin_block_bwd_plain(*blk_b),
                 torch.bfloat16)
    attn_b = (x, w[2].to(x.dtype), w[3], w[4].to(x.dtype), w[12], dy, window, shift, heads)
    _grads_close(fused_window_attention_bwd(*attn_b),
                 fused_window_attention_bwd_plain(*attn_b), torch.bfloat16)


@pytest.mark.parametrize("shape,heads,window,shift", OTHER_CASES)
def test_backward_kernels_are_bitwise_repeatable_at_other_shapes(dev, shape, heads, window,
                                                                 shift):
    w, x, dy = _other_inputs(dev, shape, heads, window, 8)
    keep = torch.tensor([[1.25, 0.75]], device=dev)
    blk_b = (x, *w, keep, dy, window, shift, heads, 1e-5)
    attn_b = (x, w[2].to(x.dtype), w[3], w[4].to(x.dtype), w[12], dy, window, shift, heads)
    for fn, args in ((fused_swin_block_bwd, blk_b), (fused_window_attention_bwd, attn_b)):
        first, second = fn(*args), fn(*args)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(first, second)):
            assert torch.equal(a, b), (fn.__name__, i)


GEMM_CASES = [  # form, M, N, K: ragged against the 128 x 128 x 64 tiles
    (0, 200, 136, 72),    # A W^T
    (1, 200, 136, 72),    # A W
    (2, 136, 96, 1000),   # A^T B, the sum over K rows
    (2, 32, 64, 13824),   # one narrow tile, many rows
]


@pytest.mark.parametrize("form,m,n,k", GEMM_CASES)
def test_gemm_core_matches_matmul(dev, form, m, n, k):
    """The TMA + wgmma product in each of its three forms against a float32
    matmul of the same bf16 values: bf16 products are exact in float32, so
    only the summation order differs, whose rounding grows as the square
    root of the sum's length (relative L2 max(1e-5, 4e-7 sqrt(K)))."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    r = lambda *s: torch.randn(*s, generator=gen, device=dev).to(torch.bfloat16)
    a = r(k, m) if form == 2 else r(m, k)
    b = r(n, k) if form == 0 else r(k, n)
    want = {0: lambda: a.float() @ b.float().t(), 1: lambda: a.float() @ b.float(),
            2: lambda: a.float().t() @ b.float()}[form]()
    out = torch.empty((m, n), device=dev)
    fn = kernels.load("fused_block_bwd").gemm_core_for_tests
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_longlong] + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    kernels.check(fn(form, m, n, k, a.data_ptr(), b.data_ptr(), out.data_ptr(), stream),
                  "gemm_core_for_tests")
    torch.cuda.synchronize()
    assert ((out - want).norm() / want.norm()).item() <= max(1e-5, 4e-7 * math.sqrt(k))


# The residual block's fused instance norm + LeakyReLU (csrc/res_norm.cu):
# semantics' full-resolution tensor (one sample of sem_s160's eight), the MAE
# decoders' (batch 8), an odd grid. The plain version rounds to bf16 after
# the bias add (~2e-3 RMS in normalised units), each norm, the sum and the
# LeakyReLU (~1e-3 each) where the kernel rounds once. Tolerances: forward,
# 4 bf16 ulps of the largest output and relative L2 1e-2 against the plain
# version, and never further from a float64 evaluation than the plain
# version. Backward: relative L2 1e-2 against the float64 evaluation (one
# rounding to bf16), and 1e-2 against the plain version at the voxels more
# than 0.05 from the LeakyReLU's kink (~97% of them): within its rounding
# of the pre-activation the plain version can take the other slope, a 100x
# change of that voxel's gradient. A bias's gradient is the
# sum of its operand's gradient as the kernel wrote it: within float32
# summation order (1e-5 of the sum of magnitudes) of that sum, and, as the
# norm makes it zero but for rounding, under 1e-2 of the sum of magnitudes.
RES_NORM_SHAPES = [(1, 160, 160, 160, 48), (8, 40, 40, 40, 128), (8, 20, 20, 20, 256),
                   (8, 10, 10, 10, 512), (2, 9, 7, 5, 48),
                   # a small preset's res blocks (swin_nano: 6 and 12 channels),
                   # one element a load
                   (2, 32, 32, 32, 6), (2, 17, 9, 13, 12)]


def _res_norm_inputs(shape, residual, dtype, dev, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    c = shape[-1]
    a = (3.0 + 2.0 * r(*shape)).to(dtype)  # an offset mean, as a conv's output has
    bias = r(c)
    res = bias_r = None
    if residual == "normed":
        res, bias_r = (-1.0 + 0.5 * r(*shape)).to(dtype), r(c)
    elif residual == "raw":
        res = r(*shape).to(dtype)
    return a, bias, res, bias_r, r(*shape).to(dtype)


def _res_norm_run(fns, a, bias, res, bias_r, g):
    """Output and gradients of (a, bias, res, bias_r) of norm_act or
    norm_add_act (fns: the two), each input a fresh leaf."""
    leaves = [None if t is None else t.detach().clone().requires_grad_(True)
              for t in (a, bias, res, bias_r)]
    out = (fns[0](*leaves[:2]) if res is None else fns[1](*leaves))
    out.backward(g)
    return out.detach(), [None if t is None else t.grad for t in leaves]


def _norm64(t):
    mean = t.mean(dim=(1, 2, 3), keepdim=True)
    return (t - mean) / torch.sqrt(((t - mean) ** 2).mean(dim=(1, 2, 3), keepdim=True) + 1e-5)


def _res_norm_exact(a, bias, res, bias_r, g):
    """(pre-activation, output, gradients of a and res) in float64."""
    a64 = a.double().requires_grad_(True)
    pre = _norm64(a64 + bias.double())
    r64 = None
    if res is not None:
        r64 = res.double().requires_grad_(True)
        pre = pre + (_norm64(r64 + bias_r.double()) if bias_r is not None else r64)
    out = F.leaky_relu(pre, 0.01)
    grads = torch.autograd.grad(out, [t for t in (a64, r64) if t is not None], g.double())
    return pre.detach(), out.detach(), list(grads) + [None] * (2 - len(grads))


def _rel(t, want, mask=None):
    """Relative L2 distance of t from want (float64), over mask."""
    d = t.double() - want
    if mask is not None:
        d, want = d[mask], want[mask]
    return (d.norm() / want.norm()).item()


def _res_norm_counts():
    return [k.launches for k in res_norm.KERNELS]


@pytest.mark.parametrize("residual", [None, "normed", "raw"])
@pytest.mark.parametrize("shape", RES_NORM_SHAPES)
def test_res_norm_kernels_match_plain(dev, shape, residual):
    bf = torch.bfloat16
    a, bias, res, bias_r, g = _res_norm_inputs(shape, residual, bf, dev, 7)
    before = _res_norm_counts()
    got, dgot = _res_norm_run((res_norm.norm_act, res_norm.norm_add_act), a, bias, res, bias_r, g)
    torch.cuda.synchronize()
    assert [n - b for n, b in zip(_res_norm_counts(), before)] == [1, 1, 1, 1]
    want, dwant = _res_norm_run((res_norm.norm_act_plain, res_norm.norm_add_act_plain),
                                a, bias, res, bias_r, g)
    assert got.dtype == bf and got.is_contiguous()
    ulp = 2.0 ** (math.floor(math.log2(want.float().abs().max().item())) - 7)
    assert (got.float() - want.float()).abs().max().item() <= 4 * ulp
    pre, exact, dexact = _res_norm_exact(a, bias, res, bias_r, g)
    assert _rel(got, want.double()) <= 1e-2
    assert _rel(got, exact) <= _rel(want, exact)
    away = pre.abs() > 0.05
    for i, d64 in ((0, dexact[0]), (2, dexact[1])):  # a, and the residual
        if dwant[i] is not None:
            assert _rel(dgot[i], d64) <= 1e-2
            assert _rel(dgot[i], dwant[i].double(), away) <= 1e-2
    del pre, exact, dexact, away
    for i, op in ((1, 0), (3, 2)):  # each bias against its operand's gradient
        if dgot[i] is None:
            continue
        assert dgot[i].dtype == torch.float32
        dx = dgot[op].float()
        mag = dx.abs().sum(dim=(0, 1, 2, 3))
        assert ((dgot[i] - dx.sum(dim=(0, 1, 2, 3))).abs() <= 1e-5 * mag).all()
        assert (dgot[i].abs() <= 1e-2 * mag).all() and (dwant[i].abs() <= 1e-2 * mag).all()


@pytest.mark.parametrize("residual", [None, "normed", "raw"])
@pytest.mark.parametrize("shape", [(2, 9, 7, 5, 48), (2, 20, 20, 20, 64), (2, 9, 7, 5, 6),
                                   (2, 20, 20, 20, 12)])
def test_res_norm_kernels_float32(dev, shape, residual):
    """float32: kernel and plain version differ by summation order only
    (relative L2 1e-5 forward; 1e-4 backward, whose mean subtractions
    cancel, at the voxels more than 1e-4 from the LeakyReLU's kink, where
    the two pre-activations, ~1e-6 apart, cannot take different slopes)."""
    args = _res_norm_inputs(shape, residual, torch.float32, dev, 8)
    got, dgot = _res_norm_run((res_norm.norm_act, res_norm.norm_add_act), *args)
    want, dwant = _res_norm_run((res_norm.norm_act_plain, res_norm.norm_add_act_plain), *args)
    _close(got, want, torch.float32)
    away = _res_norm_exact(*args)[0].abs() > 1e-4
    for x, w in zip(dgot, dwant):
        if w is not None and w.dim() > 1:
            assert _rel(x, w.double(), away) <= 1e-4


def test_res_norm_backward_is_bitwise_repeatable_and_reads_a_channel_slice(dev):
    """No atomics: the same gradients bit for bit every run; a gradient that
    is a channel slice of a wider tensor (a concatenation's) is read in
    place and gives the bits of its contiguous copy."""
    a, bias, res, bias_r, g = _res_norm_inputs((8, 40, 40, 40, 128), "normed", torch.bfloat16,
                                               dev, 9)
    wide = torch.cat([g, g], dim=-1)[..., 128:]
    assert not wide.is_contiguous() and res_norm._grad_stride(wide, a) == 256
    runs = [_res_norm_run((res_norm.norm_act, res_norm.norm_add_act), a, bias, res, bias_r, gg)
            for gg in (g, g, wide)]
    for out, grads in runs[1:]:
        assert torch.equal(out, runs[0][0])
        assert all(torch.equal(x, y) for x, y in zip(grads, runs[0][1]))


@pytest.mark.parametrize("kind,preset,res", [("semantics", "swin_s", 160), ("mae", "swin_b", 160),
                                             ("semantics", "swin_nano", 32),
                                             ("mae", "swin_nano", 32)])
def test_training_steps_launch_the_res_norm_kernels(dev, kind, preset, res):
    """One train step of the semantics head (swin_s, 160^3, batch 2: encoder1
    and decoder1 at full resolution) and of the MAE (swin_b, 160^3, batch 2),
    and both at swin_nano (res blocks of 6 to 96 channels): every residual
    block's two norms go through the kernels, twice where remat recomputes
    them, and each backward once; the loss is finite."""
    cfg = MAEConfig(swin=SWIN_PRESETS[preset], resolution=res)
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    grids = torch.rand((2, res, res, res, 4), generator=gen, device=dev)
    if kind == "semantics":
        trainer = VoxelSemanticsTrainer(cfg, TrainConfig(), 10, dev, num_classes=19)
        batch = {"grids": grids, "semantics": torch.randint(0, 19, (2, res, res, res),
                                                            generator=gen, device=dev)}
    else:
        trainer = MAETrainer(cfg, TrainConfig(), 10, dev)
        batch = {"grids": grids, "sizes": torch.full((2, 3), res, device=dev)}
    state = trainer.init(0)
    blocks = sum(isinstance(m, UnetResBlock3D) for m in state.model.modules())
    before = _res_norm_counts()
    _, metrics = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    stats, apply, reduce, bwd = [n - b for n, b in zip(_res_norm_counts(), before)]
    assert blocks >= 4 and reduce == bwd == 2 * blocks
    assert stats == apply and 2 * blocks <= stats <= 4 * blocks
    assert math.isfinite(float(metrics["loss"]))


@pytest.mark.parametrize("impl", ["plain", "auto"])
def test_plain_launches_no_kernel(dev, impl):
    """One MAE train step (swin_b, 64^3, batch 2). Under "plain" every layer
    takes the plain composition (kernels.wanted): no fused-block and no
    fused-norm launch. Under "auto" the fused block's 22 forward and 22
    backward launches (stages 0-2) and the fused norms' launches that
    chip_smoke.check_res_norm_launches checks."""
    import chip_smoke

    swin = dataclasses.replace(SWIN_PRESETS["swin_b"], attention_impl=impl)
    trainer = MAETrainer(MAEConfig(swin=swin, resolution=64), TrainConfig(), 10, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    batch = {"grids": torch.rand((2, 64, 64, 64, 4), generator=gen, device=dev),
             "sizes": torch.full((2, 3), 64, device=dev)}
    state = trainer.init(0)
    blocks = sum(isinstance(m, UnetResBlock3D) for m in state.model.modules())
    chip_smoke.reset_launches()
    _, metrics = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    launches = chip_smoke.read_launches()
    if impl == "plain":
        assert set(launches.values()) == {0}, launches
    else:
        assert (launches["block"], launches["block_bwd"]) == (22, 22), launches
        chip_smoke.check_res_norm_launches("auto", launches, blocks, 1)
    assert math.isfinite(float(metrics["loss"]))
