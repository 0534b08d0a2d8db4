"""The residual block's fused norms (nerf_mae_torch/ops/res_norm.py) on the
CPU: the plain versions of norm_act / norm_add_act against the composition
the block used before them (the conv's bias add, instance_norm_3d, LeakyReLU,
the residual add), values and gradients in float32; UnetResBlock3D unchanged
on the CPU; on a space axis its plain norms with the mesh; the kernel
wrappers' checks and launch geometry. The kernels themselves are
compared with these plain versions on the card
(tests/test_torch_cuda_kernels.py)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nerf_mae_torch.models import unetr
from nerf_mae_torch.ops import res_norm


def _lrelu(x):
    return F.leaky_relu(x, negative_slope=0.01)


def _conv(in_ch, out_ch, k, seed):
    conv = unetr.Conv3d(in_ch, out_ch, k)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen) / (in_ch * k ** 3) ** 0.5)
        conv.bias.copy_(0.5 + torch.randn(conv.bias.shape, generator=gen))
    return conv


def _grads(out, cot, tensors):
    return torch.autograd.grad(out, tensors, cot, retain_graph=True, allow_unused=True)


CASES = [  # channels, grid (odd sizes), residual: None, "normed" or "raw"
    (48, (2, 5, 6, 7), None), (48, (1, 9, 7, 5), "normed"), (48, (2, 3, 5, 7), "raw"),
    (96, (2, 5, 6, 7), None), (96, (1, 7, 3, 5), "normed"), (96, (2, 5, 5, 3), "raw"),
    (128, (1, 5, 6, 7), None), (128, (2, 3, 3, 5), "normed"), (128, (1, 7, 5, 3), "raw"),
]


@pytest.mark.parametrize("c,grid,residual", CASES)
def test_plain_matches_composition(c, grid, residual):
    """The plain version equals the composition it replaced, bit for bit
    (the same float32 operations in the same order), values and gradients
    of the input, both biases, both weights and the raw residual; and the
    normalisation agrees with a float64 evaluation of its formula."""
    rs = np.random.RandomState(c + grid[1])
    x = torch.from_numpy(rs.randn(*grid, 4).astype(np.float32)).requires_grad_(True)
    conv_a, conv_r = _conv(4, c, 3, 1), _conv(4, c, 1, 2)
    raw = torch.from_numpy(rs.randn(*grid, c).astype(np.float32)).requires_grad_(True)
    cot = torch.from_numpy(rs.randn(*grid, c).astype(np.float32))
    f32 = torch.float32

    def composition():
        h = unetr.instance_norm_3d(conv_a(x, f32))
        if residual is None:
            return _lrelu(h)
        r = unetr.instance_norm_3d(conv_r(x, f32)) if residual == "normed" else raw
        return _lrelu(h + r)

    def fused():
        a = conv_a(x, f32, add_bias=False)
        if residual is None:
            return res_norm.norm_act_plain(a, conv_a.bias)
        if residual == "normed":
            return res_norm.norm_add_act_plain(a, conv_a.bias, conv_r(x, f32, add_bias=False),
                                               conv_r.bias)
        return res_norm.norm_add_act_plain(a, conv_a.bias, raw)

    wrt = [x, conv_a.weight, conv_a.bias, conv_r.weight, conv_r.bias, raw]
    want, got = composition(), fused()
    assert torch.equal(got, want)
    for g, w in zip(_grads(got, cot, wrt), _grads(want, cot, wrt)):
        assert (g is None and w is None) or torch.equal(g, w)

    def norm64(t):
        t = t.detach().double()
        mean = t.mean(dim=(1, 2, 3), keepdim=True)
        var = ((t - mean) ** 2).mean(dim=(1, 2, 3), keepdim=True)
        return (t - mean) / torch.sqrt(var + 1e-5)

    pre = norm64(conv_a(x, f32))
    if residual == "normed":
        pre = pre + norm64(conv_r(x, f32))
    elif residual == "raw":
        pre = pre + raw.detach().double()
    torch.testing.assert_close(got.detach().double(), _lrelu(pre), rtol=1e-5, atol=1e-5)


def _old_block_forward(block, x):
    """UnetResBlock3D.forward as it was before the fused norms."""
    norm = unetr.instance_norm_3d
    h = _lrelu(norm(block.conv1(x, block.dtype)))
    h = norm(block.conv2(h, block.dtype))
    residual = x if block.conv3 is None else norm(block.conv3(x, block.dtype))
    return _lrelu(h + residual)


@pytest.mark.parametrize("in_ch,out_ch,grid", [(4, 48, (2, 5, 6, 7)), (48, 48, (1, 7, 5, 3)),
                                               (256, 128, (2, 3, 5, 4))])
def test_res_block_unchanged_on_cpu(in_ch, out_ch, grid):
    """UnetResBlock3D on the CPU: output and every gradient equal to its
    forward before the fused norms (conv3 path and raw residual)."""
    block = unetr.UnetResBlock3D(in_ch, out_ch, dtype=torch.float32)
    gen = torch.Generator().manual_seed(in_ch + out_ch)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * (0.2 if p.dim() == 1 else 0.1))
    x = torch.randn(*grid, in_ch, generator=gen).requires_grad_(True)
    cot = torch.randn(*grid, out_ch, generator=gen)
    wrt = [x, *block.parameters()]
    got, want = block(x), _old_block_forward(block, x)
    assert torch.equal(got, want)
    for g, w in zip(_grads(got, cot, wrt), _grads(want, cot, wrt)):
        assert torch.equal(g, w)


class _OneRankMesh:
    """A space axis of one rank: what sp.halo and sp.all_reduce see."""
    space, space_rank, collectives = 1, 0, 0


def test_slab_path_keeps_the_slab_norm(monkeypatch):
    """With `spatial` set kernels.wanted says no, even under "kernel": the
    block's norms run the plain composition with the mesh, every instance
    norm through _InstanceNorm3d with the mesh, never the kernels'
    Function. On a one-rank axis it gives the one-process result, values
    and gradients."""
    calls, norms, inorm = [], [], res_norm._InstanceNorm3d

    class Spy(inorm):
        @staticmethod
        def forward(ctx, x, eps, mesh=None):
            calls.append((tuple(x.shape), mesh))
            return inorm.forward(ctx, x, eps, mesh)

    def refuse(*args, **kwargs):
        raise AssertionError("the slab path reached the fused norms' kernels")

    def spied(fn):
        def call(*args, **kwargs):
            norms.append((kwargs["kernel"], kwargs["mesh"]))
            return fn(*args, **kwargs)
        return call

    def halo(x, k, mesh):  # zeros beyond the global ends of axis 1
        return F.pad(x, (0, 0, 0, 0, 0, 0, k, k))

    monkeypatch.setattr(res_norm, "_InstanceNorm3d", Spy)
    monkeypatch.setattr(res_norm._ResNormAct, "apply", refuse)
    monkeypatch.setattr(unetr, "norm_act", spied(res_norm.norm_act))
    monkeypatch.setattr(unetr, "norm_add_act", spied(res_norm.norm_add_act))
    monkeypatch.setattr(unetr.sp, "halo", halo)
    monkeypatch.setattr(unetr.sp, "all_reduce", lambda t, mesh: t)
    block = unetr.UnetResBlock3D(4, 16, dtype=torch.float32, attention_impl="kernel")
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    x = torch.randn(2, 6, 6, 6, 4, generator=gen).requires_grad_(True)
    cot = torch.randn(2, 6, 6, 6, 16, generator=gen)
    wrt = [x, *block.parameters()]
    want = _old_block_forward(block, x)
    mesh = _OneRankMesh()
    for m in (block, block.conv1, block.conv2, block.conv3):
        m.spatial = mesh
    got = block(x)
    assert calls == [((2, 6, 6, 6, 16), mesh)] * 3
    assert norms == [(False, mesh)] * 2
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # the biases before a norm get rounding noise around 0 (they cancel in it)
    for g, w in zip(_grads(got, cot, wrt), _grads(want, cot, wrt)):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def test_kernel_entry_points_refuse_what_they_cannot_run():
    """The wrappers raise for a CPU tensor; norm_act / norm_add_act take the plain
    version only on the CPU and raise on any other device."""
    x = torch.zeros(1, 2, 2, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        res_norm.res_norm_stats([x])
    meta = torch.empty(1, 2, 2, 2, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        res_norm.norm_act(meta, torch.empty(8, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        res_norm.norm_add_act(meta, torch.empty(8, device="meta"), meta)
    with pytest.raises(ValueError, match="one or two"):
        res_norm._mode([x, x], x)
    for c, dtype in ((258, torch.bfloat16), (257, torch.float32), (1032, torch.bfloat16)):
        with pytest.raises(ValueError, match="unsupported shape"):
            res_norm.res_norm_stats([torch.empty(1, 2, 2, 2, c, dtype=dtype, device="meta")])
    with pytest.raises(ValueError, match="unsupported dtype"):
        res_norm.res_norm_stats([torch.empty(1, 2, 2, 2, 8, dtype=torch.float16)])
    assert [res_norm._mode(*a) for a in (([x], None), ([x, x], None), ([x], x))] == [0, 1, 2]


def test_gradient_layouts():
    """A channel slice of a concatenation's gradient is read in place
    (its voxel stride), any other layout is not."""
    whole = torch.zeros(2, 3, 4, 5, 96)
    like = torch.zeros(2, 3, 4, 5, 48)
    assert res_norm._grad_stride(whole[..., 48:], like) == 96
    assert res_norm._grad_stride(like, like) == 48
    assert res_norm._grad_stride(torch.zeros(2, 48, 3, 4, 5).permute(0, 2, 3, 4, 1), like) is None
    # a narrow C (one element a load): any channel offset and voxel stride
    narrow = torch.zeros(2, 3, 4, 5, 6, dtype=torch.bfloat16)
    assert res_norm._grad_stride(torch.zeros(2, 3, 4, 5, 18, dtype=torch.bfloat16)[..., 6:12],
                                 narrow) == 18
    # a wide C reads 16 bytes a load: a slice off that alignment is copied
    assert res_norm._grad_stride(torch.zeros(2, 3, 4, 5, 100)[..., 2:50], like) is None
    with pytest.raises(ValueError, match="does not match"):
        res_norm._grad_stride(like.double(), like)


@pytest.mark.parametrize("shape", [(8, 160, 160, 160, 48), (8, 40, 40, 40, 128),
                                   (8, 20, 20, 20, 256), (8, 10, 10, 10, 512),
                                   (1, 160, 160, 160, 48), (2, 7, 5, 3, 96),
                                   (8, 160, 160, 160, 6), (8, 40, 40, 40, 12),
                                   (2, 7, 5, 3, 250)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_launch_geometry(shape, dtype):
    """A thread loads 16 bytes where C allows, else one element; every
    thread row of a block gets a voxel, the tiles split a sample, and at
    the cells' shapes a launch has at least 4 x 132 blocks."""
    x = torch.empty(shape, dtype=dtype, device="meta")
    width = res_norm._width(x)
    assert width == (16 // x.element_size() if shape[-1] % (16 // x.element_size()) == 0 else 1)
    b, v, c, nblk = res_norm._dims(x)
    rows = res_norm._THREADS // (c // width)
    assert (b, c) == (shape[0], shape[-1]) and v == np.prod(shape[1:4])
    assert 1 <= nblk and v // nblk >= rows - 1 and b * nblk <= res_norm._BLOCKS + b
    if v >= 1000 and b == 8:
        assert b * nblk >= 4 * 132


@pytest.mark.parametrize("stride,k", [(1, 3), (1, 1), (2, 3), (2, 2)])
def test_conv_add_bias_false_leaves_the_bias_out(stride, k):
    """Conv3d(add_bias=False) is the convolution without its bias on every
    branch, strided too; its bias gets no gradient from it."""
    conv = _conv(4, 12, k, 3)
    x = torch.randn(2, 7, 6, 5, 4, generator=torch.Generator().manual_seed(k))
    with_bias = conv(x, torch.float32, stride=stride)
    without = conv(x, torch.float32, stride=stride, add_bias=False)
    torch.testing.assert_close(without + conv.bias, with_bias, rtol=0, atol=1e-6)
    assert torch.autograd.grad(without.sum(), conv.bias, allow_unused=True)[0] is None


def test_conv_add_bias_false_on_a_space_axis(monkeypatch):
    """On a space axis (one rank, the halo zeros beyond the grid's ends)
    add_bias=False leaves the bias out as off it."""
    monkeypatch.setattr(unetr.sp, "halo", lambda x, k, mesh: F.pad(x, (0, 0, 0, 0, 0, 0, k, k)))
    conv = _conv(4, 8, 3, 4)
    x = torch.randn(1, 5, 4, 3, 4, generator=torch.Generator().manual_seed(5))
    want = conv(x, torch.float32, add_bias=False)
    conv.spatial = _OneRankMesh()
    torch.testing.assert_close(conv(x, torch.float32, add_bias=False), want)
    torch.testing.assert_close(conv(x, torch.float32), want + conv.bias)


def _emulated_launches(monkeypatch):
    """Stand the four launches in with float64 PyTorch of what each kernel
    computes, and the launch shape without the device check, so that the
    autograd Function's wiring runs on the CPU."""
    dims = (1, 2, 3)
    e = lambda t: t[:, None, None, None, :]  # [B, C] over the voxels

    def xhat(x, st):  # st: one operand's [2, B, C]
        return (x.double() - e(st[0].double())) * e(st[1].double())

    def pre(s, x0, x1, st):
        p = xhat(x0, st[0])
        return p + xhat(x1, st[1]) if s.mode == 1 else (p + x1.double() if s.mode == 2 else p)

    def gp(s, g, x0, x1, st):
        return torch.where(pre(s, x0, x1, st) > 0, g.double(), 0.01 * g.double())

    def stats(s, x0, x1, eps):
        out = []
        for x in (x0, x1)[:s.n]:
            var, mean = torch.var_mean(x.double(), dim=dims, unbiased=False)
            out.append(torch.stack([mean, (var + eps).rsqrt()]))
        return torch.stack(out).float()

    def apply(s, x0, x1, st):
        return F.leaky_relu(pre(s, x0, x1, st), 0.01).to(x0.dtype)

    def bwd_reduce(s, g, gs, x0, x1, st):
        assert gs == g.stride(-2)
        q = gp(s, g, x0, x1, st)
        sums = [q.mean(dims), (q * xhat(x0, st[0])).mean(dims)]
        if s.mode == 1:
            sums.append((q * xhat(x1, st[1])).mean(dims))
        return torch.stack(sums, 1).float()

    def bwd_apply(s, g, gs, x0, x1, st, sums):
        q, m = gp(s, g, x0, x1, st), sums.double()
        dx0 = (e(st[0, 1].double()) * (q - e(m[:, 0]) - xhat(x0, st[0]) * e(m[:, 1])))
        dx1 = None
        if s.mode == 1:
            dx1 = e(st[1, 1].double()) * (q - e(m[:, 0]) - xhat(x1, st[1]) * e(m[:, 2]))
        elif s.mode == 2:
            dx1 = q
        normed = [dx0, dx1] if s.mode == 1 else [dx0]
        dbias = torch.stack([d.sum(dim=(0, 1, 2, 3)) for d in normed]).float()
        return dx0.to(x0.dtype), None if dx1 is None else dx1.to(x1.dtype), dbias

    monkeypatch.setattr(res_norm, "_shape", lambda name, xs, raw: res_norm._Shape(
        res_norm._mode(xs, raw), res_norm._DTYPES[xs[0].dtype], *res_norm._dims(xs[0])))
    for name, fn in (("stats", stats), ("apply", apply), ("bwd_reduce", bwd_reduce),
                     ("bwd_apply", bwd_apply)):
        monkeypatch.setattr(res_norm, f"_launch_{name}", fn)


@pytest.mark.parametrize("residual", [None, "normed", "raw"])
@pytest.mark.parametrize("sliced", [False, True])
def test_function_wiring_matches_plain(monkeypatch, residual, sliced):
    """The kernels' autograd Function with each launch emulated: operands,
    statistics and sums reach the launches in the right places, and the
    output and the gradients of a, bias, r and bias_r come back in order
    (the plain version's, to float32 rounding); a gradient that is a
    channel slice is read in place."""
    _emulated_launches(monkeypatch)
    gen = torch.Generator().manual_seed(11)
    shape = (2, 5, 4, 3, 16)
    a = (3.0 + 2.0 * torch.randn(shape, generator=gen)).requires_grad_(True)
    bias = torch.randn(16, generator=gen).requires_grad_(True)
    r = bias_r = None
    if residual is not None:
        r = torch.randn(shape, generator=gen).requires_grad_(True)
    if residual == "normed":
        bias_r = torch.randn(16, generator=gen).requires_grad_(True)
    g = torch.randn(2, 5, 4, 3, 32, generator=gen)[..., 8:24]
    g = g if sliced else g.contiguous()
    got = res_norm._ResNormAct.apply(a, bias, r, bias_r, res_norm.EPS)
    want = (res_norm.norm_act_plain(a, bias) if r is None
            else res_norm.norm_add_act_plain(a, bias, r, bias_r))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    wrt = [t for t in (a, bias, r, bias_r) if t is not None]
    for x, w in zip(torch.autograd.grad(got, wrt, g), torch.autograd.grad(want, wrt, g)):
        torch.testing.assert_close(x, w, rtol=1e-4, atol=1e-4)
