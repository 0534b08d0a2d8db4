"""Instance norm + LeakyReLU of the UNETR residual block (models/unetr.py
UnetResBlock3D), fused:

    norm_act(a, bias)                   = lrelu(IN(a + bias))
    norm_add_act(a, bias, r, bias_r)    = lrelu(IN(a + bias) + IN(r + bias_r))
    norm_add_act(a, bias, r)            = lrelu(IN(a + bias) + r)

a and r are NDHWC convolution outputs without their bias, IN the
per-(sample, channel) instance norm over the voxels (population variance,
eps 1e-5, no affine), lrelu LeakyReLU with slope 0.01.

Where the caller's `kernel` is False (kernels.wanted: attention_impl
"plain", or a space axis) or on a CPU tensor: the plain version, the
composition the block used before the kernels (the bias add in the
tensor's dtype, `_InstanceNorm3d`, `lrelu`, the add), whose instance norm
sums its statistics over the space group of `mesh` on a space axis.
Otherwise: `csrc/res_norm.cu` through one autograd Function,
whose forward keeps for the backward only its inputs (in their dtype) and
the [operands, 2, B, C] float32 statistics; no fallback. The kernels read
each operand the fewest times: a statistics pass, an apply pass, and in
the backward a reduce pass and an apply pass that writes every input
gradient and the sums that are the biases' gradients. Each entry point
counts its launches in `.launches`.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from nerf_mae_torch import kernels
from nerf_mae_torch.parallel import spatial as sp

EPS = 1e-5
SLOPE = 0.01


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=SLOPE)


class _InstanceNorm3d(torch.autograd.Function):
    """Instance norm that keeps for its backward only its input and the
    per-(sample, channel) statistics, and makes its float32 temporaries a
    few samples at a time (at most CHUNK elements, at least one sample): at
    a full-resolution grid (160^3, 48 channels, batch 8: 3.1 GB in bf16)
    autograd's own graph would keep two float32 copies of the input and
    make three more at once; the token-grid decoders take the whole batch
    in one chunk. On a space axis (`mesh`) x is a slab: the per-(sample,
    channel) sums of x, then of (x - mean)^2, are summed over the space
    group before dividing by the global voxel count, and so are the
    backward's sums of g and g * xhat."""

    CHUNK = 1 << 28

    @staticmethod
    def _chunks(x):
        n = max(1, _InstanceNorm3d.CHUNK // max(x[0].numel(), 1))
        return [slice(s, s + n) for s in range(0, x.shape[0], n)]

    @staticmethod
    def _sums(x, fn):
        """[B, 1, 1, 1, C] float32: fn(chunk) summed over the voxels."""
        out = torch.zeros((x.shape[0], 1, 1, 1, x.shape[-1]), dtype=torch.float32,
                          device=x.device)
        for b in _InstanceNorm3d._chunks(x):
            out[b] = fn(b).sum(dim=(1, 2, 3), keepdim=True)
        return out

    @staticmethod
    def forward(ctx, x, eps, mesh=None):
        sums = _InstanceNorm3d._sums
        if mesh is None:
            stats = torch.empty((2, x.shape[0], 1, 1, 1, x.shape[-1]),
                                dtype=torch.float32, device=x.device)
        else:
            ctx.n = sp.grid_len(x) * x.shape[2] * x.shape[3]
            mean = sp.all_reduce(sums(x, lambda b: x[b].float()), mesh) / ctx.n
            var = sp.all_reduce(sums(x, lambda b: (x[b].float() - mean[b]) ** 2), mesh) / ctx.n
            stats = torch.stack([mean, torch.rsqrt(var + eps)])
        out = torch.empty_like(x)
        for b in _InstanceNorm3d._chunks(x):
            x32 = x[b].float()
            if mesh is None:
                var, mean = torch.var_mean(x32, dim=(1, 2, 3), keepdim=True, unbiased=False)
                stats[0, b], stats[1, b] = mean, torch.rsqrt(var + eps)
            out[b] = (x32 - stats[0, b]) * stats[1, b]
        ctx.save_for_backward(x, stats)
        ctx.mesh = mesh
        return out

    @staticmethod
    def backward(ctx, g):
        x, stats = ctx.saved_tensors
        xhat = lambda b: (x[b].float() - stats[0, b]) * stats[1, b]
        if ctx.mesh is not None:
            sums = _InstanceNorm3d._sums
            gm, gxm = sp.all_reduce(torch.stack([
                sums(g, lambda b: g[b].float()),
                sums(g, lambda b: g[b].float() * xhat(b))]), ctx.mesh) / ctx.n
        dx = torch.empty_like(x)
        for b in _InstanceNorm3d._chunks(x):
            g32, xh = g[b].float(), xhat(b)
            if ctx.mesh is None:
                means = (g32.mean(dim=(1, 2, 3), keepdim=True),
                         (g32 * xh).mean(dim=(1, 2, 3), keepdim=True))
            else:
                means = gm[b], gxm[b]
            dx[b] = stats[1, b] * (g32 - means[0] - xh * means[1])
        return dx, None, None


def norm_act_plain(a, bias, eps: float = EPS, mesh=None):
    return lrelu(_InstanceNorm3d.apply(a + bias.to(a.dtype), eps, mesh))


def norm_add_act_plain(a, bias, r, bias_r=None, eps: float = EPS, mesh=None):
    h = _InstanceNorm3d.apply(a + bias.to(a.dtype), eps, mesh)
    if bias_r is not None:
        r = _InstanceNorm3d.apply(r + bias_r.to(r.dtype), eps, mesh)
    return lrelu(h + r)


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 256         # csrc/res_norm.cu kThreads: a block's threads, at most
_BLOCKS = 16 * 132     # blocks a launch aims at: 16 on each of the H100's 132 SMs
MAX_CHANNELS = 1024


def _lib(name: str, argtypes):
    fn = getattr(kernels.load("res_norm"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = _I
    return fn


def _width(x: torch.Tensor) -> int:
    """Channels a thread loads at once (csrc/res_norm.cu's N): 16 bytes'
    worth where C is a multiple of it, else one."""
    n = 16 // x.element_size()
    return n if x.shape[-1] % n == 0 else 1


def _dims(x: torch.Tensor) -> Tuple[int, int, int, int]:
    """(B, voxels, C, tiles a sample): the tiles give every row of a
    block's threads a voxel and the launch about _BLOCKS blocks."""
    b, c = x.shape[0], x.shape[-1]
    v = x[0, ..., 0].numel()
    rows = max(1, _THREADS // (c // _width(x)))
    return b, v, c, max(1, min(-(-_BLOCKS // b), -(-v // rows)))


def _mode(xs: Sequence[torch.Tensor], raw: Optional[torch.Tensor]) -> int:
    """0: one normalised operand; 1: two; 2: one and a raw residual."""
    if len(xs) == 2 and raw is None:
        return 1
    if len(xs) == 1:
        return 0 if raw is None else 2
    raise ValueError("res_norm: one or two normalised operands, and a raw residual "
                     "only beside one")


class _Shape(NamedTuple):
    """What a launch needs besides the pointers; x1 is the second
    normalised operand (mode 1), the raw residual (mode 2) or x0 (mode 0)."""
    mode: int
    dtype: int
    b: int
    v: int
    c: int
    nblk: int

    @property
    def n(self) -> int:  # normalised operands
        return 2 if self.mode == 1 else 1

    @property
    def k(self) -> int:  # per-channel means of the backward's reduce
        return 3 if self.mode == 1 else 2


def _shape(name: str, xs: Sequence[torch.Tensor], raw: Optional[torch.Tensor]) -> _Shape:
    """The launch shape of xs (and raw); raises unless they are same-shaped,
    contiguous, 16-byte aligned CUDA tensors of one kernel dtype whose C
    the kernels take: a multiple of 16 bytes up to MAX_CHANNELS, any other
    up to _THREADS."""
    mode = _mode(xs, raw)
    x = xs[0]
    if x.dtype not in _DTYPES:
        raise ValueError(f"{name}: unsupported dtype {x.dtype}")
    c = x.shape[-1]
    if x.dim() < 3 or c > MAX_CHANNELS or c // _width(x) > _THREADS:
        raise ValueError(f"{name}: unsupported shape {tuple(x.shape)} (channels last, "
                         f"C <= {MAX_CHANNELS}, C <= {_THREADS} unless C * "
                         f"{x.element_size()} bytes is a multiple of 16)")
    if x.device.type != "cuda":
        raise ValueError(f"{name}: needs a CUDA tensor, got {x.device}")
    for t in (*xs, raw):
        if t is None:
            continue
        if t.device != x.device or t.dtype != x.dtype or t.shape != x.shape:
            raise ValueError(f"{name}: operands differ: {t.device} {t.dtype} "
                             f"{tuple(t.shape)} against {x.device} {x.dtype} {tuple(x.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be contiguous and 16-byte aligned")
    return _Shape(mode, _DTYPES[x.dtype], *_dims(x))


def _check_f32(name: str, t: torch.Tensor, shape, like: torch.Tensor) -> None:
    if t.dtype != torch.float32 or t.device != like.device or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous float32 {shape} on {like.device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _grad_stride(g: torch.Tensor, like: torch.Tensor) -> Optional[int]:
    """g's elements between neighbouring voxels where g is `like`-shaped
    with unit channel stride and one voxel stride (a channel slice of a
    contiguous tensor, as a concatenation's gradient gives) that the
    kernels' loads can read, else None."""
    if g.shape != like.shape or g.dtype != like.dtype or g.device != like.device:
        raise ValueError(f"res_norm: gradient {g.dtype} {tuple(g.shape)} does not match "
                         f"{like.dtype} {tuple(like.shape)}")
    gs = g.stride(-2)
    want = [gs]
    for n in reversed(g.shape[1:-1]):
        want.insert(0, want[0] * n)
    w = _width(like)
    if g.stride(-1) != 1 or list(g.stride()[:-1]) != want or g.data_ptr() % (
            w * g.element_size()) or gs % w:
        return None
    return gs


def _stride_or_raise(g: torch.Tensor, like: torch.Tensor) -> int:
    gs = _grad_stride(g, like)
    if gs is None:
        raise ValueError(f"res_norm: gradient strides {g.stride()} are not a channel slice")
    return gs


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch_stats(s: _Shape, x0, x1, eps: float) -> torch.Tensor:
    part = torch.empty(s.n * s.b * s.nblk * (2 * s.c + 1), dtype=torch.float32,
                       device=x0.device)
    stats = torch.empty((s.n, 2, s.b, s.c), dtype=torch.float32, device=x0.device)
    fn = _lib("res_norm_stats", [_I, _I, _L, _I, _I, _I, _P, _P, ctypes.c_float, _P, _P, _P])
    kernels.check(fn(s.dtype, s.b, s.v, s.c, s.nblk, s.n, x0.data_ptr(), x1.data_ptr(), eps,
                     part.data_ptr(), stats.data_ptr(), _stream(x0)), "res_norm_stats")
    res_norm_stats.launches += 1
    return stats


def _launch_apply(s: _Shape, x0, x1, stats) -> torch.Tensor:
    out = torch.empty_like(x0)
    fn = _lib("res_norm_apply", [_I, _I, _I, _L, _I, _I, _P, _P, _P, _P, _P])
    kernels.check(fn(s.dtype, s.mode, s.b, s.v, s.c, s.nblk, x0.data_ptr(), x1.data_ptr(),
                     stats.data_ptr(), out.data_ptr(), _stream(x0)), "res_norm_apply")
    res_norm_apply.launches += 1
    return out


def _launch_bwd_reduce(s: _Shape, g, gs: int, x0, x1, stats) -> torch.Tensor:
    part = torch.empty(s.b * s.nblk * s.k * s.c, dtype=torch.float32, device=x0.device)
    sums = torch.empty((s.b, s.k, s.c), dtype=torch.float32, device=x0.device)
    fn = _lib("res_norm_bwd_reduce", [_I, _I, _I, _L, _I, _I, _P, _L, _P, _P, _P, _P, _P, _P])
    kernels.check(fn(s.dtype, s.mode, s.b, s.v, s.c, s.nblk, g.data_ptr(), gs, x0.data_ptr(),
                     x1.data_ptr(), stats.data_ptr(), part.data_ptr(), sums.data_ptr(),
                     _stream(x0)), "res_norm_bwd_reduce")
    res_norm_bwd_reduce.launches += 1
    return sums


def _launch_bwd_apply(s: _Shape, g, gs: int, x0, x1, stats, sums
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """(x0's gradient, x1's or None in mode 0, [n, C] float32 sums of each
    normalised operand's gradient)."""
    dx0 = torch.empty_like(x0)
    dx1 = torch.empty_like(x1) if s.mode else None
    part = torch.empty(s.b * s.nblk * s.n * s.c, dtype=torch.float32, device=x0.device)
    dbias = torch.empty((s.n, s.c), dtype=torch.float32, device=x0.device)
    fn = _lib("res_norm_bwd_apply",
              [_I, _I, _I, _L, _I, _I, _P, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P])
    kernels.check(fn(s.dtype, s.mode, s.b, s.v, s.c, s.nblk, g.data_ptr(), gs, x0.data_ptr(),
                     x1.data_ptr(), stats.data_ptr(), sums.data_ptr(), dx0.data_ptr(),
                     (dx0 if dx1 is None else dx1).data_ptr(), part.data_ptr(),
                     dbias.data_ptr(), _stream(x0)), "res_norm_bwd_apply")
    res_norm_bwd_apply.launches += 1
    return dx0, dx1, dbias


# The four entry points on their own (chip_smoke, the card tests): each
# checks its operands, then launches; xs the normalised operands, raw the
# raw residual. Each counts its launches, also those of _ResNormAct.

def res_norm_stats(xs: Sequence[torch.Tensor], eps: float = EPS) -> torch.Tensor:
    """[len(xs), 2, B, C] float32: each operand's per-(sample, channel)
    mean and 1 / sqrt(var + eps); every operand's partials in one launch,
    then one launch that combines them."""
    return _launch_stats(_shape("res_norm_stats", xs, None), xs[0], xs[-1], eps)


def _operands(name, xs, stats, raw):
    s = _shape(name, xs, raw)
    _check_f32(f"{name} stats", stats, (s.n, 2, s.b, s.c), xs[0])
    return s, xs[0], raw if s.mode == 2 else xs[-1]


def res_norm_apply(xs: Sequence[torch.Tensor], stats: torch.Tensor,
                   raw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """lrelu(the normalised operands' sum [+ raw]), in xs' dtype."""
    s, x0, x1 = _operands("res_norm_apply", xs, stats, raw)
    return _launch_apply(s, x0, x1, stats)


def res_norm_bwd_reduce(g: torch.Tensor, xs: Sequence[torch.Tensor], stats: torch.Tensor,
                        raw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, K, C] float32: per (sample, channel) the means over the voxels
    of gp, of gp * xhat_0 and (two normalised operands) of gp * xhat_1,
    gp the gradient through the LeakyReLU."""
    s, x0, x1 = _operands("res_norm_bwd_reduce", xs, stats, raw)
    return _launch_bwd_reduce(s, g, _stride_or_raise(g, x0), x0, x1, stats)


def res_norm_bwd_apply(g: torch.Tensor, xs: Sequence[torch.Tensor], stats: torch.Tensor,
                       sums: torch.Tensor, raw: Optional[torch.Tensor] = None
                       ) -> Tuple[List[torch.Tensor], Optional[torch.Tensor], torch.Tensor]:
    """(the gradient of each normalised operand, the raw residual's or
    None, [len(xs), C] float32 sums of each operand's gradient over the
    batch and the voxels: the gradients of the biases added before the
    norms)."""
    s, x0, x1 = _operands("res_norm_bwd_apply", xs, stats, raw)
    _check_f32("res_norm_bwd_apply sums", sums, (s.b, s.k, s.c), x0)
    dx0, dx1, dbias = _launch_bwd_apply(s, g, _stride_or_raise(g, x0), x0, x1, stats, sums)
    if s.mode == 1:
        return [dx0, dx1], None, dbias
    return [dx0], dx1, dbias


for _fn in (res_norm_stats, res_norm_apply, res_norm_bwd_reduce, res_norm_bwd_apply):
    _fn.launches = 0
KERNELS = (res_norm_stats, res_norm_apply, res_norm_bwd_reduce, res_norm_bwd_apply)


class _ResNormAct(torch.autograd.Function):
    """lrelu(IN(a + bias) [+ IN(r + bias_r) | + r]) through the kernels:
    r None (norm_act), bias_r None (a raw residual r) or both given. The
    operands are checked once, in the forward."""

    @staticmethod
    def forward(ctx, a, bias, r, bias_r, eps):
        s = _shape("norm_act" if r is None else "norm_add_act",
                   [a] if bias_r is None else [a, r], r if bias_r is None else None)
        x1 = a if r is None else r
        stats = _launch_stats(s, a, x1, eps)
        ctx.save_for_backward(a, x1, stats)
        ctx.launch = s
        ctx.bias_dtypes = bias.dtype, None if bias_r is None else bias_r.dtype
        return _launch_apply(s, a, x1, stats)

    @staticmethod
    def backward(ctx, g):
        a, x1, stats = ctx.saved_tensors
        s = ctx.launch
        gs = _grad_stride(g, a)
        if gs is None:
            g, gs = g.contiguous(), s.c
        sums = _launch_bwd_reduce(s, g, gs, a, x1, stats)
        dx0, dx1, dbias = _launch_bwd_apply(s, g, gs, a, x1, stats, sums)
        db1 = dbias[1].to(ctx.bias_dtypes[1]) if s.mode == 1 else None
        return dx0, dbias[0].to(ctx.bias_dtypes[0]), dx1, db1, None


def _on_card(name: str, a: torch.Tensor, mesh) -> None:
    if a.device.type != "cuda" or mesh is not None:  # the kernels take whole grids
        raise ValueError(f"{name}: unsupported device {a.device}"
                         + (" on a space axis" if mesh is not None else ""))


def norm_act(a: torch.Tensor, bias: torch.Tensor, eps: float = EPS, kernel: bool = True,
             mesh=None) -> torch.Tensor:
    """lrelu(IN(a + bias)) in a's dtype; a is [B, ..., C], bias [C]. The
    kernels where `kernel` (kernels.wanted), else the plain version, whose
    statistics on a space axis (`mesh`) are the whole grid's."""
    if not kernel or a.device.type == "cpu":
        return norm_act_plain(a, bias, eps, mesh)
    _on_card("norm_act", a, mesh)
    return _ResNormAct.apply(a, bias, None, None, eps)


def norm_add_act(a: torch.Tensor, bias: torch.Tensor, r: torch.Tensor,
                 bias_r: Optional[torch.Tensor] = None, eps: float = EPS,
                 kernel: bool = True, mesh=None) -> torch.Tensor:
    """lrelu(IN(a + bias) + IN(r + bias_r)), or lrelu(IN(a + bias) + r)
    without bias_r; in a's dtype, r of a's shape and dtype; `kernel` and
    `mesh` as in norm_act."""
    if not kernel or a.device.type == "cpu":
        return norm_add_act_plain(a, bias, r, bias_r, eps, mesh)
    _on_card("norm_add_act", a, mesh)
    return _ResNormAct.apply(a, bias, r, bias_r, eps)
