"""Whole Swin block, forward and backward: hand-written CUDA kernels, their
plain versions and the autograd Function joining them.

Replaces the TPU kernels of nerf_mae_tpu/ops/pallas_block.py:
`_fused_block_kernel` (the forward of `fused_swin_block`, with its `_prep` /
`_pad_row_mask` glue) by `csrc/fused_block.cu`, and `_fused_block_bwd_kernel`
(with its `_bwd` glue) by `csrc/fused_block_bwd.cu`. Each source note says
what bounds the kernel on the H100 and how the design meets that.

Semantics (both versions, in the compute dtype T of x):
  h1 = T(LN1(x)) in f32 with the fast variance, zeroed at pad rows (LN runs
  before the zero pad, so padded keys/values equal qkv_bias exactly);
  qkv = h1 @ Wqkv + b in f32; q = T(q * scale), k = T(k), v = T(v);
  per window and head: softmax(q k^T + rel_bias + shift_mask) in f32,
  p = T(p), o = p @ v; y = T(T(o) @ Wp + bp); x1 = x + y * T(keep_a);
  h2 = T(LN2(x1)); f1 = T(h2 @ W1) + T(b1); g = T(gelu_tanh(f32(f1)));
  f2 = T(g @ W2) + T(b2); out = x1 + f2 * T(keep_m).
Sums of T values round to T at each step, as in the JAX kernel.

The backward recomputes the block from x and the parameters (FusedSwinBlockFn
saves nothing else, as the JAX custom_vjp does, which is why a fused stage
needs no remat) and returns dx in T and float32 gradients of all twelve
parameters and of the bias table. The parameters reach the Function in
float32 and are cast to T inside, so their gradients are never rounded to
bf16; the keep factors get no gradient.

`fused_swin_block` and `fused_swin_block_bwd` take the plain version only
for a CPU tensor; for a CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from nerf_mae_torch import kernels
from nerf_mae_torch.ops.fused_attention import (
    attention_bwd,
    attention_parts,
    weight_grad,
)
from nerf_mae_torch.ops.window_attention import (
    kernel_supported,
    mm_f32,
    pad_roll_partition,
    relative_position_bias,
    relative_position_bias_grad,
    shift_mask_tensor,
    unpartition_unroll_crop,
    window_geometry,
)

_SQRT_2_OVER_PI = float(np.float32(np.sqrt(2.0 / np.pi)))
_GELU_C = float(np.float32(0.044715))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximated gelu in x's dtype, jax.nn.gelu(approximate=True)'s
    operation order."""
    u = _SQRT_2_OVER_PI * (x + _GELU_C * x * x * x)
    return 0.5 * x * (1.0 + torch.tanh(u))


def layer_norm(x: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    """float32 LayerNorm with the fast variance E[x^2] - mu^2 (the JAX
    package's swin.layer_norm and _ln_fwd); returns f32."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    return (xf - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def fused_swin_block_plain(x, ln1_scale, ln1_bias, qkv_weight, qkv_bias,
                           proj_weight, proj_bias, ln2_scale, ln2_bias,
                           fc1_weight, fc1_bias, fc2_weight, fc2_bias,
                           bias_table, keep, window, shift, num_heads, eps):
    """The kernel's function in plain PyTorch (see the module docstring).
    x [B, G0, G1, G2, C] in the compute dtype; weights in torch Linear layout
    ([out, in]); keep [B, 2] float32 (attention, MLP) droppath factors."""
    b, g0, g1, g2, c = x.shape
    d = x.dtype
    window = tuple(window)
    pad, padded, eff = window_geometry((g0, g1, g2), window, shift)
    xw, counts = pad_roll_partition(x, window, pad, eff)  # [B, nW, N, C]
    nw, n = xw.shape[1], xw.shape[2]
    valid, _ = pad_roll_partition(
        torch.ones((1, g0, g1, g2, 1), dtype=d, device=x.device), window, pad, eff)
    hd = c // num_heads
    scale = hd ** -0.5

    h1 = layer_norm(xw, ln1_scale, ln1_bias, eps).to(d) * valid
    qkv = mm_f32(h1, qkv_weight.to(d).t()) + qkv_bias.float()
    qkv = qkv.reshape(b, nw, n, 3, num_heads, hd).permute(3, 0, 1, 4, 2, 5)
    q = (qkv[0] * scale).to(d)  # [B, nW, heads, N, hd]
    k = qkv[1].to(d)
    v = qkv[2].to(d)
    logits = mm_f32(q, k.transpose(-1, -2))
    logits = logits + relative_position_bias(bias_table, window)[None, None]
    mask = shift_mask_tensor(padded, window, eff, x.device)
    if mask is not None:
        logits = logits + mask[None, :, None]
    p = torch.softmax(logits, dim=-1).to(d)
    o = mm_f32(p, v).to(d).permute(0, 1, 3, 2, 4).reshape(b, nw, n, c)
    y = (mm_f32(o, proj_weight.to(d).t()) + proj_bias.float()).to(d)

    ka = keep[:, 0].to(d).reshape(b, 1, 1, 1)
    km = keep[:, 1].to(d).reshape(b, 1, 1, 1)
    x1 = xw + y * ka
    h2 = layer_norm(x1, ln2_scale, ln2_bias, eps).to(d)
    f1 = mm_f32(h2, fc1_weight.to(d).t()).to(d) + fc1_bias.to(d)
    g = gelu_tanh(f1.float()).to(d)
    f2 = mm_f32(g, fc2_weight.to(d).t()).to(d) + fc2_bias.to(d)
    out = x1 + f2 * km
    return unpartition_unroll_crop(out, window, counts, (g0, g1, g2), eff)


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = [_I] * 14 + [_F, _F] + [_P] * 21
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = kernels.load("fused_block")
    fn = lib.fused_swin_block_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = _I
    return fn


def fused_swin_block(x, ln1_scale, ln1_bias, qkv_weight, qkv_bias,
                     proj_weight, proj_bias, ln2_scale, ln2_bias,
                     fc1_weight, fc1_bias, fc2_weight, fc2_bias,
                     bias_table, keep, window, shift, num_heads, eps):
    """One whole Swin block forward. CPU tensor: the plain version. CUDA
    tensor: the `csrc/fused_block.cu` kernel (counted in `.launches`)."""
    if x.device.type == "cpu":
        return fused_swin_block_plain(
            x, ln1_scale, ln1_bias, qkv_weight, qkv_bias, proj_weight,
            proj_bias, ln2_scale, ln2_bias, fc1_weight, fc1_bias, fc2_weight,
            fc2_bias, bias_table, keep, window, shift, num_heads, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_swin_block: unsupported device {x.device}")
    d = x.dtype
    if d not in _DTYPES:
        raise ValueError(f"fused_swin_block: unsupported dtype {d}")
    b, g0, g1, g2, c = x.shape
    f = fc1_weight.shape[0]
    window = tuple(window)
    if not kernel_supported(c, window):
        raise ValueError(f"fused_swin_block: unsupported shape {tuple(x.shape)}")
    if keep.shape != (b, 2):
        raise ValueError(f"keep must be [B, 2], got {tuple(keep.shape)}")
    _, padded, eff = window_geometry((g0, g1, g2), window, shift)
    n = math.prod(window)
    m = b * math.prod(padded[i] // window[i] for i in range(3)) * n
    dev = x.device
    f32 = lambda t: t.to(device=dev, dtype=torch.float32).contiguous()

    x = x.contiguous()
    w_qkv = kernels.gemm_operand(qkv_weight, d, "qkv_weight")
    w_proj = kernels.gemm_operand(proj_weight, d, "proj_weight")
    w_fc1 = kernels.gemm_operand(fc1_weight, d, "fc1_weight")
    w_fc2 = kernels.gemm_operand(fc2_weight, d, "fc2_weight")
    rel = relative_position_bias(bias_table, window).contiguous()
    keep = f32(keep)
    ln1_s, ln1_b, ln2_s, ln2_b = map(f32, (ln1_scale, ln1_bias, ln2_scale, ln2_bias))
    b_qkv, b_proj, b_fc1, b_fc2 = map(f32, (qkv_bias, proj_bias, fc1_bias, fc2_bias))
    h_buf = torch.empty((m, c), dtype=d, device=dev)
    qkv_buf = torch.empty((m, 3 * c), dtype=d, device=dev)
    x1_buf = torch.empty((m, c), dtype=d, device=dev)
    g_buf = torch.empty((m, f), dtype=d, device=dev)
    out = torch.empty_like(x)
    scale = float(np.float32((c // num_heads) ** -0.5))
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda t: t.data_ptr()
    code = _lib()(
        _DTYPES[d], b, g0, g1, g2, c, f, num_heads, *window, *eff, eps, scale,
        ptr(x), ptr(ln1_s), ptr(ln1_b), ptr(w_qkv), ptr(b_qkv), ptr(w_proj),
        ptr(b_proj), ptr(ln2_s), ptr(ln2_b), ptr(w_fc1), ptr(b_fc1),
        ptr(w_fc2), ptr(b_fc2), ptr(rel), ptr(keep), ptr(h_buf),
        ptr(qkv_buf), ptr(x1_buf), ptr(g_buf), ptr(out), stream)
    kernels.check(code, "fused_swin_block_fwd")
    fused_swin_block.launches += 1
    return out


fused_swin_block.launches = 0


def gelu_tanh_grad(x: torch.Tensor) -> torch.Tensor:
    """d/dx of gelu_tanh in float32, the JAX kernel's operation order."""
    u = _SQRT_2_OVER_PI * (x + _GELU_C * x * x * x)
    t = torch.tanh(u)
    du = _SQRT_2_OVER_PI * (1.0 + 3.0 * _GELU_C * x * x)
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * du


def _ln_parts(x, scale, bias, eps):
    """float32 LayerNorm with the fast variance: (y, xhat, inv)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    inv = torch.rsqrt(var + eps)
    xhat = (xf - mu) * inv
    return xhat * scale.float() + bias.float(), xhat, inv


def _ln_bwd_input(dy, xhat, inv, scale):
    """Input gradient of LayerNorm given the float32 output gradient."""
    dxhat = dy * scale.float()
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    return inv * (dxhat - m1 - xhat * m2)


def fused_swin_block_bwd_plain(x, ln1_scale, ln1_bias, qkv_weight, qkv_bias,
                               proj_weight, proj_bias, ln2_scale, ln2_bias,
                               fc1_weight, fc1_bias, fc2_weight, fc2_bias,
                               bias_table, keep, dy, window, shift, num_heads,
                               eps):
    """The backward kernel's function in plain PyTorch: the recompute, then
    the JAX kernel's hand-derived VJP step by step with its rounding points.
    Returns (dx in x.dtype, dln1_scale, dln1_bias, dqkv_weight, dqkv_bias,
    dproj_weight, dproj_bias, dln2_scale, dln2_bias, dfc1_weight, dfc1_bias,
    dfc2_weight, dfc2_bias, dbias_table), the gradients float32 in torch
    layout."""
    b, g0, g1, g2, c = x.shape
    d = x.dtype
    window = tuple(window)
    pad, padded, eff = window_geometry((g0, g1, g2), window, shift)
    xw, counts = pad_roll_partition(x, window, pad, eff)  # [B, nW, N, C]
    dyw, _ = pad_roll_partition(dy.to(d), window, pad, eff)
    valid, _ = pad_roll_partition(
        torch.ones((1, g0, g1, g2, 1), device=x.device), window, pad, eff)
    ka = keep[:, 0].float().reshape(b, 1, 1, 1)
    km = keep[:, 1].float().reshape(b, 1, 1, 1)
    rows = (0, 1, 2)

    # recompute the forward
    h1f, xhat1, inv1 = _ln_parts(xw, ln1_scale, ln1_bias, eps)
    h1 = h1f.to(d) * valid.to(d)
    q, k, v, p, o = attention_parts(h1, qkv_weight, qkv_bias, bias_table,
                                    window, padded, eff, num_heads)
    y = (mm_f32(o.to(d), proj_weight.to(d).t()) + proj_bias.float()).to(d)
    x1 = xw + y * keep[:, 0].to(d).reshape(b, 1, 1, 1)
    h2f, xhat2, inv2 = _ln_parts(x1, ln2_scale, ln2_bias, eps)
    h2 = h2f.to(d)
    f1 = mm_f32(h2, fc1_weight.to(d).t()).to(d) + fc1_bias.to(d)
    f1f = f1.float()
    g = gelu_tanh(f1f).to(d)

    # MLP branch: out = x1 + f2 * keep_m
    dout = dyw.float()
    df2 = dout * km
    dfc2_b = df2.sum(rows)
    df2_d = df2.to(d)
    dg = mm_f32(df2_d, fc2_weight.to(d))
    dfc2_w = weight_grad(df2_d, g)
    df1 = dg * gelu_tanh_grad(f1f)
    dfc1_b = df1.sum(rows)
    df1_d = df1.to(d)
    dh2 = mm_f32(df1_d, fc1_weight.to(d))
    dfc1_w = weight_grad(df1_d, h2)
    dln2_s = (dh2 * xhat2).sum(rows)
    dln2_b = dh2.sum(rows)
    dx1 = dout + _ln_bwd_input(dh2, xhat2, inv2, ln2_scale)

    # attention branch: x1 = x + y * keep_a
    dy_attn = dx1 * ka
    dproj_b = dy_attn.sum(rows)
    dya_d = dy_attn.to(d)
    do = mm_f32(dya_d, proj_weight.to(d))
    dproj_w = weight_grad(dya_d, o.to(d))
    dqkv, dlogit = attention_bwd(q, k, v, p, do)
    # pad rows' keys and values are attended by real queries: their dqkv
    # rows count in the bias gradient
    dqkv_b = dqkv.sum(rows)
    dqkv_d = dqkv.to(d)
    dqkv_w = weight_grad(dqkv_d, h1)
    dh1 = mm_f32(dqkv_d, qkv_weight.to(d)) * valid  # vjp of the pad-row mask
    dln1_s = (dh1 * xhat1).sum(rows)
    dln1_b = dh1.sum(rows)
    dx = dx1 + _ln_bwd_input(dh1, xhat1, inv1, ln1_scale)
    dx = unpartition_unroll_crop(dx.to(d), window, counts, (g0, g1, g2), eff)
    return (dx, dln1_s, dln1_b, dqkv_w, dqkv_b, dproj_w, dproj_b, dln2_s,
            dln2_b, dfc1_w, dfc1_b, dfc2_w, dfc2_b,
            relative_position_bias_grad(dlogit, window))


_BWD_ARGTYPES = [_I, ctypes.POINTER(_I), _F, _F, ctypes.POINTER(_P), _P, _P]


def _bwd_lib():
    lib = kernels.load("fused_block_bwd")
    fn, ws = lib.fused_swin_block_bwd, lib.fused_swin_block_bwd_workspace
    if fn.argtypes is None:
        fn.argtypes = _BWD_ARGTYPES
        fn.restype = _I
        ws.argtypes = [_I, ctypes.POINTER(_I)]
        ws.restype = ctypes.c_size_t
    return fn, ws


def fused_swin_block_bwd(x, ln1_scale, ln1_bias, qkv_weight, qkv_bias,
                         proj_weight, proj_bias, ln2_scale, ln2_bias,
                         fc1_weight, fc1_bias, fc2_weight, fc2_bias,
                         bias_table, keep, dy, window, shift, num_heads, eps):
    """One whole Swin block backward (see fused_swin_block_bwd_plain for what
    it returns). CPU tensor: the plain version. CUDA tensor: the
    `csrc/fused_block_bwd.cu` kernel (counted in `.launches`)."""
    if x.device.type == "cpu":
        return fused_swin_block_bwd_plain(
            x, ln1_scale, ln1_bias, qkv_weight, qkv_bias, proj_weight,
            proj_bias, ln2_scale, ln2_bias, fc1_weight, fc1_bias, fc2_weight,
            fc2_bias, bias_table, keep, dy, window, shift, num_heads, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_swin_block_bwd: unsupported device {x.device}")
    d = x.dtype
    if d not in _DTYPES:
        raise ValueError(f"fused_swin_block_bwd: unsupported dtype {d}")
    b, g0, g1, g2, c = x.shape
    f = fc1_weight.shape[0]
    window = tuple(window)
    if not kernel_supported(c, window) or dy.shape != x.shape:
        raise ValueError(f"fused_swin_block_bwd: unsupported shape {tuple(x.shape)}")
    if keep.shape != (b, 2):
        raise ValueError(f"keep must be [B, 2], got {tuple(keep.shape)}")
    _, _, eff = window_geometry((g0, g1, g2), window, shift)
    dev = x.device
    f32 = lambda t: t.to(device=dev, dtype=torch.float32).contiguous()

    x = x.contiguous()
    dy = dy.to(d).contiguous()
    w_qkv = kernels.gemm_operand(qkv_weight, d, "qkv_weight")
    w_proj = kernels.gemm_operand(proj_weight, d, "proj_weight")
    w_fc1 = kernels.gemm_operand(fc1_weight, d, "fc1_weight")
    w_fc2 = kernels.gemm_operand(fc2_weight, d, "fc2_weight")
    rel = relative_position_bias(bias_table, window).contiguous()
    inputs = [x, dy, f32(ln1_scale), f32(ln1_bias), w_qkv, f32(qkv_bias),
              w_proj, f32(proj_bias), f32(ln2_scale), f32(ln2_bias), w_fc1,
              f32(fc1_bias), w_fc2, f32(fc2_bias), rel, f32(keep)]
    n = math.prod(window)
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    grads = [empty(c), empty(c), empty(3 * c, c), empty(3 * c), empty(c, c),
             empty(c), empty(c), empty(c), empty(f, c), empty(f), empty(c, f),
             empty(c), empty(num_heads, n, n)]
    dims = kernels.int_array([b, g0, g1, g2, c, f, num_heads, *window, *eff])
    fn, ws = _bwd_lib()
    work = torch.empty(ws(_DTYPES[d], dims), dtype=torch.uint8, device=dev)
    ptrs = kernels.ptr_array(inputs + [dx] + grads)
    scale = float(np.float32((c // num_heads) ** -0.5))
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = fn(_DTYPES[d], dims, eps, scale, ptrs, work.data_ptr(), stream)
    kernels.check(code, "fused_swin_block_bwd")
    fused_swin_block_bwd.launches += 1
    return (dx, *grads[:12], relative_position_bias_grad(grads[12], window))


fused_swin_block_bwd.launches = 0


class FusedSwinBlockFn(torch.autograd.Function):
    """fused_swin_block with its backward kernel, as the JAX custom_vjp:
    x, the parameters and keep are saved, and the backward recomputes the
    block. Parameter gradients come back in the parameters' dtype (float32
    for the model's parameters: never rounded to bf16); keep gets none."""

    @staticmethod
    def forward(ctx, x, ln1_scale, ln1_bias, qkv_weight, qkv_bias,
                proj_weight, proj_bias, ln2_scale, ln2_bias, fc1_weight,
                fc1_bias, fc2_weight, fc2_bias, bias_table, keep, window,
                shift, num_heads, eps):
        params = (ln1_scale, ln1_bias, qkv_weight, qkv_bias, proj_weight,
                  proj_bias, ln2_scale, ln2_bias, fc1_weight, fc1_bias,
                  fc2_weight, fc2_bias, bias_table)
        ctx.save_for_backward(x, *params, keep)
        ctx.static = (tuple(window), tuple(shift), num_heads, eps)
        return fused_swin_block(x, *params, keep, window, shift, num_heads, eps)

    @staticmethod
    def backward(ctx, dy):
        x, *params, keep = ctx.saved_tensors
        dx, *grads = fused_swin_block_bwd(x, *params, keep, dy, *ctx.static)
        grads = [g.to(p.dtype) for g, p in zip(grads, params)]
        return (dx, *grads, None, None, None, None, None)
