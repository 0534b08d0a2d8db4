"""Fused shifted-window attention, forward and backward: hand-written CUDA
kernels, their plain versions and the autograd Function joining them.

Replaces the TPU kernels of nerf_mae_tpu/ops/pallas_attention.py:
`_fused_window_attn_kernel` (the forward of `fused_window_attention`, with
its pad/roll glue and `_rel_bias_and_shift_mask`) by `csrc/fused_attention.cu`,
and `_fused_window_attn_bwd_kernel` (with its `_bwd` glue) by
`csrc/fused_attention_bwd.cu`. Each source note says what bounds the kernel
on the H100 and how the design meets that.

Semantics (both versions, in the compute dtype T of x, which is already
layer-normed): zero-pad to window multiples, roll by -shift, partition;
qkv = x @ Wqkv + b in f32; q = T(q * scale), k = T(k), v = T(v); per window
and head softmax(q k^T + rel_bias + shift_mask) in f32, p = T(p),
o = T(p @ v); out = T(o @ Wp + bp); unpartition, un-roll, crop. The q scale
falls before the rounding here, after it on the plain XLA-path composition
(ops/window_attention.py); each path keeps its own order.

The backward recomputes the forward from x (nothing is saved but the
inputs, as the JAX custom_vjp does) and returns dx in T and float32
gradients of the weights, the biases and the bias table. The weight
gradients are rounded to the weights' own dtype by FusedWindowAttentionFn:
the model hands this function bf16 casts of its weights, as the JAX block
does, so their gradients are bf16 before they widen to the float32
parameters.

`fused_window_attention` and `fused_window_attention_bwd` take the plain
version only for a CPU tensor; for a CUDA tensor they launch the kernel or
raise.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from nerf_mae_torch import kernels
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


def fused_window_attention_plain(x, qkv_weight, qkv_bias, proj_weight,
                                 proj_bias, bias_table, window, shift,
                                 num_heads):
    """The kernel's function in plain PyTorch (see the module docstring).
    x [B, G0, G1, G2, C] in the compute dtype; weights in torch Linear
    layout ([out, in])."""
    b, g0, g1, g2, c = x.shape
    d = x.dtype
    window = tuple(window)
    pad, padded, eff = window_geometry((g0, g1, g2), window, shift)
    xw, counts = pad_roll_partition(x, window, pad, eff)
    nw, n = xw.shape[1], xw.shape[2]
    hd = c // num_heads

    qkv = mm_f32(xw, qkv_weight.to(d).t()) + qkv_bias.float()
    qkv = qkv.reshape(b, nw, n, 3, num_heads, hd).permute(3, 0, 1, 4, 2, 5)
    q = (qkv[0] * hd ** -0.5).to(d)
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
    return unpartition_unroll_crop(y, window, counts, (g0, g1, g2), eff)


_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_I] * 13 + [ctypes.c_float] + [_P] * 10
_BWD_ARGTYPES = [_I, ctypes.POINTER(_I), ctypes.c_float,
                 ctypes.POINTER(_P), _P, _P]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    fn = kernels.load("fused_attention").fused_window_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = _I
    return fn


def fused_window_attention(x, qkv_weight, qkv_bias, proj_weight, proj_bias,
                           bias_table, window, shift, num_heads):
    """Shifted-window MSA forward. CPU tensor: the plain version. CUDA
    tensor: the `csrc/fused_attention.cu` kernel (counted in `.launches`)."""
    if x.device.type == "cpu":
        return fused_window_attention_plain(
            x, qkv_weight, qkv_bias, proj_weight, proj_bias, bias_table,
            window, shift, num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"fused_window_attention: unsupported device {x.device}")
    d = x.dtype
    if d not in _DTYPES:
        raise ValueError(f"fused_window_attention: unsupported dtype {d}")
    b, g0, g1, g2, c = x.shape
    window = tuple(window)
    if not kernel_supported(c, window):
        raise ValueError(
            f"fused_window_attention: unsupported shape {tuple(x.shape)}")
    _, padded, eff = window_geometry((g0, g1, g2), window, shift)
    m = b * math.prod(padded[i] // window[i] for i in range(3)) * math.prod(window)
    dev = x.device

    x = x.contiguous()
    w_qkv = kernels.gemm_operand(qkv_weight, d, "qkv_weight")
    w_proj = kernels.gemm_operand(proj_weight, d, "proj_weight")
    b_qkv = qkv_bias.to(device=dev, dtype=torch.float32).contiguous()
    b_proj = proj_bias.to(device=dev, dtype=torch.float32).contiguous()
    rel = bias_table.to(device=dev, dtype=torch.float32).contiguous()  # expanded in the kernel
    h_buf = torch.empty((m, c), dtype=d, device=dev)
    qkv_buf = torch.empty((m, 3 * c), dtype=d, device=dev)
    out = torch.empty_like(x)
    scale = float(np.float32((c // num_heads) ** -0.5))
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = _lib()(
        _DTYPES[d], b, g0, g1, g2, c, num_heads, *window, *eff, scale,
        x.data_ptr(), w_qkv.data_ptr(), b_qkv.data_ptr(), w_proj.data_ptr(),
        b_proj.data_ptr(), rel.data_ptr(), h_buf.data_ptr(),
        qkv_buf.data_ptr(), out.data_ptr(), stream)
    kernels.check(code, "fused_window_attention_fwd")
    fused_window_attention.launches += 1
    return out


fused_window_attention.launches = 0


def attention_parts(h, qkv_weight, qkv_bias, bias_table, window, padded,
                    shift, num_heads):
    """The forward of windowed MSA up to the head merge, as the kernels
    compute it: h [B, nW, N, C] in the compute dtype T. Returns (q, k, v,
    p, o): q = T(q * scale), k, v in T, [B, nW, heads, N, hd]; p the float32
    softmax [B, nW, heads, N, N]; o = T(p) @ v in float32, [B, nW, N, C]."""
    b, nw, n, c = h.shape
    d = h.dtype
    hd = c // num_heads
    qkv = mm_f32(h, qkv_weight.to(d).t()) + qkv_bias.float()
    qkv = qkv.reshape(b, nw, n, 3, num_heads, hd).permute(3, 0, 1, 4, 2, 5)
    q = (qkv[0] * hd ** -0.5).to(d)
    k = qkv[1].to(d)
    v = qkv[2].to(d)
    p = attention_probs(q, k, bias_table, window, padded, shift)
    o = mm_f32(p.to(d), v).permute(0, 1, 3, 2, 4).reshape(b, nw, n, c)
    return q, k, v, p, o


def attention_probs(q, k, bias_table, window, padded, shift):
    """The float32 softmax [B, nW, heads, N, N] of q k^T + rel_bias +
    shift_mask, q (scaled) and k in T, [B, nW, heads, N, hd]."""
    logits = mm_f32(q, k.transpose(-1, -2))
    logits = logits + relative_position_bias(bias_table, window)[None, None]
    mask = shift_mask_tensor(padded, window, shift, q.device)
    if mask is not None:
        logits = logits + mask[None, :, None]
    return torch.softmax(logits, dim=-1)


def attention_bwd(q, k, v, p, do):
    """VJP of the attention core, the JAX kernels' per-head steps: do
    [B, nW, N, C] float32. dp = T(do) v^T, dv = T(p)^T T(do),
    dl = p * (dp - rowsum(dp * p)), dq = (T(dl) k) * scale, dk = T(dl)^T q
    (q already carries the scale). Returns (dqkv [B, nW, N, 3C] float32 in
    the qkv column layout, dlogit [heads, N, N] float32)."""
    b, nw, heads, n, hd = q.shape
    d = q.dtype
    do_h = do.reshape(b, nw, n, heads, hd).permute(0, 1, 3, 2, 4).to(d)
    dp = mm_f32(do_h, v.transpose(-1, -2))
    dv = mm_f32(p.to(d).transpose(-1, -2), do_h)
    dl = p * (dp - (dp * p).sum(-1, keepdim=True))
    dlogit = dl.sum((0, 1))
    dl_d = dl.to(d)
    dq = mm_f32(dl_d, k) * hd ** -0.5
    dk = mm_f32(dl_d.transpose(-1, -2), q)
    dqkv = torch.stack([dq, dk, dv]).permute(1, 2, 4, 0, 3, 5)
    return dqkv.reshape(b, nw, n, 3 * heads * hd), dlogit


def weight_grad(dout, h):
    """float32 D^T H over every row of [..., X] tensors (torch layout
    [out, in] when dout is the product's output gradient)."""
    return mm_f32(dout.reshape(-1, dout.shape[-1]).t(), h.reshape(-1, h.shape[-1]))


def fused_window_attention_bwd_plain(x, qkv_weight, qkv_bias, proj_weight,
                                     bias_table, dy, window, shift, num_heads):
    """The backward kernel's function in plain PyTorch: the JAX kernel's
    VJP step by step. Returns (dx in x.dtype, dqkv_weight, dqkv_bias,
    dproj_weight, dproj_bias, dbias_table), the gradients float32 in torch
    layout."""
    b, g0, g1, g2, c = x.shape
    d = x.dtype
    window = tuple(window)
    pad, padded, eff = window_geometry((g0, g1, g2), window, shift)
    xw, counts = pad_roll_partition(x, window, pad, eff)
    dyw, _ = pad_roll_partition(dy.to(d), window, pad, eff)
    q, k, v, p, o = attention_parts(xw, qkv_weight, qkv_bias, bias_table,
                                    window, padded, eff, num_heads)
    do = mm_f32(dyw, proj_weight.to(d))
    dproj_w = weight_grad(dyw, o.to(d))
    dproj_b = dy.float().sum((0, 1, 2, 3))
    dqkv, dlogit = attention_bwd(q, k, v, p, do)
    dqkv_b = dqkv.sum((0, 1, 2))
    dqkv_d = dqkv.to(d)
    dqkv_w = weight_grad(dqkv_d, xw)
    dx = mm_f32(dqkv_d, qkv_weight.to(d)).to(d)
    dx = unpartition_unroll_crop(dx, window, counts, (g0, g1, g2), eff)
    return (dx, dqkv_w, dqkv_b, dproj_w, dproj_b,
            relative_position_bias_grad(dlogit, window))


def _bwd_lib():
    lib = kernels.load("fused_attention_bwd")
    fn = lib.fused_window_attention_bwd
    ws = lib.fused_window_attention_bwd_workspace
    if fn.argtypes is None:
        fn.argtypes = _BWD_ARGTYPES
        fn.restype = _I
        ws.argtypes = [_I, ctypes.POINTER(_I)]
        ws.restype = ctypes.c_size_t
    return fn, ws


def fused_window_attention_bwd(x, qkv_weight, qkv_bias, proj_weight,
                               bias_table, dy, window, shift, num_heads):
    """Shifted-window MSA backward (see fused_window_attention_bwd_plain for
    what it returns). CPU tensor: the plain version. CUDA tensor: the
    `csrc/fused_attention_bwd.cu` kernel (counted in `.launches`)."""
    if x.device.type == "cpu":
        return fused_window_attention_bwd_plain(
            x, qkv_weight, qkv_bias, proj_weight, bias_table, dy, window,
            shift, num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"fused_window_attention_bwd: unsupported device {x.device}")
    d = x.dtype
    if d not in _DTYPES:
        raise ValueError(f"fused_window_attention_bwd: unsupported dtype {d}")
    b, g0, g1, g2, c = x.shape
    window = tuple(window)
    if not kernel_supported(c, window) or dy.shape != x.shape:
        raise ValueError(
            f"fused_window_attention_bwd: unsupported shape {tuple(x.shape)}")
    _, _, eff = window_geometry((g0, g1, g2), window, shift)
    dev = x.device
    x = x.contiguous()
    dy = dy.to(d).contiguous()
    w_qkv = kernels.gemm_operand(qkv_weight, d, "qkv_weight")
    w_proj = kernels.gemm_operand(proj_weight, d, "proj_weight")
    b_qkv = qkv_bias.to(device=dev, dtype=torch.float32).contiguous()
    rel = bias_table.to(device=dev, dtype=torch.float32).contiguous()  # expanded in the kernel
    n = math.prod(window)
    dims = kernels.int_array([b, g0, g1, g2, c, num_heads, *window, *eff])
    fn, ws = _bwd_lib()
    work = torch.empty(ws(_DTYPES[d], dims), dtype=torch.uint8, device=dev)
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    grads = [f32(3 * c, c), f32(3 * c), f32(c, c), f32(c), f32(num_heads, n, n)]
    ptrs = kernels.ptr_array([x, dy, w_qkv, b_qkv, w_proj, rel, dx, *grads])
    scale = float(np.float32((c // num_heads) ** -0.5))
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = fn(_DTYPES[d], dims, scale, ptrs, work.data_ptr(), stream)
    kernels.check(code, "fused_window_attention_bwd")
    fused_window_attention_bwd.launches += 1
    return (dx, *grads[:4], relative_position_bias_grad(grads[4], window))


fused_window_attention_bwd.launches = 0


class FusedWindowAttentionFn(torch.autograd.Function):
    """fused_window_attention with its backward kernel, as the JAX
    custom_vjp: only the inputs are saved and the backward recomputes the
    forward. Each gradient comes back in its input's dtype, so bf16 weight
    casts get bf16-rounded gradients, as in the JAX block."""

    @staticmethod
    def forward(ctx, x, qkv_weight, qkv_bias, proj_weight, proj_bias,
                bias_table, window, shift, num_heads):
        ctx.save_for_backward(x, qkv_weight, qkv_bias, proj_weight, proj_bias,
                              bias_table)
        ctx.static = (tuple(window), tuple(shift), num_heads)
        return fused_window_attention(x, qkv_weight, qkv_bias, proj_weight,
                                      proj_bias, bias_table, window, shift,
                                      num_heads)

    @staticmethod
    def backward(ctx, dy):
        x, qkv_weight, qkv_bias, proj_weight, proj_bias, bias_table = ctx.saved_tensors
        dx, *grads = fused_window_attention_bwd(
            x, qkv_weight, qkv_bias, proj_weight, bias_table, dy, *ctx.static)
        inputs = (qkv_weight, qkv_bias, proj_weight, proj_bias, bias_table)
        grads = [g.to(t.dtype) for g, t in zip(grads, inputs)]
        return (dx, *grads, None, None, None)
