"""Whole Swin block forward: a hand-written CUDA kernel and its plain version.

Replaces the TPU kernel nerf_mae_tpu/ops/pallas_block.py:_fused_block_kernel
(the forward of `fused_swin_block`, with its `_prep` / `_pad_row_mask` glue).
The kernel is `csrc/fused_block.cu`; its source note says what bounds it on
the H100 and how the design meets that.

Semantics (both versions, in the compute dtype T of x):
  h1 = T(LN1(x)) in f32 with the fast variance, zeroed at pad rows (LN runs
  before the zero pad, so padded keys/values equal qkv_bias exactly);
  qkv = h1 @ Wqkv + b in f32; q = T(q * scale), k = T(k), v = T(v);
  per window and head: softmax(q k^T + rel_bias + shift_mask) in f32,
  p = T(p), o = p @ v; y = T(T(o) @ Wp + bp); x1 = x + y * T(keep_a);
  h2 = T(LN2(x1)); f1 = T(h2 @ W1) + T(b1); g = T(gelu_tanh(f32(f1)));
  f2 = T(g @ W2) + T(b2); out = x1 + f2 * T(keep_m).
Sums of T values round to T at each step, as in the JAX kernel.

`fused_swin_block` takes the plain version only for a CPU tensor; for a
CUDA tensor it launches the kernel or raises.
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
