"""Fused shifted-window attention forward: a hand-written CUDA kernel and its
plain version.

Replaces the TPU kernel
nerf_mae_tpu/ops/pallas_attention.py:_fused_window_attn_kernel (the forward
of `fused_window_attention`, with its pad/roll glue and
`_rel_bias_and_shift_mask`). The kernel is `csrc/fused_attention.cu`; its
source note says what bounds it on the H100 and how the design meets that.

Semantics (both versions, in the compute dtype T of x, which is already
layer-normed): zero-pad to window multiples, roll by -shift, partition;
qkv = x @ Wqkv + b in f32; q = T(q * scale), k = T(k), v = T(v); per window
and head softmax(q k^T + rel_bias + shift_mask) in f32, p = T(p),
o = T(p @ v); out = T(o @ Wp + bp); unpartition, un-roll, crop. The q scale
falls before the rounding here, after it on the plain XLA-path composition
(ops/window_attention.py); each path keeps its own order.

`fused_window_attention` takes the plain version only for a CPU tensor; for
a CUDA tensor it launches the kernel or raises.
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
    rel = relative_position_bias(bias_table, window).contiguous()
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
