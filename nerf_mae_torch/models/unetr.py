"""UNETR-style conv decoder blocks, channel-last (counterpart of
nerf_mae_tpu/models/unetr.py).

UnetResBlock / UnetrUpBlock / UnetOutBlock of the reference
(reference: nerf_mae/model/mae/unetr_block.py:23-200). Activations stay
NDHWC at every public function; each convolution permutes to NCDHW around
F.conv3d / F.conv_transpose3d (the JAX package leaves convolutions to XLA,
outside any kernel). Weights are in torch layout and named after the
reference state_dict (`transp_conv`, `conv_block.conv1..3`, `out.conv`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def _to_ncdhw(x):
    return x.permute(0, 4, 1, 2, 3)


def _to_ndhwc(x):
    return x.permute(0, 2, 3, 4, 1)


class Conv3d(nn.Module):
    """Conv parameter holder, torch layout: weight [O, I, k, k, k], bias [O]."""

    def __init__(self, in_ch: int, out_ch: int, k: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k, k, k, device=device))
        self.bias = nn.Parameter(torch.empty(out_ch, device=device))

    def forward(self, x: torch.Tensor, dtype: torch.dtype, stride: int = 1) -> torch.Tensor:
        """'SAME' cross-correlation at the compute dtype, NDHWC in and out;
        the bias is added in the compute dtype, as flax nn.Conv does. A
        stride pads as flax's SAME does: ceil(n / stride) outputs, the odd
        pad voxel after."""
        k = self.weight.shape[-1]
        if stride == 1:
            y = F.conv3d(_to_ncdhw(x.to(dtype)), self.weight.to(dtype), padding=k // 2)
            return _to_ndhwc(y) + self.bias.to(dtype)
        pads = []
        for n in reversed(x.shape[1:4]):  # F.pad lists the last dim first
            total = max(0, (-(-n // stride) - 1) * stride + k - n)
            pads += [total // 2, total - total // 2]
        y = F.conv3d(F.pad(_to_ncdhw(x.to(dtype)), pads), self.weight.to(dtype),
                     stride=stride)
        return _to_ndhwc(y) + self.bias.to(dtype)


class ConvTranspose3d(nn.Module):
    """Transposed-conv holder, torch layout: weight [I, O, s, s, s]; stride
    = kernel = s, so every output voxel gets exactly one input voxel."""

    def __init__(self, in_ch: int, out_ch: int, s: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, s, s, s, device=device))
        self.bias = nn.Parameter(torch.empty(out_ch, device=device))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        s = self.weight.shape[-1]
        y = F.conv_transpose3d(_to_ncdhw(x.to(dtype)), self.weight.to(dtype), stride=s)
        return _to_ndhwc(y) + self.bias.to(dtype)


class _InstanceNorm3d(torch.autograd.Function):
    """Instance norm that keeps for its backward only its input and the
    per-(sample, channel) statistics, and makes its float32 temporaries a
    few samples at a time (at most CHUNK elements, at least one sample): at
    a full-resolution grid (160^3, 48 channels, batch 8: 3.1 GB in bf16)
    autograd's own graph would keep two float32 copies of the input and
    make three more at once; the token-grid decoders take the whole batch
    in one chunk."""

    CHUNK = 1 << 28

    @staticmethod
    def _chunks(x):
        n = max(1, _InstanceNorm3d.CHUNK // max(x[0].numel(), 1))
        return [slice(s, s + n) for s in range(0, x.shape[0], n)]

    @staticmethod
    def forward(ctx, x, eps):
        out = torch.empty_like(x)
        stats = torch.empty((2, x.shape[0], 1, 1, 1, x.shape[-1]),
                            dtype=torch.float32, device=x.device)
        for b in _InstanceNorm3d._chunks(x):
            x32 = x[b].float()
            var, mean = torch.var_mean(x32, dim=(1, 2, 3), keepdim=True, unbiased=False)
            stats[0, b], stats[1, b] = mean, torch.rsqrt(var + eps)
            out[b] = (x32 - mean) * stats[1, b]
        ctx.save_for_backward(x, stats)
        return out

    @staticmethod
    def backward(ctx, g):
        x, stats = ctx.saved_tensors
        dx = torch.empty_like(x)
        for b in _InstanceNorm3d._chunks(x):
            rstd = stats[1, b]
            xhat = (x[b].float() - stats[0, b]) * rstd
            g32 = g[b].float()
            gm = g32.mean(dim=(1, 2, 3), keepdim=True)
            gxm = (g32 * xhat).mean(dim=(1, 2, 3), keepdim=True)
            dx[b] = rstd * (g32 - gm - xhat * gxm)
        return dx, None


def instance_norm_3d(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-sample, per-channel normalization over the spatial dims, no
    affine, population variance in f32 (torch nn.InstanceNorm3d defaults);
    the result in x's dtype."""
    return _InstanceNorm3d.apply(x, eps)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float = 1e-6) -> torch.Tensor:
    """flax nn.GroupNorm on NDHWC x: statistics over the spatial dims and
    each group's channels in float32 with the fast variance max(0, E[x^2] -
    mu^2), epsilon 1e-6 (torch's default is 1e-5); y = (x - mu) *
    (rsqrt(var + eps) * scale) + bias. Returns float32 whatever x's dtype,
    as flax does for float32 parameters."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=(1, 3), keepdim=True) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + eps) * scale.float().reshape(1, 1, num_groups, -1)
    y = (xf - mean) * mul + bias.float().reshape(1, 1, num_groups, -1)
    return y.reshape(x.shape)


def _lrelu(x):
    return F.leaky_relu(x, negative_slope=0.01)


class UnetResBlock3D(nn.Module):
    """conv3 -> IN -> lrelu -> conv3 -> IN (+ 1x1 shortcut) -> lrelu.

    (reference: unetr_block.py:23-93; LeakyReLU slope 0.01)
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv3d(in_ch, out_ch, kernel_size, device=device)
        self.conv2 = Conv3d(out_ch, out_ch, kernel_size, device=device)
        self.conv3 = (Conv3d(in_ch, out_ch, 1, device=device)
                      if in_ch != out_ch else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _lrelu(instance_norm_3d(self.conv1(x, self.dtype)))
        h = instance_norm_3d(self.conv2(h, self.dtype))
        residual = x
        if self.conv3 is not None:
            residual = instance_norm_3d(self.conv3(x, self.dtype))
        return _lrelu(h + residual)


class UnetrUpBlock3D(nn.Module):
    """Transposed-conv upsample, optional skip concat, then a res block.

    (reference: unetr_block.py:119-200)
    """

    def __init__(self, in_ch: int, out_ch: int, upsample_factor: int = 2,
                 use_skip: bool = True, dtype: torch.dtype = torch.bfloat16,
                 device=None):
        super().__init__()
        self.dtype, self.use_skip = dtype, use_skip
        self.transp_conv = ConvTranspose3d(in_ch, out_ch, upsample_factor,
                                           device=device)
        res_in = 2 * out_ch if use_skip else out_ch
        self.conv_block = UnetResBlock3D(res_in, out_ch, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.transp_conv(x, self.dtype)
        if self.use_skip:
            x = torch.cat([x, skip.to(x.dtype)], dim=-1)
        return self.conv_block(x)


class SubpixelHead3D(nn.Module):
    """Reconstruction head: res-block + 3^3 projection at the token grid,
    then depth-to-space to full resolution (the JAX package's default
    decoder; no reference counterpart, so its names are its own:
    `subpixel_head.res.*`, `subpixel_head.proj`)."""

    def __init__(self, in_ch: int, out_channels: int, patch: int = 4,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.out_channels, self.patch, self.dtype = out_channels, patch, dtype
        self.res = UnetResBlock3D(in_ch, in_ch, dtype=dtype, device=device)
        self.proj = Conv3d(in_ch, out_channels * patch**3, 3, device=device)

    def forward(self, x: torch.Tensor, patched: bool = False) -> torch.Tensor:
        b, t = x.shape[0], x.shape[1]
        p = self.patch
        h = self.proj(self.res(x), self.dtype)  # [B, T, T, T, p^3 * out]
        if patched:  # == patchify_3d(depth_to_space(h)), as one reshape
            return h.reshape(b, t, t, t, p**3, self.out_channels)
        h = h.reshape(b, t, t, t, p, p, p, self.out_channels)
        h = h.permute(0, 1, 4, 2, 5, 3, 6, 7)
        return h.reshape(b, t * p, t * p, t * p, self.out_channels)


class UnetOutBlock3D(nn.Module):
    """1x1x1 conv head (reference: unetr_block.py:96-116)."""

    def __init__(self, in_ch: int, out_channels: int,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.conv = Conv3d(in_ch, out_channels, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x, self.dtype)
