"""UNETR-style conv decoder blocks, channel-last (counterpart of
nerf_mae_tpu/models/unetr.py).

UnetResBlock / UnetrUpBlock / UnetOutBlock of the reference
(reference: nerf_mae/model/mae/unetr_block.py:23-200). Activations stay
NDHWC at every public function; each convolution permutes to NCDHW around
F.conv3d / F.conv_transpose3d (the JAX package leaves convolutions to XLA,
outside any kernel). Weights are in torch layout and named after the
reference state_dict (`transp_conv`, `conv_block.conv1..3`, `out.conv`).

On a space axis (`spatial` set by parallel.spatial.set_spatial) every
block takes and returns the even slab layout of its grid: a 3^3 convolution
reads a halo of one plane from each neighbour (zeros at the global ends,
where SAME pads), the instance norm is the plain one with its sums
all-reduced over the space group, a transposed convolution stays local,
and an up block relayouts its upsampled input where twice the coarse
layout differs from the fine one.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from nerf_mae_torch import kernels
from nerf_mae_torch.ops.res_norm import _InstanceNorm3d, norm_act, norm_add_act
from nerf_mae_torch.parallel import spatial as sp


def _to_ncdhw(x):
    return x.permute(0, 4, 1, 2, 3)


def _to_ndhwc(x):
    return x.permute(0, 2, 3, 4, 1)


class Conv3d(nn.Module):
    """Conv parameter holder, torch layout: weight [O, I, k, k, k], bias [O]."""

    spatial = None  # the mesh on a space axis (parallel.spatial.set_spatial)

    def __init__(self, in_ch: int, out_ch: int, k: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k, k, k, device=device))
        self.bias = nn.Parameter(torch.empty(out_ch, device=device))

    def forward(self, x: torch.Tensor, dtype: torch.dtype, stride: int = 1,
                add_bias: bool = True) -> torch.Tensor:
        """'SAME' cross-correlation at the compute dtype, NDHWC in and out;
        the bias is added in the compute dtype, as flax nn.Conv does, unless
        add_bias is False (the res block hands it to its norms). A
        stride pads as flax's SAME does: ceil(n / stride) outputs, the odd
        pad voxel after. On a space axis (stride 1 only) the slab takes a
        halo of k // 2 planes and only axes 2-3 are padded."""
        k = self.weight.shape[-1]
        w = self.weight.to(dtype)
        if self.spatial is not None:
            if stride != 1:
                raise NotImplementedError("a strided convolution is not sharded over space")
            if k > 1:
                x = sp.halo(x, k // 2, self.spatial)
            if x.shape[1] == 0:  # an empty slab: the halo left it empty
                return empty_result(x, self.weight.shape[0], dtype, self.weight, self.bias)
            y = F.conv3d(_to_ncdhw(x.to(dtype)), w, padding=(0, k // 2, k // 2))
        elif stride == 1:
            y = F.conv3d(_to_ncdhw(x.to(dtype)), w, padding=k // 2)
        else:
            pads = []
            for n in reversed(x.shape[1:4]):  # F.pad lists the last dim first
                total = max(0, (-(-n // stride) - 1) * stride + k - n)
                pads += [total // 2, total - total // 2]
            y = F.conv3d(F.pad(_to_ncdhw(x.to(dtype)), pads), w, stride=stride)
        y = _to_ndhwc(y)
        return y + self.bias.to(dtype) if add_bias else y


class ConvTranspose3d(nn.Module):
    """Transposed-conv holder, torch layout: weight [I, O, s, s, s]; stride
    = kernel = s, so every output voxel gets exactly one input voxel."""

    def __init__(self, in_ch: int, out_ch: int, s: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, s, s, s, device=device))
        self.bias = nn.Parameter(torch.empty(out_ch, device=device))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        s = self.weight.shape[-1]
        if x.shape[1] == 0:  # an empty slab (space axis)
            return empty_result(x, self.weight.shape[1], dtype, self.weight, self.bias,
                                scale=s)
        y = F.conv_transpose3d(_to_ncdhw(x.to(dtype)), self.weight.to(dtype), stride=s)
        return _to_ndhwc(y) + self.bias.to(dtype)


def empty_result(x, out_ch, dtype, *params, scale: int = 1):
    """The empty slab a convolution of an empty slab x gives (out_ch
    channels, axes 2-3 scaled), its graph joined to x and the parameters."""
    b, _, h, w, _ = x.shape
    return sp.empty_result((b, 0, h * scale, w * scale, out_ch), x, *params).to(dtype)


def instance_norm_3d(x: torch.Tensor, eps: float = 1e-5, mesh=None) -> torch.Tensor:
    """Per-sample, per-channel normalization over the spatial dims, no
    affine, population variance in f32 (torch nn.InstanceNorm3d defaults);
    the result in x's dtype. On a space axis (mesh) x is a slab and the
    statistics are the whole grid's."""
    return _InstanceNorm3d.apply(x, eps, mesh)


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


class UnetResBlock3D(nn.Module):
    """conv3 -> IN -> lrelu -> conv3 -> IN (+ 1x1 shortcut) -> lrelu.

    (reference: unetr_block.py:23-93; LeakyReLU slope 0.01)

    The convolutions run without their biases, which go to the norms
    (ops/res_norm.py): the fused kernels where kernels.wanted says so for
    `attention_impl` (SwinConfig's), else the plain composition.
    """

    spatial = None  # the mesh on a space axis

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 dtype: torch.dtype = torch.bfloat16, attention_impl: str = "auto",
                 device=None):
        super().__init__()
        self.dtype, self.attention_impl = dtype, attention_impl
        self.conv1 = Conv3d(in_ch, out_ch, kernel_size, device=device)
        self.conv2 = Conv3d(out_ch, out_ch, kernel_size, device=device)
        self.conv3 = (Conv3d(in_ch, out_ch, 1, device=device)
                      if in_ch != out_ch else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = dict(kernel=kernels.wanted(x, self.attention_impl, self.spatial),
                    mesh=self.spatial)
        h = norm_act(self.conv1(x, self.dtype, add_bias=False), self.conv1.bias, **norm)
        h = self.conv2(h, self.dtype, add_bias=False)
        if self.conv3 is not None:
            return norm_add_act(h, self.conv2.bias, self.conv3(x, self.dtype, add_bias=False),
                                self.conv3.bias, **norm)
        return norm_add_act(h, self.conv2.bias, x.to(h.dtype), **norm)


class UnetrUpBlock3D(nn.Module):
    """Transposed-conv upsample, optional skip concat, then a res block.

    (reference: unetr_block.py:119-200)
    """

    spatial = None  # the mesh on a space axis

    def __init__(self, in_ch: int, out_ch: int, upsample_factor: int = 2,
                 use_skip: bool = True, dtype: torch.dtype = torch.bfloat16,
                 attention_impl: str = "auto", device=None):
        super().__init__()
        self.dtype, self.use_skip = dtype, use_skip
        self.factor = upsample_factor
        self.transp_conv = ConvTranspose3d(in_ch, out_ch, upsample_factor,
                                           device=device)
        res_in = 2 * out_ch if use_skip else out_ch
        self.conv_block = UnetResBlock3D(res_in, out_ch, dtype=dtype,
                                         attention_impl=attention_impl, device=device)

    def forward(self, x: torch.Tensor,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        coarse = sp.grid_len(x)
        x = self.transp_conv(x, self.dtype)
        if self.spatial is not None:  # twice the coarse layout -> the fine one
            s = self.spatial.space
            x = sp.relayout(x, sp.scale_bounds(sp.even_bounds(coarse, s), self.factor),
                            sp.even_bounds(sp.grid_len(x), s), self.spatial)
        if self.use_skip:
            x = torch.cat([x, skip.to(x.dtype)], dim=-1)
        return self.conv_block(x)


class SubpixelHead3D(nn.Module):
    """Reconstruction head: res-block + 3^3 projection at the token grid,
    then depth-to-space to full resolution (the JAX package's default
    decoder; no reference counterpart, so its names are its own:
    `subpixel_head.res.*`, `subpixel_head.proj`)."""

    def __init__(self, in_ch: int, out_channels: int, patch: int = 4,
                 dtype: torch.dtype = torch.bfloat16, attention_impl: str = "auto",
                 device=None):
        super().__init__()
        self.out_channels, self.patch, self.dtype = out_channels, patch, dtype
        self.res = UnetResBlock3D(in_ch, in_ch, dtype=dtype, attention_impl=attention_impl,
                                  device=device)
        self.proj = Conv3d(in_ch, out_channels * patch**3, 3, device=device)

    def forward(self, x: torch.Tensor, patched: bool = False) -> torch.Tensor:
        b, t0, t1, t2 = x.shape[:4]  # t0: a slab's planes on a space axis
        p = self.patch
        h = self.proj(self.res(x), self.dtype)  # [B, T, T, T, p^3 * out]
        if patched:  # == patchify_3d(depth_to_space(h)), as one reshape
            return h.reshape(b, t0, t1, t2, p**3, self.out_channels)
        h = h.reshape(b, t0, t1, t2, p, p, p, self.out_channels)
        h = h.permute(0, 1, 4, 2, 5, 3, 6, 7)
        return h.reshape(b, t0 * p, t1 * p, t2 * p, self.out_channels)


class UnetOutBlock3D(nn.Module):
    """1x1x1 conv head (reference: unetr_block.py:96-116)."""

    def __init__(self, in_ch: int, out_channels: int,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.conv = Conv3d(in_ch, out_channels, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x, self.dtype)
