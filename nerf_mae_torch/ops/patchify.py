"""Patchify / unpatchify for channel-last 3D rgbsigma grids
(counterpart of nerf_mae_tpu/ops/patchify.py).

Reference semantics: patchify_3d / unpatchify_3d_full
(reference: nerf_mae/model/mae/swin_mae3d.py:1384-1430) on [B, H, W, D, C].
"""

from __future__ import annotations

import numpy as np
import torch


def patchify_3d(x: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, R, R, R, C] -> [B, r, r, r, patch^3, C] with r = R // patch
    (each axis on its own: a slab [B, H, R, R, C] gives [B, H // patch,
    ...]).

    Voxel order inside a patch is (h, w, d) row-major, matching the
    reference's einops 'n c h p w q l r -> n h w l (p q r) c'.
    """
    b, h, w, d, c = x.shape
    rh, rw, rd = h // patch, w // patch, d // patch
    x = x.reshape(b, rh, patch, rw, patch, rd, patch, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b, rh, rw, rd, patch**3, c)


def patchify_np(x: np.ndarray, patch: int) -> np.ndarray:
    """Host-side (numpy) patchify_3d, same ordering."""
    b, h, w, d, c = x.shape
    r = h // patch
    x = np.ascontiguousarray(x).reshape(b, r, patch, r, patch, r, patch, c)
    x = x.transpose(0, 1, 3, 5, 2, 4, 6, 7)
    return np.ascontiguousarray(x).reshape(b, r, r, r, patch**3, c)


def maybe_unflatten_patches(x: torch.Tensor, patch: int,
                            channels: int = 4) -> torch.Tensor:
    """Accept the channel-flat patch-major layout.

    [B, T, T, T, patch^3 * channels] -> [B, T, T, T, patch^3, channels];
    6-D patched input and the voxel grid [B, R, R, R, channels] pass through.
    """
    if x.ndim == 5 and x.shape[-1] == patch ** 3 * channels:
        return x.reshape(*x.shape[:4], patch ** 3, channels)
    return x


def unpatchify_3d(x: torch.Tensor, patch: int) -> torch.Tensor:
    """Inverse of patchify_3d: [B, r, r, r, patch^3, C] -> [B, R, R, R, C]."""
    b, r, _, _, _, c = x.shape
    x = x.reshape(b, r, r, r, patch, patch, patch, c)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, r * patch, r * patch, r * patch, c)


def voxel_validity_mask(sizes: torch.Tensor, resolution: int, planes=None) -> torch.Tensor:
    """[B, 3] per-sample true grid sizes -> [B, R, R, R] bool, True inside
    the un-padded scene extent; `planes` (lo, hi) keeps those planes of
    axis 1 (a slab on a space axis)."""
    ih = torch.arange(resolution, device=sizes.device)
    lo, hi = planes or (0, resolution)
    valid_h = ih[None, lo:hi] < sizes[:, 0:1]  # [B, R]
    valid_w = ih[None, :] < sizes[:, 1:2]
    valid_d = ih[None, :] < sizes[:, 2:3]
    return (
        valid_h[:, :, None, None]
        & valid_w[:, None, :, None]
        & valid_d[:, None, None, :]
    )
