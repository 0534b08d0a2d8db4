"""Rotated 3D RoI align and the FPN level of a box (counterpart of
nerf_mae_tpu/ops/roi_align.py; reference: nerf_rpn/model/rotated_align/
cuda_3d/ROIAlignRotated3D_cuda.cu:14-235, model/detector.py:170-438
ROIPool, model/level_mapper.py:21-80).

Each RoI gets a fixed S^3 lattice of sample points in its (enlarged,
rotated) box frame, trilinear-sampled from the FPN level its volume maps
to. The JAX package samples every level and masks by the RoI's level; the
features are finite, so gathering only from each RoI's own level gives the
same values (and gradients) at a quarter of the gathers. Plain PyTorch:
one gather over the levels' rows, differentiable through its scatter-add.
"""

from __future__ import annotations

from typing import List, Sequence

import torch


def fpn_level_for_boxes(boxes: torch.Tensor, k_min: int = 0, k_max: int = 3,
                        canonical_scale: int = 160, canonical_level: int = 4) -> torch.Tensor:
    """FPN Eqn. (1) by cube-root volume (reference: level_mapper.py:46-58):
    [..., 7] OBB (w, l, h at 3:6) or [..., 6] AABB -> int64 level index in
    [0, k_max - k_min]. The +1e-6 inside the log keeps a cube root an ulp
    off an exact boundary (sides 10, 20, 40, 80 at scale 160) on its level."""
    if boxes.shape[-1] == 7:
        vol = boxes[..., 3] * boxes[..., 4] * boxes[..., 5]
    else:
        whd = boxes[..., 3:6] - boxes[..., 0:3]
        vol = whd[..., 0] * whd[..., 1] * whd[..., 2]
    s = torch.pow(torch.clamp(vol, min=1e-9), 1.0 / 3.0)
    lvl = torch.floor(canonical_level + torch.log2(s / canonical_scale + 1e-6))
    return (torch.clamp(lvl, k_min, k_max) - k_min).long()


def _trilinear_sample(flat: torch.Tensor, base: torch.Tensor, dims: torch.Tensor,
                      pts: torch.Tensor) -> torch.Tensor:
    """Trilinear samples of grids stored row by row in flat [M, C]: the
    grid of point n starts at row base[n] and has extents dims[n] (W, L, H;
    int64), pts [N, 3] are fractional voxel coordinates in it -> [N, C],
    float32 at least. Samples outside [-1, size] on an axis give zero, the
    others are clamped into the grid (the CUDA kernel's empty handling,
    ROIAlignRotated3D_cuda.cu:14-40)."""
    hi = (dims - 1).to(pts.dtype)
    inside = ((pts >= -1) & (pts <= hi + 1)).all(-1)
    p = torch.minimum(torch.clamp(pts, min=0.0), hi)
    f = torch.floor(p)
    d = p - f
    f = f.long()
    out = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                cx = torch.minimum(f[:, 0] + dx, dims[:, 0] - 1)
                cy = torch.minimum(f[:, 1] + dy, dims[:, 1] - 1)
                cz = torch.minimum(f[:, 2] + dz, dims[:, 2] - 1)
                row = base + (cx * dims[:, 1] + cy) * dims[:, 2] + cz
                wgt = ((d[:, 0] if dx else 1 - d[:, 0]) * (d[:, 1] if dy else 1 - d[:, 1])
                       * (d[:, 2] if dz else 1 - d[:, 2]))
                out = out + flat[row] * wgt[:, None]
    return out * inside[:, None]


def _per_level(levels: torch.Tensor, values: Sequence[int]) -> torch.Tensor:
    """levels [N] -> values[levels[n]] (int64), without a host copy."""
    out = torch.zeros_like(levels)
    for lvl, v in enumerate(values):
        out = torch.where(levels == lvl, v, out)
    return out


def roi_align_rotated_3d(features: List[torch.Tensor], rois: torch.Tensor,
                         roi_levels: torch.Tensor, strides: Sequence[int],
                         output_size: int = 5, enlarge_scale: float = 0.2) -> torch.Tensor:
    """Per-level features [B, W_l, L_l, H_l, C], rois [B, R, 7] (x, y, z,
    w, l, h, theta in voxels) and their levels [B, R] -> [B, R, S, S, S, C]:
    an S^3 lattice of bin centres over the box enlarged by enlarge_scale,
    rotated by theta about z, trilinear-sampled from the RoI's level (one
    gather over the levels' rows, so no host synchronisation)."""
    b, r = rois.shape[:2]
    s3 = output_size ** 3
    rois, lvl = rois.reshape(b * r, 7), roi_levels.reshape(b * r).long()
    size = rois[:, 3:6] * (1.0 + enlarge_scale)
    ax = torch.arange(output_size, device=rois.device, dtype=rois.dtype)
    ax = (ax + 0.5) / output_size - 0.5
    gx, gy, gz = torch.meshgrid(ax, ax, ax, indexing="ij")
    lattice = torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)], dim=1)  # [S^3, 3]
    local = lattice[None] * size[:, None, :]  # [N, S^3, 3]
    cos = torch.cos(rois[:, 6])[:, None]
    sin = torch.sin(rois[:, 6])[:, None]
    wx = local[..., 0] * cos - local[..., 1] * sin + rois[:, 0:1]
    wy = local[..., 0] * sin + local[..., 1] * cos + rois[:, 1:2]
    wz = local[..., 2] + rois[:, 2:3]
    world = torch.stack([wx, wy, wz], dim=-1)  # [N, S^3, 3] voxel coordinates

    flat = torch.cat([f.reshape(-1, f.shape[-1]) for f in features])
    rows = [f.shape[1] * f.shape[2] * f.shape[3] for f in features]
    offsets = [sum(f.shape[0] * n for f, n in zip(features[:i], rows[:i]))
               for i in range(len(features))]
    scene = torch.arange(b, device=rois.device).repeat_interleave(r)
    base = _per_level(lvl, offsets) + scene * _per_level(lvl, rows)
    dims = torch.stack([_per_level(lvl, [f.shape[1 + a] for f in features]) for a in range(3)],
                       dim=-1)
    stride = _per_level(lvl, list(strides)).to(world.dtype)
    pts = world / stride[:, None, None]
    out = _trilinear_sample(flat, base.repeat_interleave(s3), dims.repeat_interleave(s3, dim=0),
                            pts.reshape(-1, 3))
    return out.reshape(b, r, output_size, output_size, output_size, -1)


def aabb_to_rois7(rois_aabb: torch.Tensor) -> torch.Tensor:
    """[..., 6] corners -> [..., 7] (centre, size, theta 0)."""
    c = (rois_aabb[..., :3] + rois_aabb[..., 3:6]) / 2
    whd = rois_aabb[..., 3:6] - rois_aabb[..., :3]
    return torch.cat([c, whd, torch.zeros_like(c[..., :1])], dim=-1)


def roi_align_3d(features: List[torch.Tensor], rois_aabb: torch.Tensor, roi_levels: torch.Tensor,
                 strides: Sequence[int], output_size: int = 5,
                 enlarge_scale: float = 0.2) -> torch.Tensor:
    """The axis-aligned variant: rois [B, R, 6] corners (the reference's
    normal_forward pooling path, detector.py:407-438, as align sampling)."""
    return roi_align_rotated_3d(features, aabb_to_rois7(rois_aabb), roi_levels, strides,
                                output_size, enlarge_scale)
