"""FCOS target assignment with padded GT boxes (counterpart of
nerf_mae_tpu/ops/fcos_targets.py).

Reference semantics (reference: nerf_rpn/model/fcos/loss.py:210-445):
per-location regression targets against every GT, center sampling inside a
stride-scaled region clamped to the (footprint) AABB, per-level object-size
ranges on the largest offset, the smallest-volume GT winning ties,
centerness = sqrt(prod(min/max per axis pair)).

GT boxes come as a padded [B, G, 6|7] tensor with a validity mask; the
assignment is one [B, L, G] computation. The JAX package broadcasts every
box to [B, L, G, 7] and derives its corners per location; here everything
that depends on the box alone (footprint AABB, volume, OBB midpoint offsets)
is made once per [B, G], the [B, L, G] work is a few scalar planes, and the
chosen box's 6|8 targets are formed for [B, L] only. Each target is the
same expression of the same inputs, so the numbers are those of the
broadcast form (tests/test_torch_det_ops.py holds them equal).
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from nerf_mae_torch.ops.fcos_box import obb_footprint_aabb, obb_midpoint_offsets

INF = 1e8

# per-level max-offset ranges (reference: fcos/loss.py:270-275)
OBJECT_SIZES_OF_INTEREST = ((-1.0, 16.0), (16.0, 32.0), (32.0, 64.0), (64.0, INF))


def level_locations(grid: Sequence[int], strides: Sequence[int]
                    ) -> Tuple[List[np.ndarray], np.ndarray, np.ndarray, np.ndarray]:
    """Static location geometry for a padded grid: (per-level [Li, 3]
    location arrays, concatenated [L, 3], stride per location [L], (lo, hi)
    size range per location [L, 2]). Locations are voxel centres,
    stride * idx + stride // 2 (reference: fcos/fcos.py:282-299)."""
    per_level, stride_vec, ranges = [], [], []
    for lvl, s in enumerate(strides):
        dims = [int(np.ceil(g / s)) for g in grid]
        ax = [np.arange(d, dtype=np.float32) * s + s // 2 for d in dims]
        g0, g1, g2 = np.meshgrid(*ax, indexing="ij")
        locs = np.stack([g0.reshape(-1), g1.reshape(-1), g2.reshape(-1)], axis=1)
        per_level.append(locs)
        stride_vec.append(np.full((locs.shape[0],), s, np.float32))
        lo, hi = OBJECT_SIZES_OF_INTEREST[min(lvl, len(OBJECT_SIZES_OF_INTEREST) - 1)]
        ranges.append(np.tile([[lo, hi]], (locs.shape[0], 1)).astype(np.float32))
    return (per_level, np.concatenate(per_level, 0), np.concatenate(stride_vec, 0),
            np.concatenate(ranges, 0))


@functools.lru_cache(maxsize=16)
def level_geometry(resolution: int, strides: Tuple[int, ...], device: torch.device):
    """level_locations of a resolution^3 grid as tensors on `device`:
    (per-level locations, locations [L, 3], strides [L], size ranges [L, 2])."""
    with torch.inference_mode(False):
        per_level, locs, st, ranges = level_locations((resolution,) * 3, strides)
        to = lambda a: torch.from_numpy(a).to(device)
        return [to(p) for p in per_level], to(locs), to(st), to(ranges)


def _center_sample_mask(aabbs: torch.Tensor, locations: torch.Tensor,
                        strides: torch.Tensor, radius: float) -> torch.Tensor:
    """[B, L, G] True where a location falls in the stride-scaled centre
    region of the GT, clamped to its extent (reference: fcos/loss.py:210-267).
    aabbs [B, G, 6]."""
    center = (aabbs[..., :3] + aabbs[..., 3:6]) / 2  # [B, G, 3]
    r = (strides * radius)[None, :, None]  # [1, L, 1]
    inside = None
    for a in range(3):
        c = center[:, None, :, a]  # [B, 1, G]
        loc = locations[None, :, None, a]  # [1, L, 1]
        lo = torch.maximum(c - r, aabbs[:, None, :, a])
        hi = torch.minimum(c + r, aabbs[:, None, :, a + 3])
        ok = ((loc - lo) > 0) & ((hi - loc) > 0)
        inside = ok if inside is None else inside & ok
    return inside


def assign_fcos_targets(
    locations: torch.Tensor,  # [L, 3] (all levels concatenated)
    strides: torch.Tensor,  # [L]
    size_ranges: torch.Tensor,  # [L, 2]
    gt_boxes: torch.Tensor,  # [B, G, 6] AABB or [B, G, 7] OBB (padded)
    gt_valid: torch.Tensor,  # [B, G] bool
    center_sampling_radius: float = 1.5,
    use_obb: bool = False,
):
    """Returns (labels [B, L] float32 in {0, 1}, reg_targets [B, L, 6|8] in
    voxel units: divide by the stride for norm_reg_targets, as the reference
    normalizes per level at fcos/loss.py:314-316). No gradient."""
    with torch.no_grad():
        aabbs = obb_footprint_aabb(gt_boxes) if use_obb else gt_boxes  # [B, G, 6]
        # the 6 distances of every (location, GT) pair, one [B, L, G] plane each
        dist = []
        for a in range(3):
            dist.append(locations[None, :, None, a] - aabbs[:, None, :, a])
        for a in range(3):
            dist.append(aabbs[:, None, :, a + 3] - locations[None, :, None, a])
        max_off = dist[0]
        for d in dist[1:]:
            max_off = torch.maximum(max_off, d)
        if center_sampling_radius > 0:
            is_in = _center_sample_mask(aabbs, locations, strides, center_sampling_radius)
        else:
            is_in = dist[0] > 0
            for d in dist[1:]:
                is_in = is_in & (d > 0)
        del dist
        in_level = ((max_off >= size_ranges[None, :, 0:1])
                    & (max_off <= size_ranges[None, :, 1:2]))
        del max_off

        whd = aabbs[..., 3:6] - aabbs[..., 0:3]
        volumes = whd[..., 0] * whd[..., 1] * whd[..., 2]  # [B, G]
        cost = torch.where(is_in & in_level & gt_valid[:, None, :], volumes[:, None, :],
                           torch.full_like(volumes[:, None, :], INF))
        del is_in, in_level
        best = torch.argmin(cost, dim=-1)  # [B, L]; the first minimum, as jnp.argmin
        labels = (torch.gather(cost, -1, best[..., None])[..., 0] < INF).float()
        del cost

        chosen = torch.gather(aabbs, 1, best[..., None].expand(-1, -1, 6))  # [B, L, 6]
        loc = locations[None]
        reg = torch.cat([loc - chosen[..., :3], chosen[..., 3:6] - loc], dim=-1)
        if use_obb:
            mid = obb_midpoint_offsets(gt_boxes)  # [B, G, 2]
            reg = torch.cat([reg, torch.gather(mid, 1, best[..., None].expand(-1, -1, 2))],
                            dim=-1)
    return labels, reg


def centerness_targets(reg: torch.Tensor) -> torch.Tensor:
    """sqrt of the product of the per-axis min/max offset ratios
    (reference: fcos/loss.py:438-445); reg [..., >= 6]."""

    def ratio(a, b):
        p = torch.stack([reg[..., a], reg[..., b]], -1)
        return p.amin(-1) / torch.clamp(p.amax(-1), min=1e-9)

    return torch.sqrt(torch.clamp(ratio(0, 3) * ratio(1, 4) * ratio(2, 5), min=0.0))
