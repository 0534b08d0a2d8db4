"""FCOS box encoding/decoding: AABB distance offsets and OBB midpoint
offsets (counterpart of nerf_mae_tpu/ops/fcos_box.py).

The reference's parameterizations (reference: nerf_rpn/model/fcos/
utils.py:12-105 decode_fcos_obb/encode_fcos_obb; fcos/inference.py:106-117
AABB decode), elementwise over leading dims. AABB: 6 non-negative distances
(l, t, f, r, b, bk) from a location to the box faces. OBB adds (alpha, beta),
the midpoint offsets of the rotated footprint relative to its 2D AABB.
"""

from __future__ import annotations

import torch

from nerf_mae_torch.ops.rotated_iou import obb_corners


def decode_fcos_aabb(locations: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """locations [..., 3] + offsets [..., 6] -> AABB [..., 6]."""
    return torch.cat([locations - offsets[..., 0:3], locations + offsets[..., 3:6]], dim=-1)


def encode_fcos_aabb(locations: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """locations [..., 3] + AABB [..., 6] -> 6 distance offsets."""
    return torch.cat([locations - boxes[..., 0:3], boxes[..., 3:6] - locations], dim=-1)


def obb_footprint_aabb(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 7] OBB -> [..., 6] AABB of its footprint x z-extent
    (reference: fcos/loss.py:337-340)."""
    corners = obb_corners(boxes)  # [..., 4, 2]
    return torch.stack([
        corners[..., 0].amin(-1), corners[..., 1].amin(-1), boxes[..., 2] - boxes[..., 5] / 2,
        corners[..., 0].amax(-1), corners[..., 1].amax(-1), boxes[..., 2] + boxes[..., 5] / 2,
    ], dim=-1)


def obb_midpoint_offsets(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 7] OBB -> [..., 2] (alpha, beta): where the footprint's corners
    touching its AABB's top edge (max y) and right edge (max x) lie, relative
    to the box centre, as fractions of the AABB's extent (reference:
    fcos/utils.py:64-105). They depend on the box alone."""
    corners = obb_corners(boxes)
    xs, ys = corners[..., 0], corners[..., 1]
    xmax, xmin = xs.amax(-1), xs.amin(-1)
    ymax, ymin = ys.amax(-1), ys.amin(-1)
    # corner-case handling mirrors the reference
    xt = torch.where(ymax[..., None] - ys > 0.1, torch.full_like(xs, -1e6), xs)
    yt = torch.where(xmax[..., None] - xs > 0.1, torch.full_like(ys, 1e6), ys)
    vx = xt.amax(-1)
    vy = yt.amin(-1)
    near_aabb = torch.isclose(vx, xmax) & torch.isclose(vy, ymin)
    vx = torch.where(near_aabb, xmax, vx)
    vy = torch.where(near_aabb, ymin, vy)
    alpha = (vx - boxes[..., 0]) / torch.clamp(xmax - xmin, min=1e-7)
    beta = (vy - boxes[..., 1]) / torch.clamp(ymax - ymin, min=1e-7)
    return torch.stack([alpha, beta], dim=-1)


def encode_fcos_obb(locations: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """locations [..., 3] + OBB [..., 7] -> the 8-parameter midpoint-offset
    encoding (reference: fcos/utils.py:64-105): the 6 distances to the faces
    of obb_footprint_aabb, then obb_midpoint_offsets. Leading dims
    broadcast, so [L, 1, 3] locations against [1, G, 7] boxes make the
    per-box quantities once."""
    aabb = obb_footprint_aabb(boxes)
    dist = encode_fcos_aabb(locations, aabb)
    mid = obb_midpoint_offsets(boxes).expand(dist.shape[:-1] + (2,))
    return torch.cat([dist, mid], dim=-1)


def _norm(v: torch.Tensor) -> torch.Tensor:
    # grad-safe: sqrt has a NaN gradient at exactly 0, which poisons the
    # backward even under a torch.where downstream
    return torch.sqrt((v * v).sum(-1) + 1e-12)


def decode_fcos_obb(locations: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """locations [..., 3] + 8-parameter offsets -> OBB [..., 7]
    (reference: fcos/utils.py:12-61)."""
    x0 = locations[..., 0] - offsets[..., 0]
    y0 = locations[..., 1] - offsets[..., 1]
    z0 = locations[..., 2] - offsets[..., 2]
    x1 = locations[..., 0] + offsets[..., 3]
    y1 = locations[..., 1] + offsets[..., 4]
    z1 = locations[..., 2] + offsets[..., 5]
    vx = (x1 + x0) / 2 + offsets[..., 6] * (x1 - x0)
    vy = (y1 + y0) / 2 + offsets[..., 7] * (y1 - y0)
    vx = torch.minimum(torch.maximum(vx, x0), x1)
    vy = torch.minimum(torch.maximum(vy, y0), y1)

    cx, cy, cz = (x0 + x1) / 2, (y0 + y1) / 2, (z0 + z1) / 2
    v0 = torch.stack([vx - cx, y1 - cy], dim=-1)  # top-edge midpoint
    v1 = torch.stack([x1 - cx, vy - cy], dim=-1)  # right-edge midpoint
    d0 = _norm(v0)
    d1 = _norm(v1)
    dmax = torch.maximum(d0, d1)
    v0 = v0 / (d0[..., None] + 1e-7) * dmax[..., None]
    v1 = v1 / (d1[..., None] + 1e-7) * dmax[..., None]

    l = _norm(v0 - v1)
    mid = (v0 + v1) / 2
    w = _norm(mid) * 2
    h = z1 - z0
    degenerate = (mid[..., 0].abs() < 1e-9) & (mid[..., 1].abs() < 1e-9)
    mid_x = torch.where(degenerate, torch.full_like(mid[..., 0], 1e-7), mid[..., 0])
    mid_y = torch.where(degenerate, torch.zeros_like(mid[..., 1]), mid[..., 1])
    theta = torch.atan2(mid_y, mid_x)
    return torch.stack([cx, cy, cz, w, l, h, theta], dim=-1)
