"""Axis-aligned 3D box utilities (counterpart of nerf_mae_tpu/ops/boxes.py).

Pairwise AABB IoU, volume, clipping, small-box filtering and the AABB <->
OBB conversions, on [N, 6] (x0, y0, z0, x1, y1, z1) and [N, 7] (cx, cy, cz,
w, l, h, theta) tensors (reference: nerf_rpn/model/utils.py:215-400,
nerf_rpn/model/fcos/utils.py:161-290).
"""

from __future__ import annotations

import torch


def box_volume(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 6] -> [...] volumes."""
    whd = boxes[..., 3:6] - boxes[..., 0:3]
    return whd[..., 0] * whd[..., 1] * whd[..., 2]


def box_iou_aabb(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU: [..., N, 6] x [..., M, 6] -> [..., N, M], over any
    matching leading dims (reference: fcos/utils.py:229-298
    _box_inter_union_3d)."""
    lt = torch.maximum(boxes1[..., :, None, :3], boxes2[..., None, :, :3])
    rb = torch.minimum(boxes1[..., :, None, 3:6], boxes2[..., None, :, 3:6])
    whd = torch.clamp(rb - lt, min=0.0)
    inter = whd[..., 0] * whd[..., 1] * whd[..., 2]
    union = box_volume(boxes1)[..., :, None] + box_volume(boxes2)[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def clip_boxes_to_grid(boxes: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """Clamp [..., 6] boxes into [0, size] per axis; `size` [3] or broadcastable
    to boxes[..., :3] (reference: fcos/utils.py:186-209)."""
    size = torch.as_tensor(size, dtype=boxes.dtype, device=boxes.device)
    zero = torch.zeros_like(size)
    lo = torch.minimum(torch.maximum(boxes[..., 0:3], zero), size)
    hi = torch.minimum(torch.maximum(boxes[..., 3:6], zero), size)
    return torch.cat([lo, hi], dim=-1)


def small_box_mask(boxes: torch.Tensor, min_size: float) -> torch.Tensor:
    """True where ALL sides >= min_size; [..., 6] AABB or [..., 7] OBB
    (reference: fcos/utils.py:161-183)."""
    if boxes.shape[-1] == 6:
        sides = boxes[..., 3:6] - boxes[..., 0:3]
    else:
        sides = boxes[..., 3:6]
    return (sides >= min_size).all(dim=-1)


def aabb_to_obb(boxes: torch.Tensor) -> torch.Tensor:
    """[N, 6] AABB -> [N, 7] (cx, cy, cz, w, l, h, 0)."""
    c = (boxes[:, :3] + boxes[:, 3:6]) / 2
    s = boxes[:, 3:6] - boxes[:, :3]
    return torch.cat([c, s, torch.zeros_like(boxes[:, :1])], dim=-1)


def obb_to_aabb(boxes: torch.Tensor) -> torch.Tensor:
    """[N, 7] OBB -> [N, 6] enclosing AABB (z-rotation only)."""
    cx, cy, cz = boxes[:, 0], boxes[:, 1], boxes[:, 2]
    w, l, h, theta = boxes[:, 3], boxes[:, 4], boxes[:, 5], boxes[:, 6]
    cos, sin = torch.cos(theta).abs(), torch.sin(theta).abs()
    ex = (w * cos + l * sin) / 2
    ey = (w * sin + l * cos) / 2
    return torch.stack([cx - ex, cy - ey, cz - h / 2, cx + ex, cy + ey, cz + h / 2], dim=-1)


def unit_box_where(mask: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """boxes [..., 6|7] where mask [...], else a unit box at the origin: the
    placeholder the IoU losses and the coders take where a box is not used
    (a degenerate box has NaN log-size deltas and gradients, which a later
    mask does not stop: 0 * NaN = NaN)."""
    unit = torch.zeros(boxes.shape[-1], dtype=boxes.dtype, device=boxes.device)
    unit[3:6] = 1.0  # filled on the device: a host tensor's copy would wait for the card
    return torch.where(mask[..., None], boxes, unit)
