"""Oriented-box <-> polygon / AABB conversions, z-rotation only
(counterpart of nerf_mae_tpu/ops/obb.py; reference:
nerf_rpn/model/coder/misc.py:1-100): obb2poly, obb2hbb(_3d), rectpoly2obb
with the w >= h angle regularization. Elementwise over any leading dims.
2D OBBs are [..., 5] = (x, y, w, h, theta); 3D ones [..., 7]. The
projection loss's obb2points_3d lives in ops/projection.py.
"""

from __future__ import annotations

import math

import torch

PI = math.pi


def regular_theta(theta: torch.Tensor, start: float = -PI / 2) -> torch.Tensor:
    """Wrap theta into [start, start + pi) (reference: misc.py:5-12)."""
    return torch.remainder(theta - start, PI) + start


def regular_obb(obb5: torch.Tensor) -> torch.Tensor:
    """Canonicalize: w >= h, theta moved by pi/2 where they swap
    (reference: misc.py:14-20)."""
    x, y, w, h, t = obb5.unbind(-1)
    tr = torch.where(w > h, t, t + PI / 2)
    return torch.stack([x, y, torch.maximum(w, h), torch.minimum(w, h), regular_theta(tr)],
                       dim=-1)


def obb2poly(obb5: torch.Tensor) -> torch.Tensor:
    """[..., 5] -> [..., 8] corners (x1 y1 x2 y2 x3 y3 x4 y4)
    (reference: misc.py:47-60)."""
    c, w, h, t = obb5[..., 0:2], obb5[..., 2:3], obb5[..., 3:4], obb5[..., 4:5]
    cos, sin = torch.cos(t), torch.sin(t)
    v1 = torch.cat([w / 2 * cos, -w / 2 * sin], dim=-1)
    v2 = torch.cat([-h / 2 * sin, -h / 2 * cos], dim=-1)
    return torch.cat([c + v1 + v2, c + v1 - v2, c - v1 - v2, c - v1 + v2], dim=-1)


def obb2hbb(obb5: torch.Tensor) -> torch.Tensor:
    """Smallest enclosing 2D AABB [..., 4] (reference: misc.py:77-84)."""
    c, w, h, t = obb5[..., 0:2], obb5[..., 2:3], obb5[..., 3:4], obb5[..., 4:5]
    cos, sin = torch.cos(t), torch.sin(t)
    bias = torch.cat([torch.abs(w / 2 * cos) + torch.abs(h / 2 * sin),
                      torch.abs(w / 2 * sin) + torch.abs(h / 2 * cos)], dim=-1)
    return torch.cat([c - bias, c + bias], dim=-1)


def obb2hbb_3d(obb7: torch.Tensor) -> torch.Tensor:
    """[..., 7] OBB -> [..., 6] enclosing AABB (reference: misc.py:86-94)."""
    hbb = obb2hbb(obb7[..., [0, 1, 3, 4, 6]])
    z0 = obb7[..., 2:3] - obb7[..., 5:6] / 2
    z1 = obb7[..., 2:3] + obb7[..., 5:6] / 2
    return torch.cat([hbb[..., 0:2], z0, hbb[..., 2:4], z1], dim=-1)


def rectpoly2obb(polys: torch.Tensor) -> torch.Tensor:
    """[..., 8] rectangular polygon -> [..., 5] canonical OBB
    (reference: misc.py:22-45)."""
    theta = torch.atan2(-(polys[..., 3] - polys[..., 1]), polys[..., 2] - polys[..., 0] + 1e-7)
    cos, sin = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
    x = polys[..., 0::2].mean(-1)
    y = polys[..., 1::2].mean(-1)
    px = polys[..., 0::2] - x[..., None]
    py = polys[..., 1::2] - y[..., None]
    # theta is the negated edge angle: a rotation by +theta aligns the
    # polygon with the axes (reference: misc.py:25-31)
    rx = px * cos - py * sin
    ry = px * sin + py * cos
    w = rx.amax(-1) - rx.amin(-1)
    h = ry.amax(-1) - ry.amin(-1)
    return regular_obb(torch.stack([x, y, w, h, theta], dim=-1))
