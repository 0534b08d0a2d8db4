"""Box delta coders of the anchor RPN and the RCNN (counterpart of
nerf_mae_tpu/ops/coders.py): AABB centre / log-size deltas (reference:
nerf_rpn/model/coder/AABB_coder.py:7-140), OBB-to-OBB deltas in the RoI's
rotated frame (coder/rotated_coder.py:13-122) and the 8 midpoint-offset
deltas between an AABB anchor and an OBB (coder/midpoint_offset_coder.py:
106-223). Elementwise over [..., N, dims].
"""

from __future__ import annotations

import math

import torch

from nerf_mae_torch.ops.obb import obb2hbb, obb2poly, rectpoly2obb

BBOX_XFORM_CLIP = math.log(2000.0)


def _centre_size(boxes: torch.Tensor):
    size = boxes[..., 3:6] - boxes[..., 0:3]
    return boxes[..., 0:3] + 0.5 * size, size


def encode_aabb_deltas(gt: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """gt [..., 6], anchors [..., 6] -> deltas [..., 6]."""
    ac, aw = _centre_size(anchors)
    gc, gw = _centre_size(gt)
    return torch.cat([(gc - ac) / aw, torch.log(gw / aw)], dim=-1)


def decode_aabb_deltas(deltas: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """deltas [..., 6], anchors [..., 6] -> boxes [..., 6]."""
    ac, aw = _centre_size(anchors)
    ctr = deltas[..., 0:3] * aw + ac
    size = torch.exp(torch.clamp(deltas[..., 3:6], max=BBOX_XFORM_CLIP)) * aw
    return torch.cat([ctr - size / 2, ctr + size / 2], dim=-1)


def encode_rotated_deltas(gt7: torch.Tensor, rois7: torch.Tensor) -> torch.Tensor:
    """OBB gt [..., 7] against OBB RoIs [..., 7] -> 7 deltas in the RoI's
    frame (reference: rotated_coder.py:13-48)."""
    coord = gt7[..., 0:3] - rois7[..., 0:3]
    cos, sin = torch.cos(rois7[..., 6]), torch.sin(rois7[..., 6])
    dx = (cos * coord[..., 0] + sin * coord[..., 1]) / rois7[..., 3]
    dy = (-sin * coord[..., 0] + cos * coord[..., 1]) / rois7[..., 4]
    dz = coord[..., 2] / rois7[..., 5]
    dsize = torch.log(gt7[..., 3:6] / rois7[..., 3:6])
    dtheta = (gt7[..., 6] - rois7[..., 6]) / (2 * math.pi)
    return torch.cat([torch.stack([dx, dy, dz], -1), dsize, dtheta[..., None]], dim=-1)


def decode_rotated_deltas(deltas: torch.Tensor, rois7: torch.Tensor) -> torch.Tensor:
    """Inverse of encode_rotated_deltas, the angle canonicalized into
    (-pi/2, pi/2] (reference: rotated_coder.py:50-122)."""
    cos, sin = torch.cos(rois7[..., 6]), torch.sin(rois7[..., 6])
    dx = deltas[..., 0] * rois7[..., 3]
    dy = deltas[..., 1] * rois7[..., 4]
    ctr_x = dx * cos - dy * sin + rois7[..., 0]
    ctr_y = dx * sin + dy * cos + rois7[..., 1]
    ctr_z = deltas[..., 2] * rois7[..., 5] + rois7[..., 2]
    size = rois7[..., 3:6] * torch.exp(torch.clamp(deltas[..., 3:6], max=BBOX_XFORM_CLIP))
    theta = torch.remainder(deltas[..., 6] * 2 * math.pi + rois7[..., 6], math.pi)
    theta = torch.where(theta > math.pi / 2, theta - math.pi, theta)
    return torch.cat([torch.stack([ctr_x, ctr_y, ctr_z], -1), size, theta[..., None]], dim=-1)


def encode_midpoint_offset(gt7: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """OBB gt [..., 7] against AABB anchors [..., 6] -> 8 deltas (dx dy dz
    dw dh dd da db) (reference: midpoint_offset_coder.py:106-158)."""
    ac, aw = _centre_size(anchors)
    gt2d = gt7[..., [0, 1, 3, 4, 6]]
    hbb = obb2hbb(gt2d)
    poly = obb2poly(gt2d)
    gx = (hbb[..., 0] + hbb[..., 2]) * 0.5
    gy = (hbb[..., 1] + hbb[..., 3]) * 0.5
    gw = hbb[..., 2] - hbb[..., 0]
    gh = hbb[..., 3] - hbb[..., 1]
    xs, ys = poly[..., 0::2], poly[..., 1::2]
    y_min = ys.amin(-1, keepdim=True)
    x_max = xs.amax(-1, keepdim=True)
    far = torch.full_like(xs, -1000.0)
    ga = torch.where(torch.abs(ys - y_min) > 0.1, far, xs).amax(-1)
    gb = torch.where(torch.abs(xs - x_max) > 0.1, far, ys).amax(-1)
    return torch.stack([
        (gx - ac[..., 0]) / aw[..., 0], (gy - ac[..., 1]) / aw[..., 1],
        (gt7[..., 2] - ac[..., 2]) / aw[..., 2], torch.log(gw / aw[..., 0]),
        torch.log(gh / aw[..., 1]), torch.log(gt7[..., 5] / aw[..., 2]),
        (ga - gx) / gw, (gb - gy) / gh], dim=-1)


def decode_midpoint_offset(deltas: torch.Tensor, anchors: torch.Tensor,
                           wh_ratio_clip: float = 16 / 1000) -> torch.Tensor:
    """8 deltas + AABB anchors -> OBB [..., 7], the polygon made a rectangle
    by scaling each vertex to the longest diagonal (reference:
    midpoint_offset_coder.py:160-223)."""
    max_ratio = abs(math.log(wh_ratio_clip))
    ac, aw = _centre_size(anchors)
    d_size = torch.clamp(deltas[..., 3:6], -max_ratio, max_ratio)
    gw = aw[..., 0] * torch.exp(d_size[..., 0])
    gh = aw[..., 1] * torch.exp(d_size[..., 1])
    gd = aw[..., 2] * torch.exp(d_size[..., 2])
    gx = ac[..., 0] + aw[..., 0] * deltas[..., 0]
    gy = ac[..., 1] + aw[..., 1] * deltas[..., 1]
    gz = ac[..., 2] + aw[..., 2] * deltas[..., 2]
    x1, y1 = gx - gw / 2, gy - gh / 2
    x2, y2 = gx + gw / 2, gy + gh / 2
    da = torch.clamp(deltas[..., 6], -0.5, 0.5)
    db = torch.clamp(deltas[..., 7], -0.5, 0.5)
    ga, _ga = gx + da * gw, gx - da * gw
    gb, _gb = gy + db * gh, gy - db * gh
    polys = torch.stack([ga, y1, x2, gb, _ga, y2, x1, _gb], dim=-1)
    center = torch.stack([gx, gy] * 4, dim=-1)
    cp = polys - center
    diag = torch.sqrt(cp[..., 0::2] ** 2 + cp[..., 1::2] ** 2 + 1e-12)
    scale = diag.amax(-1, keepdim=True) / torch.clamp(diag, min=1e-7)
    cp = cp * torch.repeat_interleave(scale, 2, dim=-1)
    obb2d = rectpoly2obb(cp + center)
    return torch.cat([obb2d[..., 0:2], gz[..., None], obb2d[..., 2:4], gd[..., None],
                      obb2d[..., 4:5]], dim=-1)
