"""Differentiable rotated-box IoU (z-axis rotation), plain PyTorch
(counterpart of nerf_mae_tpu/ops/rotated_iou.py).

The same branch-free formulation as the JAX package: the 2D intersection
polygon of two rectangles has <= 8 vertices drawn from 24 candidates (8
corners inside the other box + 16 edge-pair intersections), which are
angle-sorted around the valid vertices' centroid (stable sort, invalid
candidates last) and measured with a shoelace sum whose closing edges
contribute zero. Everything is elementwise over a leading batch shape, so the
same code serves the per-location loss and the pairwise IoU matrix, which is
computed in row chunks to bound its [rows, M, 24, 2] temporaries.

Boxes are [..., 7] = (x, y, z, w, l, h, theta).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_EPS = 1e-8
_XYWLT = [0, 1, 3, 4, 6]
# pairs per chunk of the pairwise matrix: each [pairs, 24, 2] float32
# temporary of the polygon stays at 192 MiB
PAIRS_PER_CHUNK = 1 << 20


def _enclosing_candidate_tables():
    """Static (24, 2) line and (24, 6) rest-point index tables for the
    smallest enclosing box: every pair of the 8 corners except the 4 box
    diagonals is a candidate hull edge
    (reference: nerf_rpn/model/rotated_iou/min_enclosing_box.py:25-50)."""
    skip = {(0, 2), (1, 3), (5, 7), (4, 6)}
    lines, points = [], []
    for i in range(8):
        for j in range(i + 1, 8):
            if (i, j) in skip:
                continue
            lines.append([i, j])
            points.append([k for k in range(8) if k not in (i, j)])
    return np.array(lines, np.int64), np.array(points, np.int64)


_ENC_LINES, _ENC_POINTS = _enclosing_candidate_tables()


@functools.lru_cache(maxsize=8)
def _enclosing_tables(device: torch.device):
    """The index tables on `device`, made once (a copy from host memory in
    the loss would wait for the card)."""
    with torch.inference_mode(False):
        return torch.from_numpy(_ENC_LINES).to(device), torch.from_numpy(_ENC_POINTS).to(device)


def box2corners(box5: torch.Tensor) -> torch.Tensor:
    """[..., 5] (x, y, w, h, alpha) -> [..., 4, 2] corners, CCW order
    (the convention of reference oriented_iou_loss.py:6-35)."""
    x, y, w, h, a = (box5[..., i] for i in range(5))
    dx = torch.stack([w / 2, -w / 2, -w / 2, w / 2], dim=-1)
    dy = torch.stack([h / 2, h / 2, -h / 2, -h / 2], dim=-1)
    cos, sin = torch.cos(a)[..., None], torch.sin(a)[..., None]
    cx = dx * cos - dy * sin + x[..., None]
    cy = dx * sin + dy * cos + y[..., None]
    return torch.stack([cx, cy], dim=-1)


def obb_corners(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 7] OBB -> [..., 4, 2] corners of its footprint."""
    return box2corners(boxes[..., _XYWLT])


def _edge_intersections(c1: torch.Tensor, c2: torch.Tensor):
    """All 16 edge-pair intersection candidates: c1, c2 [..., 4, 2] ->
    (points [..., 16, 2], valid [..., 16]). Strict-interior segment
    intersection (collinear edges give none), as reference
    box_intersection_2d.py:11-52."""
    q1 = torch.roll(c1, -1, dims=-2)
    q2 = torch.roll(c2, -1, dims=-2)
    x1, y1 = c1[..., :, None, 0], c1[..., :, None, 1]
    x2, y2 = q1[..., :, None, 0], q1[..., :, None, 1]
    x3, y3 = c2[..., None, :, 0], c2[..., None, :, 1]
    x4, y4 = q2[..., None, :, 0], q2[..., None, :, 1]
    num = (x1 - x2) * (y3 - y4) - (y1 - y2) * (x3 - x4)
    den_t = (x1 - x3) * (y3 - y4) - (y1 - y3) * (x3 - x4)
    den_u = (x1 - x2) * (y1 - y3) - (y1 - y2) * (x1 - x3)
    with torch.no_grad():
        safe = torch.where(num == 0.0, torch.ones_like(num), num)
        t = den_t / safe
        u = -den_u / safe
        valid = (num != 0.0) & (t > 0) & (t < 1) & (u > 0) & (u < 1)
    t_safe = den_t / (num + _EPS)
    px = x1 + t_safe * (x2 - x1)
    py = y1 + t_safe * (y2 - y1)
    pts = torch.stack([px, py], dim=-1) * valid[..., None]
    return pts.reshape(pts.shape[:-3] + (16, 2)), valid.reshape(valid.shape[:-2] + (16,))


def _corners_in_box(pts: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """pts [..., 4, 2] inside the rectangle with corners box [..., 4, 2]
    (projection test, reference box_intersection_2d.py:54-79)."""
    a = box[..., 0:1, :]
    ab = box[..., 1:2, :] - a
    ad = box[..., 3:4, :] - a
    am = pts - a
    p_ab = (ab * am).sum(-1)
    n_ab = (ab * ab).sum(-1)
    p_ad = (ad * am).sum(-1)
    n_ad = (ad * ad).sum(-1)
    c1 = (p_ab / n_ab > -1e-6) & (p_ab / n_ab < 1 + 1e-6)
    c2 = (p_ad / n_ad > -1e-6) & (p_ad / n_ad < 1 + 1e-6)
    return c1 & c2


def rect_intersection_area_2d(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """Intersection area of two rectangles given by corners [..., 4, 2]."""
    inter_pts, inter_valid = _edge_intersections(c1, c2)
    with torch.no_grad():
        in12 = _corners_in_box(c1, c2)
        in21 = _corners_in_box(c2, c1)
    verts = torch.cat([c1, c2, inter_pts], dim=-2)  # [..., 24, 2]
    valid = torch.cat([in12, in21, inter_valid], dim=-1)  # [..., 24]

    n_valid = valid.sum(-1, keepdim=True)  # [..., 1]
    vf = valid[..., None].to(verts.dtype)
    mean = (verts * vf).sum(-2, keepdim=True) / torch.clamp(n_valid[..., None], min=1)
    centered = verts - mean
    with torch.no_grad():  # the order carries no gradient
        ang = torch.atan2(centered[..., 1], centered[..., 0])
        ang = torch.where(valid, ang, torch.full_like(ang, float("inf")))
        order = torch.argsort(ang, dim=-1, stable=True)
        sorted_valid = torch.gather(valid, -1, order)
    sorted_pts = torch.gather(centered, -2, order[..., None].expand(centered.shape))
    # the invalid tail repeats the first (valid) vertex, so the closing wrap
    # edges add zero area and everything stays branch-free
    first = sorted_pts[..., 0:1, :]
    poly = torch.where(sorted_valid[..., None], sorted_pts, first)
    nxt = torch.roll(poly, -1, dims=-2)
    cross = poly[..., 0] * nxt[..., 1] - poly[..., 1] * nxt[..., 0]
    area = cross.sum(-1).abs() / 2
    return torch.where(n_valid[..., 0] > 2, area, torch.zeros_like(area))


def _z_overlap(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    zmax = torch.minimum(boxes1[..., 2] + boxes1[..., 5] / 2, boxes2[..., 2] + boxes2[..., 5] / 2)
    zmin = torch.maximum(boxes1[..., 2] - boxes1[..., 5] / 2, boxes2[..., 2] - boxes2[..., 5] / 2)
    return torch.clamp(zmax - zmin, min=0.0)


def _volume(boxes: torch.Tensor) -> torch.Tensor:
    return boxes[..., 3] * boxes[..., 4] * boxes[..., 5]


def iou_3d(boxes1: torch.Tensor, boxes2: torch.Tensor, return_union: bool = False):
    """Elementwise rotated 3D IoU over matching leading shapes
    (reference: oriented_iou_loss.py:82-107 cal_iou_3d)."""
    inter_2d = rect_intersection_area_2d(obb_corners(boxes1), obb_corners(boxes2))
    inter = inter_2d * _z_overlap(boxes1, boxes2)
    union = _volume(boxes1) + _volume(boxes2) - inter
    iou = inter / torch.clamp(union, min=_EPS)
    if return_union:
        return iou, union
    return iou


def box_iou_obb_pairwise(boxes1: torch.Tensor, boxes2: torch.Tensor,
                         pairs_per_chunk: int = PAIRS_PER_CHUNK) -> torch.Tensor:
    """[N, 7] x [M, 7] -> [N, M] rotated IoU matrix, computed in chunks of
    rows of at most `pairs_per_chunk` pairs (iou_3d is elementwise, so the
    values are those of one broadcast call)."""
    n, m = boxes1.shape[0], boxes2.shape[0]
    out = torch.empty((n, m), dtype=boxes1.dtype, device=boxes1.device)
    rows = max(1, pairs_per_chunk // max(m, 1))
    for s in range(0, n, rows):
        b1 = boxes1[s: s + rows]
        out[s: s + rows] = iou_3d(b1[:, None, :].expand(-1, m, -1),
                                  boxes2[None, :, :].expand(b1.shape[0], -1, -1))
    return out


def _enclosing_aabb_2d(c1: torch.Tensor, c2: torch.Tensor):
    pts = torch.cat([c1, c2], dim=-2)
    w = pts[..., 0].amax(-1) - pts[..., 0].amin(-1)
    h = pts[..., 1].amax(-1) - pts[..., 1].amin(-1)
    return w, h


def smallest_enclosing_box_2d(c1: torch.Tensor, c2: torch.Tensor):
    """(width, length) of the minimum-area rotated rectangle enclosing the
    8 corners of two boxes [..., 4, 2] each: a brute force over the 24
    candidate hull edges (all corner pairs but the 4 box diagonals), the
    point spread perpendicular and parallel to each, the min-area candidate
    with the reference's degenerate-line guards
    (reference: nerf_rpn/model/rotated_iou/min_enclosing_box.py:83-193).
    Gradients flow through the selected candidate only."""
    corners = torch.cat([c1, c2], dim=-2)  # [..., 8, 2]
    line_idx, point_idx = _enclosing_tables(corners.device)
    lines = corners[..., line_idx, :]  # [..., 24, 2, 2]
    points = corners[..., point_idx, :]  # [..., 24, 6, 2]
    x1, y1 = lines[..., 0:1, 0], lines[..., 0:1, 1]  # [..., 24, 1]
    x2, y2 = lines[..., 1:2, 0], lines[..., 1:2, 1]

    # spread perpendicular to the line: signed point-line distances
    px, py = points[..., 0], points[..., 1]  # [..., 24, 6]
    den = (y2 - y1) * px - (x2 - x1) * py + x2 * y1 - y2 * x1
    num = torch.sqrt((y2 - y1) ** 2 + (x2 - x1) ** 2 + 1e-14)
    d = den / num
    d1 = d.amax(-1) - d.amin(-1)  # points on both sides
    d2 = d.abs().amax(-1)  # all points on one side
    dist = torch.maximum(d1, d2)  # [..., 24]

    # spread parallel to the line: all 8 points onto its direction
    k = (y2 - y1) / (x2 - x1 + _EPS)  # [..., 24, 1]
    vec = torch.cat([torch.ones_like(k), k], dim=-1)[..., None, :]
    pts8 = torch.cat([lines, points], dim=-2)  # [..., 24, 8, 2]
    proj = (pts8 * vec).sum(-1) / torch.linalg.vector_norm(vec, dim=-1)  # [..., 24, 8]
    spread = proj.amax(-1) - proj.amin(-1)  # [..., 24]

    area = spread * dist
    # degenerate candidate lines (coincident endpoints) give zero area: push
    # them out of the argmin (reference: min_enclosing_box.py:155-158)
    area = area + (area == 0.0).to(area.dtype) * 1e8
    with torch.no_grad():
        idx = torch.argmin(area, dim=-1)[..., None]
    w = torch.gather(spread, -1, idx)[..., 0]
    h = torch.gather(dist, -1, idx)[..., 0]
    return w, h


def _enclosing_wh(c1, c2, enclosing_type: str):
    if enclosing_type == "smallest":
        return smallest_enclosing_box_2d(c1, c2)
    if enclosing_type == "aligned":
        return _enclosing_aabb_2d(c1, c2)
    raise ValueError(f"unknown enclosing_type {enclosing_type!r}")


def _z_extent(boxes1, boxes2):
    zmax = torch.maximum(boxes1[..., 2] + boxes1[..., 5] / 2, boxes2[..., 2] + boxes2[..., 5] / 2)
    zmin = torch.minimum(boxes1[..., 2] - boxes1[..., 5] / 2, boxes2[..., 2] - boxes2[..., 5] / 2)
    return zmax - zmin


def giou_3d_loss(boxes1: torch.Tensor, boxes2: torch.Tensor,
                 enclosing_type: str = "smallest") -> torch.Tensor:
    """GIoU loss for rotated 3D boxes: the enclosing volume is the 2D
    enclosing box of the footprints ("smallest" rotated, the reference's
    default, or "aligned") x the union of the z-extents
    (reference: oriented_iou_loss.py:109-127 cal_giou_3d)."""
    iou, union = iou_3d(boxes1, boxes2, return_union=True)
    w, h = _enclosing_wh(obb_corners(boxes1), obb_corners(boxes2), enclosing_type)
    vol_c = torch.clamp(w * h * _z_extent(boxes1, boxes2), min=_EPS)
    giou = iou - (vol_c - union) / vol_c
    return 1.0 - giou


def diou_3d_loss(boxes1: torch.Tensor, boxes2: torch.Tensor,
                 enclosing_type: str = "smallest") -> torch.Tensor:
    """DIoU loss: 1 - iou + center distance^2 / enclosing diagonal^2
    (reference: oriented_iou_loss.py:128-147 cal_diou_3d)."""
    iou = iou_3d(boxes1, boxes2)
    w, h = _enclosing_wh(obb_corners(boxes1), obb_corners(boxes2), enclosing_type)
    c2_diag = w * w + h * h + _z_extent(boxes1, boxes2) ** 2
    d2 = ((boxes1[..., :3] - boxes2[..., :3]) ** 2).sum(-1)
    return 1.0 - iou + d2 / torch.clamp(c2_diag, min=_EPS)
