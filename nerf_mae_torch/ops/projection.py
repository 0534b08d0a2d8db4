"""2D projection auxiliary loss (counterpart of
nerf_mae_tpu/ops/projection.py): box corner points projected to four fixed
virtual views, their pixel displacement penalized.

The reference's RPN 2D regression loss and FCOS's optional variant
(reference: nerf_rpn/model/rpn.py:76-165 get_w2cs / project, :421-453;
fcos/loss.py:447-475). The cameras sit at the four upper corners of the
scene cube looking at its centroid; a box contributes its two diagonal
corner points (obb2points_3d).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_K = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1.0]], np.float32)


def _look_at_rotation(cam: np.ndarray, at: np.ndarray) -> np.ndarray:
    """(reference: rpn.py:37-76 look_at_rotation through
    c2w_from_loc_and_at, whose up is (0, 0, 1))."""
    up = np.array([0.0, 0.0, 1.0])
    z = cam - at
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=1)


@functools.lru_cache(maxsize=8)
def get_w2cs(res: int = 160) -> np.ndarray:
    """[4, 4, 4] world-to-camera matrices of the four corner views
    (reference: rpn.py:76-88)."""
    centroid = np.full(3, res / 2.0)
    positions = np.array([[res, res, res], [res, -res, res], [-res, res, res],
                          [-res, -res, res]], np.float64) + centroid
    out = []
    for pos in positions:
        c2w = np.eye(4)
        c2w[:3, 3] = pos
        c2w[:3, :3] = _look_at_rotation(pos, centroid)
        out.append(np.linalg.inv(c2w))
    return np.stack(out).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _on_device(name: str, res: int, device: torch.device) -> torch.Tensor:
    """get_w2cs(res) ("w2cs") or the intrinsics ("K") as a float32 tensor on
    `device`, made once (a copy from host memory in the loss would wait for
    the card)."""
    with torch.inference_mode(False):
        return torch.from_numpy(get_w2cs(res) if name == "w2cs" else _K).to(device)


def obb2points_3d(obb7: torch.Tensor) -> torch.Tensor:
    """Two diagonal corner points of [..., 7] OBBs -> [..., 2, 3]
    (reference: misc.py:96-100)."""
    c = obb7[..., 0:3]
    w, l, h, t = obb7[..., 3:4], obb7[..., 4:5], obb7[..., 5:6], obb7[..., 6:7]
    cos, sin = torch.cos(t), torch.sin(t)
    v = torch.cat([w / 2 * cos - l / 2 * sin, w / 2 * sin + l / 2 * cos, h / 2], dim=-1)
    return torch.stack([c - v, c + v], dim=-2)


def project_points(points: torch.Tensor, w2c: torch.Tensor) -> torch.Tensor:
    """[..., 3] world points -> [..., 2] pixel coordinates under one view
    (reference: rpn.py:91-103)."""
    homog = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    cam = homog @ w2c.T
    pix = cam[..., :3] @ _on_device("K", 0, points.device).to(points.dtype).T
    return pix[..., :2] / pix[..., 2:3]


def projection_2d_loss(pred_boxes: torch.Tensor, target_boxes: torch.Tensor,
                       weights: torch.Tensor, resolution: int = 160) -> torch.Tensor:
    """Weighted sum of the smooth-L1 (beta 1/9) pixel displacements of the
    projected diagonal corner points over the 4 views, divided by the
    resolution (reference: rpn.py:421-453, fcos/loss.py:447-475). Count
    normalization is the caller's. Boxes [..., 6|7] AABB or OBB."""
    if pred_boxes.shape[-1] == 7:
        p_pts, t_pts = obb2points_3d(pred_boxes), obb2points_3d(target_boxes)
    else:
        p_pts = torch.stack([pred_boxes[..., :3], pred_boxes[..., 3:6]], dim=-2)
        t_pts = torch.stack([target_boxes[..., :3], target_boxes[..., 3:6]], dim=-2)
    w2cs = _on_device("w2cs", resolution, pred_boxes.device)
    beta = 1.0 / 9.0
    d2_sum = 0.0
    for v in range(4):
        d = (project_points(p_pts, w2cs[v]) - project_points(t_pts, w2cs[v])).abs()
        sl1 = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
        d2_sum = d2_sum + sl1.sum(dim=(-1, -2))
    return (d2_sum * weights).sum() / resolution
