"""Headless visualisation and export (the port's copy of nerf_mae_tpu/viz.py):
reconstructions as ASCII PLY point clouds (reference:
nerf_mae/model/mae/viz_utils.py:66, test_mask*.py), proposals as
instant-ngp box json (nerf_rpn/scripts/proposals2ngp.py), detection overlays
on splatted scene views (matplotlib, imported only there) and camera / box
line sets as PLY edges (data/visualize_cameras/)."""

from __future__ import annotations

import json
from copy import deepcopy
from typing import Dict, Optional

import numpy as np


def grid_to_pointcloud(
    rgbsigma: np.ndarray, alpha_thresh: float = 0.01
) -> Dict[str, np.ndarray]:
    """(W, L, H, 4) channel-last grid -> {points [N, 3], colors [N, 3]} of
    occupied voxels."""
    alpha = rgbsigma[..., 3]
    idx = np.argwhere(alpha > alpha_thresh)
    colors = rgbsigma[idx[:, 0], idx[:, 1], idx[:, 2], :3]
    return {"points": idx.astype(np.float32), "colors": np.clip(colors, 0, 1)}


_PLY_CHUNK = 100_000  # rows formatted per string operation


def save_ply(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None):
    """ASCII PLY writer (no external deps); the same bytes as the JAX
    package's writer, formatted in chunks of rows (a full 160^3 prediction
    is ~4M rows)."""
    n = points.shape[0]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        cols = None
        row_fmt = "%.3f %.3f %.3f\n"
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
            cols = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
            row_fmt = "%.3f %.3f %.3f %d %d %d\n"
        f.write("end_header\n")
        for s in range(0, n, _PLY_CHUNK):
            rows = points[s:s + _PLY_CHUNK].astype(np.float64)
            if cols is not None:
                rows = np.concatenate(
                    [rows, cols[s:s + _PLY_CHUNK].astype(np.float64)], 1)
            f.write(row_fmt * len(rows) % tuple(rows.ravel().tolist()))


def save_masked_recon(
    path_prefix: str,
    target: np.ndarray,  # (W, L, H, 4)
    pred: np.ndarray,  # (W, L, H, 4) raw model output
    token_mask: np.ndarray,  # (T, T, T) bool
    patch: int = 4,
):
    """Writes <prefix>_target.ply, <prefix>_masked.ply (masked patches
    removed) and <prefix>_pred.ply (alpha through a sigmoid)."""
    mask_vox = np.repeat(np.repeat(np.repeat(token_mask, patch, 0), patch, 1), patch, 2)
    masked = target.copy()
    masked[mask_vox] = 0.0
    pred_vis = pred.copy()
    pred_vis[..., 3] = 1.0 / (1.0 + np.exp(-pred[..., 3]))
    for name, grid in (("target", target), ("masked", masked), ("pred", pred_vis)):
        pc = grid_to_pointcloud(grid)
        save_ply(f"{path_prefix}_{name}.ply", pc["points"], pc["colors"])


def ngp_matrix_to_nerf(matrix, scale, offset, from_mitsuba):
    """(reference: scripts/proposals2ngp.py:10-20)"""
    result = deepcopy(matrix)
    if from_mitsuba:
        result[:, [0, 2]] *= -1
    else:
        result = result[[2, 0, 1], :]
    result[:, [1, 2]] *= -1
    result[:, 3] = (result[:, 3] - offset) / scale
    return result


def proposals_to_ngp_boxes(proposals: np.ndarray, meta: Dict) -> list:
    """AABB proposals [N, 6] (voxel coords) -> instant-ngp box dicts using
    the scene npz metadata {resolution, bbox_min, bbox_max, scale, offset,
    from_mitsuba} (reference: scripts/proposals2ngp.py:23-59)."""
    grid_res = meta["resolution"]
    bbox_min = np.asarray(meta["bbox_min"], np.float64)
    bbox_max = np.asarray(meta["bbox_max"], np.float64)
    scale = meta["scale"]
    offset = np.asarray(meta["offset"], np.float64)
    from_mitsuba = bool(meta.get("from_mitsuba", False))

    perm = np.array([[0, 1, 0], [0, 0, 1], [1, 0, 0]], np.float64)
    diag = bbox_max - bbox_min
    box_min = proposals[:, :3] / grid_res * diag + bbox_min
    box_max = proposals[:, 3:6] / grid_res * diag + bbox_min
    offset_yup = perm @ offset

    boxes = []
    for i in range(box_min.shape[0]):
        center = (box_min[i] + box_max[i]) * 0.5
        extent = (box_max[i] - box_min[i]) / scale
        xform = np.concatenate([np.eye(3), center[:, None]], axis=1)
        xform = perm @ xform
        xform = ngp_matrix_to_nerf(xform, scale, offset_yup, from_mitsuba)
        boxes.append(
            {
                "orientation": xform[:3, :3].tolist(),
                "position": xform[:3, 3].tolist(),
                "extents": extent.tolist(),
            }
        )
    return boxes


def save_ngp_boxes(path: str, proposals: np.ndarray, meta: Dict):
    with open(path, "w") as f:
        json.dump({"bounding_boxes": proposals_to_ngp_boxes(proposals, meta)}, f,
                  indent=2)


# ---------------------------------------------------------------------------
# Image-space detection overlays (headless matplotlib)
# (reference: nerf_rpn/scripts/visualize_rpn_input.py:371-539 — there via
# interactive open3d; here orbit cameras + z-buffer voxel splatting +
# matplotlib edge drawing, so it runs without a display).
# ---------------------------------------------------------------------------

_BOX_EDGES = [
    (0, 1), (1, 3), (3, 2), (2, 0),  # bottom face
    (4, 5), (5, 7), (7, 6), (6, 4),  # top face
    (0, 4), (1, 5), (2, 6), (3, 7),  # verticals
]


def box_corners_3d(boxes: np.ndarray) -> np.ndarray:
    """[N, 6] AABBs (min/max) or [N, 7] OBBs (cx cy cz w l h theta, z-axis
    yaw — ops/rotated_iou.py convention) -> [N, 8, 3] corners. Corner order:
    bit 0 = x, bit 1 = y, bit 2 = z (z-minor faces listed in _BOX_EDGES)."""
    boxes = np.asarray(boxes, np.float32)
    signs = np.array(
        [[sx, sy, sz] for sz in (-0.5, 0.5) for sy in (-0.5, 0.5)
         for sx in (-0.5, 0.5)], np.float32,
    )  # [8, 3]
    if boxes.shape[-1] == 6:
        center = (boxes[:, :3] + boxes[:, 3:6]) / 2
        extent = boxes[:, 3:6] - boxes[:, :3]
        return center[:, None, :] + signs[None] * extent[:, None, :]
    center, extent, theta = boxes[:, :3], boxes[:, 3:6], boxes[:, 6]
    local = signs[None] * extent[:, None, :]  # [N, 8, 3]
    c, s = np.cos(theta), np.sin(theta)
    x = local[..., 0] * c[:, None] - local[..., 1] * s[:, None]
    y = local[..., 0] * s[:, None] + local[..., 1] * c[:, None]
    return np.stack(
        [x + center[:, None, 0], y + center[:, None, 1],
         local[..., 2] + center[:, None, 2]], axis=-1,
    )


def project_to_image(points: np.ndarray, w2c: np.ndarray,
                     K: np.ndarray) -> np.ndarray:
    """World points [N, 3] -> [N, 3] (u, v, depth). Same pixel formula as
    ops/projection.py project_points (reference: rpn.py:91-103); depth > 0
    means in front of the camera (whose z-axis points away from the
    scene — see _look_at_rotation)."""
    cam = points @ w2c[:3, :3].T + w2c[:3, 3]
    depth = -cam[:, 2]
    pix = cam @ K.T
    z = np.where(np.abs(pix[:, 2:3]) < 1e-6, 1e-6, pix[:, 2:3])
    uv = pix[:, :2] / z
    return np.concatenate([uv, depth[:, None]], axis=-1)


def splat_grid_view(rgbsigma: np.ndarray, w2c: np.ndarray, K: np.ndarray,
                    hw=(480, 640), alpha_thresh: float = 0.01,
                    point_px: int = 2) -> np.ndarray:
    """Z-buffer splat of the occupied voxels into an [H, W, 3] image in
    [0, 1] (the point-cloud 'context' view of visualize_rpn_input)."""
    h, w = hw
    img = np.full((h, w, 3), 0.08, np.float32)
    pc = grid_to_pointcloud(rgbsigma, alpha_thresh)
    if not len(pc["points"]):
        return img
    uvz = project_to_image(pc["points"] + 0.5, w2c, K)
    ok = (uvz[:, 2] > 0)
    uvz, colors = uvz[ok], pc["colors"][ok]
    order = np.argsort(-uvz[:, 2])  # far -> near: later (near) wins
    u = np.round(uvz[order, 0]).astype(int)
    v = np.round(uvz[order, 1]).astype(int)
    colors = colors[order]
    for du in range(point_px):
        for dv in range(point_px):
            uu, vv = u + du, v + dv
            ok = (uu >= 0) & (uu < w) & (vv >= 0) & (vv < h)
            img[vv[ok], uu[ok]] = colors[ok]
    return img


def render_detection_views(
    rgbsigma: np.ndarray,  # (W, L, H, 4) channel-last scene grid
    pred_boxes: np.ndarray,  # [N, 6|7] voxel coords
    out_prefix: str,
    pred_scores: Optional[np.ndarray] = None,
    gt_boxes: Optional[np.ndarray] = None,  # [M, 6|7]
    score_thresh: float = 0.5,
    max_boxes: int = 50,
    views: Optional[np.ndarray] = None,  # [V, 4, 4] w2c override
) -> list:
    """Overlay PNGs of predictions (red, score-labelled) and ground truth
    (green) over splatted scene views. Default cameras: the four corner
    orbit views of ops/projection.get_w2cs. Returns written paths."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from nerf_mae_torch.ops.projection import _K, get_w2cs

    res = int(max(rgbsigma.shape[:3]))
    w2cs = views if views is not None else get_w2cs(res)
    if pred_scores is not None and len(pred_boxes):
        keep = np.argsort(-np.asarray(pred_scores))[:max_boxes]
        keep = keep[np.asarray(pred_scores)[keep] >= score_thresh]
        pred_boxes = np.asarray(pred_boxes)[keep]
        pred_scores = np.asarray(pred_scores)[keep]
    elif pred_boxes is not None:
        # score-less proposal dumps still honor the top-N cap (in file
        # order) so a 2500-proposal npz doesn't render 60k edges per view
        pred_boxes = np.asarray(pred_boxes)[:max_boxes]
    paths = []
    for vi, w2c in enumerate(np.asarray(w2cs)):
        img = splat_grid_view(rgbsigma, w2c, _K)
        fig, ax = plt.subplots(figsize=(8, 6), dpi=100)
        ax.imshow(img)
        ax.set_axis_off()

        def draw(boxes, color, scores=None):
            if boxes is None or not len(boxes):
                return
            eps = 1e-3  # near-plane depth for edge clipping
            corners = box_corners_3d(boxes)  # [N, 8, 3] world
            cam = corners @ w2c[:3, :3].T + w2c[:3, 3]  # [N, 8, 3] camera
            depth = -cam[..., 2]  # >0 in front (see project_to_image)
            for bi in range(len(boxes)):
                if (depth[bi] <= eps).all():  # fully behind the camera
                    continue
                drew_any = False
                for e0, e1 in _BOX_EDGES:
                    p0, p1 = cam[bi, e0], cam[bi, e1]
                    d0, d1 = depth[bi, e0], depth[bi, e1]
                    if d0 <= eps and d1 <= eps:
                        continue  # edge fully behind
                    # clip the behind endpoint at the depth=eps plane so
                    # large/near boxes keep their visible portion instead
                    # of vanishing when one corner crosses the plane
                    if d0 <= eps:
                        p0 = p1 + (p0 - p1) * (d1 - eps) / (d1 - d0)
                    elif d1 <= eps:
                        p1 = p0 + (p1 - p0) * (d0 - eps) / (d0 - d1)
                    seg = np.stack([p0, p1]) @ _K.T
                    # both endpoints now have depth >= eps, i.e.
                    # cam_z <= -eps: the signed divide matches
                    # project_to_image and never hits zero
                    uv = seg[:, :2] / seg[:, 2:3]
                    ax.plot(uv[:, 0], uv[:, 1], color=color, linewidth=1.2)
                    drew_any = True
                if scores is not None and drew_any:
                    vis = depth[bi] > eps
                    uvz = project_to_image(corners[bi][vis], w2c, _K)
                    top = uvz[:, 1].argmin()
                    ax.annotate(f"{scores[bi]:.2f}",
                                (uvz[top, 0], uvz[top, 1] - 3),
                                color=color, fontsize=7)

        draw(gt_boxes, "#00d26a")
        draw(pred_boxes, "#ff4d4d", pred_scores)
        ax.set_xlim(0, img.shape[1])
        ax.set_ylim(img.shape[0], 0)
        path = f"{out_prefix}_view{vi}.png"
        fig.savefig(path, bbox_inches="tight", pad_inches=0)
        plt.close(fig)
        paths.append(path)
    return paths


# ---------------------------------------------------------------------------
# Headless line-set export (reference: data/visualize_cameras/ open3d
# viewers, visualize_nerf_front3d.py:115-158 get_camera_frustum /
# frustums2lineset): the same line sets as an ASCII PLY with `edge`
# elements (readable by MeshLab / CloudCompare).
# ---------------------------------------------------------------------------


def camera_frustum_lineset(c2w: np.ndarray, camera_angle_x: float,
                           aspect: float = 480.0 / 640.0,
                           length: float = 0.1,
                           color=(0.0, 1.0, 0.0),
                           forward: float = -1.0):
    """One camera frustum as (points [5, 3], lines [8, 2], colors [8, 3]).

    Same 5-vertex topology as the reference (apex + 4 image corners at
    depth `length`, 4 apex rays + 4 rim edges; visualize_nerf_front3d.py:
    123-128). `forward` is the camera-frame z-sign of the view direction:
    -1 for nerf/instant-ngp OpenGL poses (the transforms.json convention
    this repo produces), +1 to reproduce the reference's raw +z frusta.
    """
    c2w = np.asarray(c2w, np.float64)
    half_w = length * np.tan(0.5 * camera_angle_x)
    half_h = half_w * aspect
    z = forward * length
    pts = np.array(
        [[0.0, 0.0, 0.0],
         [-half_w, -half_h, z], [half_w, -half_h, z],
         [half_w, half_h, z], [-half_w, half_h, z]], np.float64,
    )
    pts = pts @ c2w[:3, :3].T + c2w[:3, 3]
    lines = np.array([[0, 1], [0, 2], [0, 3], [0, 4],
                      [1, 2], [2, 3], [3, 4], [4, 1]], np.int64)
    colors = np.tile(np.asarray(color, np.float64)[None], (8, 1))
    return pts.astype(np.float32), lines, colors


def box_lineset(boxes: np.ndarray, color=(1.0, 0.8, 0.0)):
    """[N, 6|7] boxes -> one (points, lines, colors) wireframe line set
    (12 edges per box, _BOX_EDGES topology)."""
    boxes = np.asarray(boxes, np.float32)
    if boxes.size == 0:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 2), np.int64),
                np.zeros((0, 3), np.float64))
    corners = box_corners_3d(boxes)  # [N, 8, 3]
    n = corners.shape[0]
    edges = np.asarray(_BOX_EDGES, np.int64)  # [12, 2]
    lines = (edges[None] + 8 * np.arange(n)[:, None, None]).reshape(-1, 2)
    colors = np.tile(np.asarray(color, np.float64)[None], (12 * n, 1))
    return corners.reshape(-1, 3), lines, colors


def merge_linesets(linesets):
    """List of (points, lines, colors) -> one concatenated line set with
    re-based line indices (reference frustums2lineset semantics)."""
    pts, lines, cols, base = [], [], [], 0
    for p, l, c in linesets:
        pts.append(np.asarray(p, np.float32))
        lines.append(np.asarray(l, np.int64) + base)
        cols.append(np.asarray(c, np.float64))
        base += len(p)
    if not pts:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 2), np.int64),
                np.zeros((0, 3), np.float64))
    return np.concatenate(pts), np.concatenate(lines), np.concatenate(cols)


def save_lineset_ply(path: str, points: np.ndarray, lines: np.ndarray,
                     line_colors: Optional[np.ndarray] = None):
    """ASCII PLY with vertex + edge elements (per-edge uchar colors)."""
    n, m = len(points), len(lines)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element edge {m}\n")
        f.write("property int vertex1\nproperty int vertex2\n")
        if line_colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        for i in range(n):
            f.write(f"{points[i, 0]:.5f} {points[i, 1]:.5f} "
                    f"{points[i, 2]:.5f}\n")
        cols = (
            (np.clip(line_colors, 0, 1) * 255).astype(np.uint8)
            if line_colors is not None else None
        )
        for i in range(m):
            row = f"{int(lines[i, 0])} {int(lines[i, 1])}"
            if cols is not None:
                row += f" {cols[i, 0]} {cols[i, 1]} {cols[i, 2]}"
            f.write(row + "\n")
