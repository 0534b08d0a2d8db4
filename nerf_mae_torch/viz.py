"""Headless export of reconstructions as ASCII PLY point clouds (copy of
nerf_mae_tpu/viz.py:grid_to_pointcloud / save_ply / save_masked_recon;
reference: nerf_mae/model/mae/viz_utils.py:66, test_mask*.py)."""

from __future__ import annotations

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
