"""Semantic voxelization: depth maps -> point clouds -> majority-label voxel
grids (the port's copy of nerf_mae_tpu/data/voxelize.py, numpy only).

Capability match for the reference's voxelize pipeline
(reference: nerf_rpn/scripts/voxelize/voxelize.py:47-80 majority-vote
voxelize; front3d_depth2pc.py depth back-projection), vectorized numpy
(np.add.at scatter instead of per-point loops).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def depth_to_pointcloud(
    depth: np.ndarray,  # [H, W] metric depth
    intrinsics: np.ndarray,  # [3, 3]
    c2w: np.ndarray,  # [4, 4] camera-to-world
    labels: np.ndarray = None,  # [H, W] optional per-pixel labels
    max_depth: float = np.inf,
    convention: str = "opencv",
) -> Tuple[np.ndarray, np.ndarray]:
    """Back-project a depth map to world-space points.

    convention:
      * "opencv": +z forward, +y down — generic RGB-D / ScanNet poses.
      * "opengl": the Front3D/HM3D BlenderProc camera model the reference's
        per-dataset depth2pc scripts use — half-pixel-centered, y-flipped
        image plane, camera looks down -z:
          c_x = (i + .5 - cx)/fx * d; c_y = (H - j - .5 - cy)/fy * d;
          c_z = -d
        (reference: nerf_rpn/scripts/voxelize/front3d_depth2pc.py:208-221,
        hm3d/hm3d_depth2pc.py:254-267 — identical math in both).

    Returns (points [N, 3], labels [N] or None).
    """
    h, w = depth.shape
    i, j = np.meshgrid(np.arange(w), np.arange(h))
    valid = (depth > 0) & (depth < max_depth)
    z = depth[valid]
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    if convention == "opengl":
        x = (i[valid] + 0.5 - cx) / fx * z
        y = (h - j[valid] - 0.5 - cy) / fy * z
        cam = np.stack([x, y, -z], axis=1)
    elif convention == "opencv":
        x = (i[valid] - cx) * z / fx
        y = (j[valid] - cy) * z / fy
        cam = np.stack([x, y, z], axis=1)
    else:
        raise ValueError(f"unknown camera convention {convention!r}")
    pts = cam @ c2w[:3, :3].T + c2w[:3, 3]
    if labels is not None:
        return pts, labels[valid]
    return pts, None


def depth2pc_scene(
    depths: Sequence[np.ndarray],  # per-view [H, W] metric depth
    masks: Sequence[np.ndarray],  # per-view [H, W] int instance/class ids
    c2ws: Sequence[np.ndarray],  # per-view [4, 4]
    intrinsics: np.ndarray,  # [3, 3] shared (fl_x/fl_y/cx/cy)
    max_depth: float = 15.0,
    points_per_obj: int = 100_000,
    convention: str = "opengl",
    seed: int = 0,
) -> dict:
    """Accumulate a per-object world point cloud over all views, subsampling
    each object to points_per_obj — the reference's per-scene depth2pc
    contract (reference: front3d_depth2pc.py:152-250 /
    hm3d_depth2pc.py:153-300: same loop, max depth 15, random
    points_per_obj subsample). Returns {object_id: [N, 3] points}."""
    pcd = {}
    for depth, mask, c2w in zip(depths, masks, c2ws):
        pts, lab = depth_to_pointcloud(
            depth, intrinsics, np.asarray(c2w), labels=mask,
            max_depth=max_depth, convention=convention,
        )
        for oid in np.unique(lab):
            pcd.setdefault(int(oid), []).append(pts[lab == oid])
    rs = np.random.RandomState(seed)
    out = {}
    for oid, chunks in pcd.items():
        p = np.concatenate(chunks, axis=0)
        if p.shape[0] > points_per_obj:
            p = p[rs.choice(p.shape[0], points_per_obj, replace=False)]
        out[oid] = p
    return out


def voxelize_labels(
    points: np.ndarray,  # [N, 3]
    labels: np.ndarray,  # [N] int, 0 = void
    bbox_min: Sequence[float],
    bbox_max: Sequence[float],
    resolution: Sequence[int],  # (W, L, H)
) -> np.ndarray:
    """Majority-vote semantic voxel grid [W, L, H] int32
    (reference: voxelize/voxelize.py:47-80)."""
    bbox_min = np.asarray(bbox_min, np.float64)
    bbox_max = np.asarray(bbox_max, np.float64)
    res = np.asarray(resolution, np.int64)
    n_classes = int(labels.max()) + 1 if labels.size else 1

    idx = np.empty((points.shape[0], 3), np.int64)
    for a in range(3):
        idx[:, a] = np.clip(
            (points[:, a] - bbox_min[a]) / (bbox_max[a] - bbox_min[a]) * res[a],
            0, res[a] - 1,
        )
    counts = np.zeros((*res, n_classes), np.int32)
    np.add.at(counts, (idx[:, 0], idx[:, 1], idx[:, 2], labels.astype(np.int64)), 1)
    return np.argmax(counts, axis=-1).astype(np.int32)


def boxes_from_instance_labels(
    voxel_instances: np.ndarray,  # [W, L, H] int instance ids (0 = void)
    min_voxels: int = 8,
) -> np.ndarray:
    """Tight AABBs [N, 6] around each instance id in a voxel grid — the box
    annotation path used when instance voxels are available
    (reference capability: data/*/preprocess boxes from annotations)."""
    boxes = []
    for inst in np.unique(voxel_instances):
        if inst == 0:
            continue
        idx = np.argwhere(voxel_instances == inst)
        if idx.shape[0] < min_voxels:
            continue
        boxes.append([*idx.min(0), *(idx.max(0) + 1)])
    return np.asarray(boxes, np.float32).reshape(-1, 6)
