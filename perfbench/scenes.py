"""The one traffic generator: scenes and boxes from a seed, after the
parameters of a traffic file (perfbench/traffic/<mix>.json).

Scene content, "content":
  "blobs"      3-8 opaque axis-aligned blobs a scene (the synthetic scene
               distribution of the system under test, draw for draw):
               half-extents 4 .. min(extent) / 3, colour uniform, alpha
               uniform in [0.3, 1);
  "obb_boxes"  "boxes" = [lo, hi] oriented boxes a scene, yaw uniform over a
               half-turn [-pi/2, pi/2), half-extents "half_extent" = [lo, hi]
               voxels on each axis, painted as those rotated boxes; each box
               lies inside its scene.
The scenes' extents are drawn per axis from "extent" = [lo, hi] under the
fixed "sizes_seed", so that every run seed gets the same set of extents
(the same host work to read and pad them), dealt to its scenes in an order
of its own; each grid is zero-padded to the configuration's resolution.
Content draws are numpy's, seeded per scene, so a scene does not depend on
how many others are drawn.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

# empty space's raw density on disk: alpha = 1 - exp(-exp(d) / 100) ~ 5e-7
EMPTY_DENSITY = -10.0


def scene_rng(seed: int, index: int) -> np.random.RandomState:
    return np.random.RandomState(np.random.SeedSequence([seed, index]).generate_state(1)[0])


def _blobs(rng, g: np.ndarray, size: np.ndarray, objects) -> None:
    for _ in range(rng.randint(objects[0], objects[1] + 1)):
        c = rng.randint(0, size - 1, 3)
        e = rng.randint(4, max(min(size) // 3, 5), 3)
        s0, s1 = np.maximum(c - e, 0), np.minimum(c + e, size)
        g[s0[0]:s1[0], s0[1]:s1[1], s0[2]:s1[2], :3] = rng.rand(3)
        g[s0[0]:s1[0], s0[1]:s1[1], s0[2]:s1[2], 3] = rng.uniform(0.3, 1.0)


def paint_obb(g: np.ndarray, box: np.ndarray, rgb, alpha: float) -> None:
    """Set the voxels whose centres lie in the oriented box (cx, cy, cz, w,
    l, h, yaw): its w side along (cos yaw, sin yaw), l side along
    (-sin yaw, cos yaw) in the first two axes, h along the third."""
    c, dims, yaw = box[:3], box[3:6], box[6]
    r = np.hypot(dims[0], dims[1]) / 2
    lo = np.maximum(np.floor([c[0] - r, c[1] - r, c[2] - dims[2] / 2]).astype(int), 0)
    hi = np.minimum(np.ceil([c[0] + r, c[1] + r, c[2] + dims[2] / 2]).astype(int) + 1,
                    g.shape[:3])
    x, y, z = np.meshgrid(*[np.arange(a, b) + 0.5 for a, b in zip(lo, hi)], indexing="ij")
    dx, dy = x - c[0], y - c[1]
    u = dx * np.cos(yaw) + dy * np.sin(yaw)
    v = -dx * np.sin(yaw) + dy * np.cos(yaw)
    inside = (np.abs(u) <= dims[0] / 2) & (np.abs(v) <= dims[1] / 2) & (
        np.abs(z - c[2]) <= dims[2] / 2)
    region = g[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
    region[inside, :3] = rgb
    region[inside, 3] = alpha


def _boxes(rng, g: np.ndarray, size: np.ndarray, count, half) -> np.ndarray:
    boxes = []
    for _ in range(rng.randint(count[0], count[1] + 1)):
        e = rng.randint(half[0], half[1] + 1, 3).astype(np.float64)
        r = np.hypot(e[0], e[1])
        margin = np.array([r + 1, r + 1, e[2] + 1])
        c = rng.uniform(margin, size - margin)
        yaw = rng.uniform(-np.pi / 2, np.pi / 2)
        box = np.array([*c, *(2 * e), yaw])
        paint_obb(g, box, rng.rand(3), rng.uniform(0.5, 1.0))
        boxes.append(box)
    return np.asarray(boxes, np.float32)


def draw(traffic: dict, resolution: int, seed: int
         ) -> Tuple[np.ndarray, np.ndarray, Optional[List[np.ndarray]]]:
    """(grids [N, R, R, R, 4] float32 zero-padded, sizes [N, 3] int32,
    boxes: one [n, 7] float32 array a scene or None)."""
    n = traffic["scenes"]
    grids = np.zeros((n, resolution, resolution, resolution, 4), np.float32)
    sizes = np.zeros((n, 3), np.int32)
    boxes = [] if traffic["content"] == "obb_boxes" else None
    extents = np.random.RandomState(traffic["sizes_seed"]).randint(
        traffic["extent"][0], traffic["extent"][1] + 1, (n, 3))
    extents = extents[np.random.RandomState(seed).permutation(n)]
    for i in range(n):
        rng = scene_rng(seed, i)
        size = extents[i]
        sizes[i] = size
        g = grids[i, :size[0], :size[1], :size[2]]
        if boxes is None:
            _blobs(rng, g, size, traffic["objects"])
        else:
            boxes.append(_boxes(rng, g, size, traffic["boxes"], traffic["half_extent"]))
    return grids, sizes, boxes


def alpha_to_density(alpha: np.ndarray) -> np.ndarray:
    """The raw density whose alpha (1 - exp(-exp(d) / 100)) is `alpha`;
    empty voxels get EMPTY_DENSITY."""
    out = np.full(alpha.shape, EMPTY_DENSITY, np.float32)
    full = alpha > 0
    out[full] = np.log(-100.0 * np.log1p(-alpha[full].astype(np.float64)))
    return out


def write_npz(directory: str, grids: np.ndarray, sizes: np.ndarray) -> None:
    """Each scene un-padded as <directory>/sceneNNNN.npz: "rgbsigma"
    [X, Y, Z, 4] float32, rgb and raw density."""
    os.makedirs(directory, exist_ok=True)
    for i, (g, s) in enumerate(zip(grids, sizes)):
        g = g[:s[0], :s[1], :s[2]].copy()
        g[..., 3] = alpha_to_density(g[..., 3])
        np.savez(os.path.join(directory, f"scene{i:04d}.npz"), rgbsigma=g)


def pad_boxes(boxes: List[np.ndarray], max_gt: int) -> Dict[str, np.ndarray]:
    out = np.zeros((len(boxes), max_gt, 7), np.float32)
    valid = np.zeros((len(boxes), max_gt), bool)
    for i, b in enumerate(boxes):
        n = min(len(b), max_gt)
        out[i, :n], valid[i, :n] = b[:n], True
    return {"gt_boxes": out, "gt_valid": valid}
