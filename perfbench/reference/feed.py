"""The training feed's semantics in plain numpy (the benchmark's
reference): read a scene's npz, raw density to alpha, the recipe's
augments, crop and zero-pad to the grid (NeRF-MAE's dataset,
nerf_mae/model/mae/datasets.py; flips and rot90 about the up axis).

Augment draws come from one RandomState(seed) in scene order, three a
scene: rotate (u < rotate_prob), flip of axis 0, flip of axis 1
(u < flip_prob)."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def read_scene(path: str) -> np.ndarray:
    """[X, Y, Z, 4] float32 rgb and alpha = 1 - exp(-exp(density) / 100)."""
    with np.load(path) as f:
        g = np.array(f["rgbsigma"], dtype=np.float32)
    g[..., 3] = np.clip(1.0 - np.exp(-np.exp(g[..., 3]) / 100.0), 0.0, 1.0)
    return g


def augment_draws(seed: int, flip_prob: float, rotate_prob: float,
                  count: int) -> List[Tuple[bool, bool, bool]]:
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(count):
        rotate = rng.rand() < rotate_prob
        out.append((bool(rotate), bool(rng.rand() < flip_prob), bool(rng.rand() < flip_prob)))
    return out


def augment(g: np.ndarray, draws: Tuple[bool, bool, bool]) -> np.ndarray:
    """rot90 in the first two axes (transpose, then reverse axis 0), then
    the flips of axes 0 and 1."""
    rotate, flip0, flip1 = draws
    if rotate:
        g = np.swapaxes(g, 0, 1)[::-1]
    if flip0:
        g = g[::-1]
    if flip1:
        g = g[:, ::-1]
    return np.ascontiguousarray(g)


def pad_to_cube(g: np.ndarray, resolution: int) -> Tuple[np.ndarray, np.ndarray]:
    """(grid cropped to and zero-padded at the far ends to resolution^3,
    its extent [3] int32)."""
    size = np.minimum(g.shape[:3], resolution)
    out = np.zeros((resolution,) * 3 + (g.shape[3],), np.float32)
    out[:size[0], :size[1], :size[2]] = g[:size[0], :size[1], :size[2]]
    return out, size.astype(np.int32)
