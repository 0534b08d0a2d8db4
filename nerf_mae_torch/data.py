"""Scene data on the host, numpy only (copies of the pieces of
nerf_mae_tpu/data/datasets.py that the port needs).

density_to_alpha / scannet_density_to_alpha (reference:
nerf_rpn/datasets.py:246-248, :410-414); synthetic_scenes, pad_to_cube and
mae_batch_iterator, the synthetic pretraining feed. The native collate, the
scene datasets on disk, the prefetch pool and the device-resident corpus
are not part of the port yet.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from nerf_mae_torch.ops.patchify import patchify_np


def density_to_alpha(density: np.ndarray) -> np.ndarray:
    """Instant-NGP-style (exp activation) density -> opacity."""
    return np.clip(1.0 - np.exp(-np.exp(density) / 100.0), 0.0, 1.0)


def scannet_density_to_alpha(density: np.ndarray) -> np.ndarray:
    """Dense-depth-prior NeRF (ReLU activation) variant."""
    return np.clip(1.0 - np.exp(-np.clip(density, 0, None) / 100.0), 0.0, 1.0)


def synthetic_scenes(n: int, resolution: int = 160, seed: int = 0,
                     min_size: Optional[int] = None) -> List[np.ndarray]:
    """Random rgbsigma scenes (channel-last) with box-shaped opaque blobs,
    for tests and benchmarks without real data (the JAX package's draws,
    number for number)."""
    rng = np.random.RandomState(seed)
    lo = min_size or int(resolution * 0.8)
    scenes = []
    for _ in range(n):
        size = rng.randint(lo, resolution + 1, 3)
        g = np.zeros((*size, 4), np.float32)
        for _ in range(rng.randint(3, 9)):
            c = rng.randint(0, size - 1, 3)
            e = rng.randint(4, max(min(size) // 3, 5), 3)
            s0 = np.maximum(c - e, 0)
            s1 = np.minimum(c + e, size)
            g[s0[0]: s1[0], s0[1]: s1[1], s0[2]: s1[2], :3] = rng.rand(3)
            g[s0[0]: s1[0], s0[1]: s1[1], s0[2]: s1[2], 3] = rng.uniform(0.3, 1.0)
        scenes.append(g)
    return scenes


def pad_to_cube(g: np.ndarray, resolution: int) -> Tuple[np.ndarray, np.ndarray]:
    """Crop-to-fit + zero-pad a (W, L, H, C) grid to resolution^3; returns
    (grid, size [3] int32)."""
    size = np.minimum(np.asarray(g.shape[:3], np.int64), resolution).astype(np.int32)
    g = g[:resolution, :resolution, :resolution]
    out = np.zeros((resolution, resolution, resolution, g.shape[3]), np.float32)
    out[: size[0], : size[1], : size[2]] = g
    return out, size


def mae_batch_iterator(
    dataset: Sequence,
    batch_size: int,
    resolution: int,
    shuffle: bool = True,
    seed: int = 0,
    drop_last: bool = True,
    loop: bool = True,
    patch_major: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yields {"grids": [B, R, R, R, 4] float32, "sizes": [B, 3] int32}
    forever (or one epoch if loop=False), in the JAX iterator's order.
    `dataset[i]["rgbsigma"]` is a channel-last grid. patch_major=p emits
    grids in the patch-major layout [B, t, t, t, p^3, 4] (t = R // p)."""
    rng = np.random.RandomState(seed)
    n = len(dataset)
    if patch_major:
        t = resolution // patch_major
        grid_shape = (t, t, t, patch_major ** 3, 4)
    else:
        grid_shape = (resolution, resolution, resolution, 4)

    def load(j):
        g, size = pad_to_cube(dataset[int(j)]["rgbsigma"], resolution)
        if patch_major:
            g = patchify_np(g[None], patch_major)[0]
        return g, size

    while True:
        order = rng.permutation(n) if shuffle else np.arange(n)
        for start in range(0, n, batch_size):
            sel = order[start: start + batch_size]
            if len(sel) < batch_size and drop_last:
                continue
            grids = np.zeros((len(sel),) + grid_shape, np.float32)
            sizes = np.zeros((len(sel), 3), np.int32)
            for i, j in enumerate(sel):
                grids[i], sizes[i] = load(j)
            yield {"grids": grids, "sizes": sizes}
        if not loop:
            return
