"""Density -> alpha normalisation of scene grids (copies of
nerf_mae_tpu/data/datasets.py:density_to_alpha / scannet_density_to_alpha;
reference: nerf_rpn/datasets.py:246-248, :410-414)."""

from __future__ import annotations

import numpy as np


def density_to_alpha(density: np.ndarray) -> np.ndarray:
    """Instant-NGP-style (exp activation) density -> opacity."""
    return np.clip(1.0 - np.exp(-np.exp(density) / 100.0), 0.0, 1.0)


def scannet_density_to_alpha(density: np.ndarray) -> np.ndarray:
    """Dense-depth-prior NeRF (ReLU activation) variant."""
    return np.clip(1.0 - np.exp(-np.clip(density, 0, None) / 100.0), 0.0, 1.0)
