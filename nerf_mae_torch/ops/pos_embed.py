"""Fixed 3D sin-cos positional embeddings (numpy copy of
nerf_mae_tpu/ops/pos_embed.py).

Same math as the reference's get_3d_sincos_pos_embed
(reference: nerf_mae/model/mae/torch_utils.py:5-53). For an embed_dim not
divisible by 3 (swin_b's 128) the tail is zero-padded so every preset works.
"""

from __future__ import annotations

import functools

import numpy as np


def _sincos_1d(embed_dim: int, positions: np.ndarray) -> np.ndarray:
    """[M] positions -> [M, embed_dim] with first half sin, second half cos."""
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000**omega
    out = np.einsum("m,d->md", positions.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


@functools.lru_cache(maxsize=16)
def sincos_pos_embed_3d(embed_dim: int, grid_size: int) -> np.ndarray:
    """Returns [1, grid_size, grid_size, grid_size, embed_dim] float32.

    np.meshgrid(w, h, l) with "xy" indexing makes the first third encode the
    second spatial axis, as in the reference (torch_utils.py:14,28-30).
    The cached array is read-only: callers copy before writing.
    """
    axis_dim = (embed_dim // 3) // 2 * 2  # per-axis dim, forced even
    coords = np.arange(grid_size, dtype=np.float64)
    gw, gh, gl = np.meshgrid(coords, coords, coords)
    emb = np.concatenate(
        [_sincos_1d(axis_dim, gw), _sincos_1d(axis_dim, gh), _sincos_1d(axis_dim, gl)],
        axis=1,
    )
    if emb.shape[1] < embed_dim:  # zero-pad remainder (e.g. 126 -> 128)
        pad = np.zeros((emb.shape[0], embed_dim - emb.shape[1]))
        emb = np.concatenate([emb, pad], axis=1)
    out = emb.reshape(1, grid_size, grid_size, grid_size, embed_dim).astype(
        np.float32
    )
    out.setflags(write=False)
    return out
