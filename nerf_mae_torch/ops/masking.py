"""MAE block masking on the token grid (counterpart of
nerf_mae_tpu/ops/masking.py).

One Bernoulli draw per block^3 token block, upsampled by repeat. Draws come
from an explicit torch.Generator, so its bits differ from jax.random's; tests
that compare with JAX pass the token mask in.
"""

from __future__ import annotations

import torch

from nerf_mae_torch.ops.draws import batch_rand


def block_mask_3d(
    generator: torch.Generator,
    batch: int,
    token_grid: int,
    block: int = 4,
    p_remove: float = 0.75,
    strategy: str = "random",
    per_sample: bool = True,
) -> torch.Tensor:
    """Returns a bool mask [batch, T, T, T] over tokens on the generator's
    device; True = masked.

    strategy "random": each block^3 token block is masked i.i.d. with
      probability p_remove (reference: swin_mae3d.py:1364-1373).
    strategy "grid": masks the first quarter of blocks in scan order
      (reference: swin_mae3d.py:1330-1362).
    """
    m = token_grid // block
    device = generator.device
    if strategy == "random":
        if per_sample:  # a BatchGenerator draws the global batch, keeps its rows
            blocks = batch_rand(generator, (batch, m, m, m)) < p_remove
        else:
            blocks = torch.rand((1, m, m, m), generator=generator, device=device) < p_remove
        blocks = blocks.expand(batch, m, m, m)
    elif strategy == "grid":
        n = m**3
        flat = torch.arange(n, device=device) < (n // 4)
        blocks = flat.reshape(1, m, m, m).expand(batch, m, m, m)
    else:
        raise ValueError(f"unknown masking strategy: {strategy}")
    mask = blocks.repeat_interleave(block, dim=1)
    mask = mask.repeat_interleave(block, dim=2)
    return mask.repeat_interleave(block, dim=3)
