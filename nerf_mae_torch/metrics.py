"""Reconstruction metrics, masked MSE and PSNR (counterpart of
nerf_mae_tpu/metrics.py), and the losses' default count_sum.

Same definitions as the reference (reference: nerf_rpn/model/metrics.py:69-79,
used by the MAE eval loop at nerf_mae/run_swin_mae3d.py:758-760): MSE over
elements selected by a broadcast mask, PSNR = -10 log10(MSE).

Every loss of the system divides a sum over the batch by a count that
depends on the data. Each takes a `count_sum` hook that turns a sum over
the rows it holds into the sum over the global batch (parallel.count_sum on
a data-parallel rank); it is applied to the denominator before its clamp,
so that a rank returns its share of the global loss. On a [data, space]
mesh the hook sums over the whole world: a slab's sums are partial like a
row's, so masked_mse and masked_psnr are the global batch's.
"""

from __future__ import annotations

from typing import Callable

import torch

CountSum = Callable[[torch.Tensor], torch.Tensor]


def one_rank(t: torch.Tensor) -> torch.Tensor:
    """The default count_sum: one process holds the whole batch."""
    return t


def masked_mse(pred: torch.Tensor, target: torch.Tensor,
               mask: torch.Tensor, count_sum: CountSum = one_rank) -> torch.Tensor:
    """Mean squared error over elements where mask (broadcast to pred) is
    set; `count_sum` makes the squared-error sum and the count global."""
    mask = torch.broadcast_to(mask, pred.shape).float()
    se = (pred.float() - target.float()) ** 2
    se_sum, n = count_sum(torch.stack([(se * mask).sum(), mask.sum()]))
    return se_sum / torch.clamp(n, min=1.0)


def masked_psnr(pred: torch.Tensor, target: torch.Tensor,
                mask: torch.Tensor, count_sum: CountSum = one_rank) -> torch.Tensor:
    mse = masked_mse(pred, target, mask, count_sum)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))
