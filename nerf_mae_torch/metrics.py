"""Reconstruction metrics, masked MSE and PSNR (counterpart of
nerf_mae_tpu/metrics.py).

Same definitions as the reference (reference: nerf_rpn/model/metrics.py:69-79,
used by the MAE eval loop at nerf_mae/run_swin_mae3d.py:758-760): MSE over
elements selected by a broadcast mask, PSNR = -10 log10(MSE).
"""

from __future__ import annotations

import torch


def masked_mse(pred: torch.Tensor, target: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Mean squared error over elements where mask (broadcast to pred) is set."""
    mask = torch.broadcast_to(mask, pred.shape).float()
    se = (pred.float() - target.float()) ** 2
    return (se * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def masked_psnr(pred: torch.Tensor, target: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(torch.clamp(masked_mse(pred, target, mask), min=1e-12))
