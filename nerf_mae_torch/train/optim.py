"""Optimizer and LR schedule (counterpart of nerf_mae_tpu/train/optim.py).

The reference recipe: global-norm gradient clip 0.1, AdamW(lr, wd) under a
OneCycle schedule (reference: nerf_mae/run_swin_mae3d.py:588-600,665).
`torch.optim.AdamW` with the lr set before every step from `make_schedule`
at the count of earlier updates reproduces `optax.adamw`: decoupled decay on
every parameter, bias correction, eps added outside the square root. The
clip is the JAX package's non-finite guard, not `clip_grad_norm_` (which
divides by norm + 1e-6 and lets a nan spread).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List

import torch

from nerf_mae_torch.config import TrainConfig


def make_schedule(cfg: TrainConfig, total_steps: int) -> Callable[[int], float]:
    """torch OneCycleLR(anneal_strategy="cos") as a function of the step:
    cosine warmup from lr/div_factor to lr over pct_start, then cosine decay
    to lr/div_factor/final_div_factor, the phase boundary at
    pct_start*total_steps - 1. When int(pct_start * total_steps) < 1 (a run
    of <= 3 steps) the lr is constant, as in the JAX package."""
    total_steps = max(total_steps, 1)
    if int(cfg.onecycle_pct_start * total_steps) < 1:
        return lambda step: cfg.lr
    peak = cfg.lr
    initial = peak / cfg.onecycle_div_factor
    floor = initial / cfg.onecycle_final_div_factor
    end1 = float(cfg.onecycle_pct_start * total_steps) - 1.0
    end2 = float(total_steps) - 1.0

    def _cos(start, end, pct):
        return end + (start - end) / 2.0 * (1.0 + math.cos(math.pi * pct))

    def schedule(step: int) -> float:
        step = float(step)
        pct1 = min(max(step / max(end1, 1e-9), 0.0), 1.0)
        pct2 = min(max((step - end1) / max(end2 - end1, 1e-9), 0.0), 1.0)
        return _cos(initial, peak, pct1) if step <= end1 else _cos(peak, floor, pct2)

    return schedule


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) of all gradients, float32, on their device."""
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_with_nonfinite_guard(grads: List[torch.Tensor],
                              max_norm: float) -> torch.Tensor:
    """Global-norm clip in place, with the non-finite guard: the scale is 1
    if norm < max_norm, else max_norm / norm; a non-finite norm zeroes every
    gradient (the AdamW step still runs, decaying its moments and the
    weights). Returns the norm before clipping. No host synchronisation."""
    norm = global_norm(grads)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    factor = torch.where(torch.isfinite(norm), scale, torch.zeros_like(norm))
    for g in grads:
        g.mul_(factor).nan_to_num_(0.0, 0.0, 0.0)
    return norm


def clip_by_global_norm(grads: List[torch.Tensor],
                        max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place (no guard: a nan spreads).
    Returns the norm before clipping."""
    norm = global_norm(grads)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)
    return norm


def update_count(optimizer: torch.optim.Optimizer) -> int:
    """The updates `optimizer` has taken: AdamW's step of its first
    parameter (every parameter steps together), 0 before the first. The
    schedule is read at it, as optax reads its ScaleByScheduleState count.
    The step lives on the host, so reading it does not synchronize."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            step = optimizer.state.get(p, {}).get("step")
            if step is not None:
                return int(step)
    return 0


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   cfg: TrainConfig) -> torch.optim.AdamW:
    """AdamW with optax.adamw's constants (b1 0.9, b2 0.999, eps 1e-8)."""
    return torch.optim.AdamW(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=cfg.weight_decay)
