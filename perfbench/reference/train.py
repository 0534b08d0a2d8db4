"""The training recipe in plain float32 (the benchmark's reference; torch
and numpy only): the OneCycle learning rate, the global-norm clip with its
non-finite guard, AdamW, and the draws of a step (NeRF-MAE's recipe,
nerf_mae/run_swin_mae3d.py:588-600,665: clip 0.1, AdamW, OneCycle).

The draws follow the stated semantics of the system under test: a step's
mask and stochastic-depth generators are seeded from (seed, step, stream)
through numpy's SeedSequence; the mask is one uniform draw per 4^3 token
block per sample, masked where it is below the masking ratio.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

MASK_STREAM, DROPPATH_STREAM = 0, 1


def stream_seed(seed: int, step: int, stream: int) -> int:
    state = np.random.SeedSequence([seed, step, stream]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(seed: int, step: int, stream: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, step, stream))
    return gen


def block_mask(gen: torch.Generator, batch: int, tokens: int, block: int,
               ratio: float) -> torch.Tensor:
    """[B, T, T, T] bool, True = masked."""
    m = tokens // block
    blocks = torch.rand((batch, m, m, m), generator=gen, device=gen.device) < ratio
    for axis in (1, 2, 3):
        blocks = blocks.repeat_interleave(block, dim=axis)
    return blocks


def onecycle_lr(step: int, lr: float, total: int, pct_start: float = 0.3,
                div: float = 25.0, final_div: float = 1e4) -> float:
    """torch OneCycleLR with cosine annealing, as a function of the number
    of earlier updates (constant lr when pct_start * total < 1)."""
    total = max(total, 1)
    if int(pct_start * total) < 1:
        return lr
    initial = lr / div
    floor = initial / final_div
    end1 = pct_start * total - 1.0
    end2 = total - 1.0
    cos = lambda a, b, t: b + (a - b) / 2.0 * (1.0 + math.cos(math.pi * t))
    if step <= end1:
        return cos(initial, lr, min(max(step / max(end1, 1e-9), 0.0), 1.0))
    return cos(lr, floor, min(max((step - end1) / max(end2 - end1, 1e-9), 0.0), 1.0))


def clip_(grads: Dict[str, torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale every gradient by min(1, max_norm / global norm); a non-finite
    norm zeroes them all. Returns the norm before clipping."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
    factor = 1.0 if float(norm) < max_norm else max_norm / float(norm)
    if not math.isfinite(float(norm)):
        factor = 0.0
    for g in grads.values():
        g.mul_(factor)
    return norm


class AdamW:
    """Decoupled weight decay, bias-corrected moments, eps outside the root
    (b1 0.9, b2 0.999, eps 1e-8)."""

    def __init__(self, params: Dict[str, torch.Tensor], weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.wd, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], lr: float):
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for k, p in params.items():
            g = grads[k]
            p.mul_(1.0 - lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = self.v[k].sqrt() / math.sqrt(c2) + self.eps
            p.addcdiv_(self.m[k], denom, value=-lr / c1)
