"""MAE pretraining trainer (counterpart of nerf_mae_tpu/train/trainer.py).

One `train_step` runs the forward in training mode (mask and stochastic
depth drawn), the masked-reconstruction loss, the backward (through the
fused kernels' backward kernels on the card), the clip with its non-finite
guard and an AdamW update at the scheduled lr. The mask and droppath
generators of a step are seeded from (seed, step), so a resumed run draws
what an uninterrupted run draws.

    trainer = MAETrainer(mae_cfg, train_cfg, total_steps, device="cuda")
    state = trainer.init(seed=0)
    state, metrics = trainer.train_step(state, batch)
    metrics = trainer.eval_step(state, batch)

`batch` is {"grids": [B, R, R, R, 4] (or the patch-major [B, T, T, T, p^3, 4],
or its channel-flat [B, T, T, T, p^3*4], the feed's layout; float32 or the
feed's bf16 / float16), "sizes": [B, 3]} as tensors on the trainer's
device.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from nerf_mae_torch.config import MAEConfig, TrainConfig
from nerf_mae_torch.metrics import masked_mse, masked_psnr
from nerf_mae_torch.models.mae import SwinMAE3D, init_weights, mae_loss
from nerf_mae_torch.ops.patchify import maybe_unflatten_patches, patchify_3d
from nerf_mae_torch.train.optim import (
    clip_by_global_norm,
    clip_with_nonfinite_guard,
    make_optimizer,
    make_schedule,
)

logger = logging.getLogger(__name__)

# generator streams of one step
_MASK, _DROPPATH, _EVAL = 0, 1, 0x45564C


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.AdamW
    seed: int


def stream_seed(seed: int, step: int, stream: int) -> int:
    """A 63-bit generator seed for (seed, step, stream)."""
    state = np.random.SeedSequence([seed, step, stream]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


class Trainer:
    """What the MAE and the downstream trainers share: the schedule, the
    clip, per-step generators and the optimizer update."""

    def __init__(self, mae_cfg: MAEConfig, train_cfg: TrainConfig,
                 total_steps: int, device="cuda"):
        self.mae_cfg = mae_cfg
        self.train_cfg = train_cfg
        self.total_steps = total_steps
        self.device = torch.device(device)
        self.schedule = make_schedule(train_cfg, total_steps)
        self.clip = (clip_with_nonfinite_guard if train_cfg.skip_nonfinite_updates
                     else clip_by_global_norm)

    def _build_model(self) -> torch.nn.Module:
        raise NotImplementedError

    def _init_model(self, seed: int) -> torch.nn.Module:
        return init_weights(self._build_model(), seed)

    def init(self, seed: int) -> TrainState:
        model = self._init_model(seed)
        n = sum(p.numel() for p in model.parameters())
        logger.info("initialized %s with %d params", type(model).__name__, n)
        return TrainState(0, model.train(),
                          make_optimizer(model.parameters(), self.train_cfg), seed)

    def _generator(self, seed: int, step: int, stream: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(stream_seed(seed, step, stream))
        return gen

    def _update(self, state: TrainState, loss: torch.Tensor) -> torch.Tensor:
        """Backward of `loss`, the clip (a parameter without a gradient gets
        zeros) and an AdamW step at the scheduled lr; advances the step.
        Returns the gradient norm before clipping."""
        model, opt = state.model, state.optimizer
        opt.zero_grad(set_to_none=True)
        loss.backward()
        grads = []
        for p in model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        grad_norm = self.clip(grads, self.train_cfg.clip_grad_norm)
        lr = self.schedule(state.step)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        state.step += 1
        return grad_norm


class MAETrainer(Trainer):
    def _build_model(self) -> SwinMAE3D:
        return SwinMAE3D(self.mae_cfg, device=self.device)

    def _losses(self, model, batch, deterministic, generator, droppath,
                token_mask=None):
        pred, token_mask = model(
            batch["grids"], deterministic, token_mask=token_mask,
            generator=generator, patched_pred=True, droppath_generator=droppath)
        loss, aux = mae_loss(pred, batch["grids"], token_mask, batch["sizes"],
                             self.mae_cfg)
        return loss, aux, pred, token_mask

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                   token_mask: Optional[torch.Tensor] = None):
        """One optimizer step; returns (state, metrics) with the metrics as
        0-d device tensors (loss, loss_rgb, loss_alpha, grad_norm: the norm
        before clipping). `token_mask` replaces the drawn mask (tests)."""
        model = state.model
        model.train()
        loss, aux, _, _ = self._losses(
            model, batch, False,
            self._generator(state.seed, state.step, _MASK),
            self._generator(state.seed, state.step, _DROPPATH), token_mask)
        grad_norm = self._update(state, loss)
        return state, {"loss": loss.detach(), "loss_rgb": aux["loss_rgb"].detach(),
                       "loss_alpha": aux["loss_alpha"].detach(),
                       "grad_norm": grad_norm}

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: Dict[str, torch.Tensor]):
        """Masked-reconstruction eval with a fixed mask stream: loss terms
        and PSNR/MSE of the RGB over alpha > 0.01 voxels
        (reference: run_swin_mae3d.py:747-760)."""
        model = state.model
        model.eval()
        loss, aux, pred, _ = self._losses(
            model, batch, True, self._generator(state.seed, 0, _EVAL), None)
        p = self.mae_cfg.swin.patch_size[0]
        pred_p = pred if pred.ndim == 6 else patchify_3d(pred, p)
        tgt = maybe_unflatten_patches(batch["grids"], p,
                                      self.mae_cfg.input_channels).float()
        tgt_p = tgt if tgt.ndim == 6 else patchify_3d(tgt, p)
        alpha_mask = tgt_p[..., 3:] > 0.01
        return {
            "loss": loss, "loss_rgb": aux["loss_rgb"], "loss_alpha": aux["loss_alpha"],
            "mse": masked_mse(pred_p[..., :3], tgt_p[..., :3], alpha_mask),
            "psnr": masked_psnr(pred_p[..., :3], tgt_p[..., :3], alpha_mask),
        }

    def fit(self, state: TrainState, train_batches: Iterable[Dict[str, torch.Tensor]],
            steps: int, log_every: int = 10,
            callback: Optional[Callable[[int, Dict[str, float]], None]] = None
            ) -> TrainState:
        """A step-driven loop (the epoch structure lives in the batches)."""
        it = iter(train_batches)
        t0 = time.time()
        for i in range(steps):
            state, metrics = self.train_step(state, next(it))
            if (i + 1) % log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - t0
                logger.info("step %d loss %.4f (rgb %.4f alpha %.4f) %.2f steps/s",
                            i + 1, m["loss"], m["loss_rgb"], m["loss_alpha"],
                            log_every / max(dt, 1e-9))
                if callback is not None:
                    callback(i + 1, m)
                t0 = time.time()
        return state
