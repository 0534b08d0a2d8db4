"""MAE pretraining trainer (counterpart of nerf_mae_tpu/train/trainer.py).

One `train_step` runs the forward in training mode (mask and stochastic
depth drawn), the masked-reconstruction loss, the backward (through the
fused kernels' backward kernels on the card), the clip with its non-finite
guard and an AdamW update at the scheduled lr. The mask and droppath
generators of a step are seeded from (seed, step), so a resumed run draws
what an uninterrupted run draws.

With a data-parallel `mesh` (parallel.make_mesh) each rank holds rows
[r*b, (r+1)*b) of the global batch, as on the JAX `data` mesh: `init`
replicates the parameters from rank 0; a step's draws are made for the
global batch and sliced (ops/draws.py), the losses divide by counts over
the global batch (their count_sum hook), the gradients are summed over the
ranks between the backward and the clip, and the metrics returned are the
global batch's. So N ranks give, step for step, what one process gives on
the joined batch.

On a [data, space] mesh (make_mesh(n_space=S)) the rows are a data row's
and every grid leaf is this rank's slab of axis 1 (parallel.spatial): the
config goes through prepare_spatial_config (the plain attention), the
model computes on slabs (set_spatial), the draws are the data row's (the
same on its S ranks), and the counts, gradients and metrics are summed
over the whole world, a slab's gradient being a partial sum like a row's.
No parameter enters a computation the S ranks repeat.

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
import functools
import logging
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from nerf_mae_torch.config import MAEConfig, TrainConfig
from nerf_mae_torch.convert import params_from_jax
from nerf_mae_torch.metrics import masked_mse, masked_psnr, one_rank
from nerf_mae_torch.models.mae import SwinMAE3D, init_weights, mae_loss
from nerf_mae_torch.ops.draws import batch_generator
from nerf_mae_torch.ops.patchify import maybe_unflatten_patches, patchify_3d
from nerf_mae_torch.parallel.mesh import (
    DataMesh,
    all_reduce_grads,
    all_reduce_sum,
    check_token_grid,
    count_sum,
    distributed,
    is_spatial,
    prepare_spatial_config,
    replicate,
)
from nerf_mae_torch.parallel.spatial import set_spatial
from nerf_mae_torch.train.optim import (
    clip_by_global_norm,
    clip_with_nonfinite_guard,
    make_optimizer,
    make_schedule,
    update_count,
)

logger = logging.getLogger(__name__)

# generator streams of one step
_MASK, _DROPPATH, _EVAL = 0, 1, 0x45564C

# metrics every rank already holds for the global batch (from the reduced
# gradients, or from sums the losses made global); every other 0-d metric
# is a rank's share of a global sum
GLOBAL_METRICS = ("grad_norm", "mse", "psnr", "soft_miou")


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
    clip, per-step generators, the optimizer update and, on a mesh, the
    replication, the reductions and the losses' count_sum hook. The device
    is the mesh's when a mesh is given; on a space axis the config is
    prepared for it (the plain attention; a token grid the axis divides)."""

    def __init__(self, mae_cfg: MAEConfig, train_cfg: TrainConfig,
                 total_steps: int, device="cuda", mesh: Optional[DataMesh] = None):
        if mae_cfg is not None:  # the RCNN trainer has none
            swin = prepare_spatial_config(mesh, mae_cfg.swin)
            if swin is not mae_cfg.swin:
                mae_cfg = dataclasses.replace(mae_cfg, swin=swin)
            check_token_grid(mesh, mae_cfg.token_grid)
        self.mae_cfg = mae_cfg
        self.train_cfg = train_cfg
        self.total_steps = total_steps
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else torch.device(device)
        self.count_sum = (functools.partial(count_sum, mesh=mesh) if distributed(mesh)
                          else one_rank)
        self.schedule = make_schedule(train_cfg, total_steps)
        self.clip = (clip_with_nonfinite_guard if train_cfg.skip_nonfinite_updates
                     else clip_by_global_norm)
        self.spatial = mesh if is_spatial(mesh) else None

    def _build_model(self) -> torch.nn.Module:
        raise NotImplementedError

    def params_from_jax(self, tree) -> Dict[str, torch.Tensor]:
        """The JAX trainer's parameter tree (nested or "/"-flat, as numpy)
        -> this trainer's state dict, through the family's mapping in
        convert.py (a relayout per leaf, so it maps AdamW's moments too)."""
        raise NotImplementedError

    def _init_model(self, seed: int) -> torch.nn.Module:
        return set_spatial(init_weights(self._build_model(), seed), self.mesh)

    def init(self, seed: int) -> TrainState:
        model = replicate(self._init_model(seed), self.mesh)
        n = sum(p.numel() for p in model.parameters())
        logger.info("initialized %s with %d params", type(model).__name__, n)
        return TrainState(0, model.train(),
                          make_optimizer(model.parameters(), self.train_cfg), seed)

    def _generator(self, seed: int, step: int, stream: int,
                   batch: Optional[int] = None) -> torch.Generator:
        """The step's generator of `stream`. On a mesh, given the `batch`
        rows this rank holds, a BatchGenerator: its batch-leading draws are
        made for the global batch and sliced to this rank's data row (the
        same on every rank of its space group)."""
        if batch is None or not distributed(self.mesh):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(stream_seed(seed, step, stream))
            return gen
        return batch_generator(self.device, stream_seed(seed, step, stream),
                               self.mesh.data_rank * batch, self.mesh.data_world * batch)

    def _global(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The metrics of the global batch: each rank's share of a global sum
        (a 0-d metric not in GLOBAL_METRICS) summed over the ranks in one
        collective; the rest as they are."""
        keys = [k for k, v in metrics.items()
                if k not in GLOBAL_METRICS and torch.is_tensor(v) and v.ndim == 0]
        return {**metrics, **dict(zip(keys, all_reduce_sum([metrics[k] for k in keys],
                                                           self.mesh)))}

    def _update(self, state: TrainState, loss: torch.Tensor) -> torch.Tensor:
        """Backward of `loss`, then apply_gradients. Returns the gradient
        norm before clipping."""
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        return self.apply_gradients(state)

    def apply_gradients(self, state: TrainState) -> torch.Tensor:
        """The update from the parameters' gradients: on a mesh their sum
        over the ranks, the clip (a parameter without a gradient gets
        zeros) and an AdamW step at the lr of the schedule at the
        optimizer's update count (optax reads its schedule's count; a run
        resumed from a JAX state continues from JAX's); advances the step.
        Every rank clips the global gradient, so all make the same
        non-finite skip decision. Returns the gradient norm before
        clipping."""
        model, opt = state.model, state.optimizer
        params = list(model.parameters())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        all_reduce_grads(params, self.mesh)
        grad_norm = self.clip([p.grad for p in params], self.train_cfg.clip_grad_norm)
        lr = self.schedule(update_count(opt))
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        state.step += 1
        return grad_norm


class MAETrainer(Trainer):
    def _build_model(self) -> SwinMAE3D:
        return SwinMAE3D(self.mae_cfg, device=self.device)

    def params_from_jax(self, tree) -> Dict[str, torch.Tensor]:
        return params_from_jax(tree, self.mae_cfg)

    def _losses(self, model, batch, deterministic, generator, droppath,
                token_mask=None):
        pred, token_mask = model(
            batch["grids"], deterministic, token_mask=token_mask,
            generator=generator, patched_pred=True, droppath_generator=droppath)
        loss, aux = mae_loss(pred, batch["grids"], token_mask, batch["sizes"],
                             self.mae_cfg, self.count_sum, self.spatial)
        return loss, aux, pred, token_mask

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                   token_mask: Optional[torch.Tensor] = None):
        """One optimizer step; returns (state, metrics) with the metrics as
        0-d device tensors (loss, loss_rgb, loss_alpha, grad_norm: the norm
        before clipping), the global batch's on a mesh. `token_mask`
        replaces the drawn mask (tests; on a mesh, this rank's rows)."""
        model = state.model
        model.train()
        b = batch["grids"].shape[0]
        loss, aux, _, _ = self._losses(
            model, batch, False,
            self._generator(state.seed, state.step, _MASK, b),
            self._generator(state.seed, state.step, _DROPPATH, b), token_mask)
        grad_norm = self._update(state, loss)
        return state, self._global({
            "loss": loss.detach(), "loss_rgb": aux["loss_rgb"].detach(),
            "loss_alpha": aux["loss_alpha"].detach(), "grad_norm": grad_norm})

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: Dict[str, torch.Tensor]):
        """Masked-reconstruction eval with a fixed mask stream: loss terms
        and PSNR/MSE of the RGB over alpha > 0.01 voxels
        (reference: run_swin_mae3d.py:747-760), the global batch's on a
        mesh."""
        model = state.model
        model.eval()
        loss, aux, pred, _ = self._losses(
            model, batch, True,
            self._generator(state.seed, 0, _EVAL, batch["grids"].shape[0]), None)
        p = self.mae_cfg.swin.patch_size[0]
        pred_p = pred if pred.ndim == 6 else patchify_3d(pred, p)
        tgt = maybe_unflatten_patches(batch["grids"], p,
                                      self.mae_cfg.input_channels).float()
        tgt_p = tgt if tgt.ndim == 6 else patchify_3d(tgt, p)
        alpha_mask = tgt_p[..., 3:] > 0.01
        return self._global({
            "loss": loss, "loss_rgb": aux["loss_rgb"], "loss_alpha": aux["loss_alpha"],
            "mse": masked_mse(pred_p[..., :3], tgt_p[..., :3], alpha_mask, self.count_sum),
            "psnr": masked_psnr(pred_p[..., :3], tgt_p[..., :3], alpha_mask,
                                self.count_sum),
        })

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
