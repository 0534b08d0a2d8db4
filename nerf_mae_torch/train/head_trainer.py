"""Trainers for the dense downstream heads, VoxelSR and VoxelSemantics
(counterpart of nerf_mae_tpu/train/head_trainer.py, with its [data, space]
mesh).

    trainer = VoxelSRTrainer(mae_cfg, train_cfg, total_steps, "cuda",
                             out_resolution=256)
    state = trainer.init(seed=0)
    state = trainer.graft_mae(state, mae_state_dict)
    state, metrics = trainer.train_step(state, batch)
    metrics = trainer.eval_step(state, batch)

A train step runs the head's training forward (stochastic depth drawn from
a generator seeded by (seed, step), as MAETrainer seeds its own), the loss,
the backward, the clip with its non-finite guard and an AdamW update at the
scheduled lr; on a mesh, as Trainer describes (the draws of the global
batch, global counts, summed gradients, global metrics; on a space axis
every batch grid, the targets too, is this rank's slab).
Batches are tensors on the trainer's device: {"grids":
[B, R, R, R, 4], "out_grids": [B, R_out, R_out, R_out, 4]} for SR, {"grids",
"semantics": [B, R, R, R] int labels, 0 = void} for semantics.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from nerf_mae_torch import tracing
from nerf_mae_torch.config import MAEConfig, TrainConfig
from nerf_mae_torch.convert import head_params_from_jax
from nerf_mae_torch.models.heads import (
    VoxelSemantics3D,
    VoxelSR3D,
    voxel_semantics_loss,
    voxel_sr_loss,
)
from nerf_mae_torch.parallel.mesh import DataMesh
from nerf_mae_torch.train.checkpoint import graft_mae
from nerf_mae_torch.train.trainer import _DROPPATH, Trainer, TrainState, traced_step


class _DenseHeadTrainer(Trainer):
    kind = ""  # head_params_from_jax's

    def params_from_jax(self, tree) -> Dict[str, torch.Tensor]:
        return head_params_from_jax(tree, self.mae_cfg, self.kind)

    def graft_mae(self, state: TrainState,
                  mae_params: Dict[str, torch.Tensor]) -> TrainState:
        """Copy a pretrained MAE's trunk and decoder4/3/2 (a port MAE state
        dict) into the head's `base`; decoder1, encoder1 and the 1x1 head
        keep their initialization."""
        grafted = graft_mae(state.model.state_dict(), mae_params)
        state.model.load_state_dict(grafted)
        return state

    def _loss(self, out: torch.Tensor, batch: Dict[str, torch.Tensor]):
        raise NotImplementedError

    def _traced_loss(self, out: torch.Tensor, batch: Dict[str, torch.Tensor]):
        """_loss inside the span nerf_mae.loss, the loss marked for its
        backward record."""
        with tracing.span("nerf_mae.loss"):
            loss, aux = self._loss(out, batch)
            return tracing.mark(loss, "nerf_mae.loss"), aux

    @traced_step
    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor]):
        """One optimizer step; returns (state, metrics): 0-d device tensors,
        the loss, the aux metrics and grad_norm (before clipping)."""
        model = state.model
        with tracing.span("nerf_mae.forward"):
            model.train()
            out = model(batch["grids"], False,
                        droppath_generator=self._generator(state.seed, state.step, _DROPPATH,
                                                           batch["grids"].shape[0]))
            loss, aux = self._traced_loss(out, batch)
        grad_norm = self._update(state, loss)
        return state, self._global({"loss": loss.detach(), **aux, "grad_norm": grad_norm})

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict:
        model = state.model
        model.eval()
        out = model(batch["grids"], True)
        loss, aux = self._traced_loss(out, batch)
        return self._global({"loss": loss, **aux, **self._eval_extra(out)})

    def _eval_extra(self, out: torch.Tensor) -> Dict:
        return {}


class VoxelSRTrainer(_DenseHeadTrainer):
    kind = "sr"

    def __init__(self, mae_cfg: MAEConfig, train_cfg: TrainConfig, total_steps: int,
                 device="cuda", out_resolution: int = 256, mesh: Optional[DataMesh] = None):
        super().__init__(mae_cfg, train_cfg, total_steps, device, mesh)
        self.out_resolution = out_resolution

    def _build_model(self) -> VoxelSR3D:
        return VoxelSR3D(self.mae_cfg, self.out_resolution, device=self.device)

    def _loss(self, out, batch):
        return voxel_sr_loss(out, batch["out_grids"], self.count_sum)


class VoxelSemanticsTrainer(_DenseHeadTrainer):
    """eval_step also returns `pred_labels` [B, R, R, R] (argmax)."""

    kind = "semantics"

    def __init__(self, mae_cfg: MAEConfig, train_cfg: TrainConfig, total_steps: int,
                 device="cuda", num_classes: int = 19,
                 class_weights: Optional[np.ndarray] = None, mesh: Optional[DataMesh] = None):
        super().__init__(mae_cfg, train_cfg, total_steps, device, mesh)
        self.num_classes = num_classes
        self.class_weights = (None if class_weights is None else
                              torch.as_tensor(np.asarray(class_weights, np.float32),
                                              device=self.device))

    def _build_model(self) -> VoxelSemantics3D:
        return VoxelSemantics3D(self.mae_cfg, self.num_classes, device=self.device)

    def _loss(self, out, batch):
        return voxel_semantics_loss(out, batch["semantics"], self.class_weights,
                                    self.count_sum)

    def _eval_extra(self, out):
        return {"pred_labels": out.argmax(-1)}
