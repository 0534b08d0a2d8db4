"""Trainers of the anchor RPN and of the RCNN second stage (counterpart of
nerf_mae_tpu/train/rpn_trainer.py, with its data mesh, and of the RCNN step
in scripts/run_rpn_detect.py).

    trainer = RPNTrainer(swin, rpn, train_cfg, total_steps, "cuda")
    state = trainer.init(seed=0)
    state = trainer.graft_mae(state, mae_state_dict)
    state, metrics = trainer.train_step(state, batch)
    proposals = trainer.predict_step(state, batch)

    rcnn = RCNNTrainer(rcnn_cfg, train_cfg, total_steps, "cuda")
    state = rcnn.init(seed=0)
    state, metrics = rcnn.train_step(state, feats, proposals, batch)

AdamW + OneCycle + the clip with its non-finite guard (train/optim.py, as
the other trainers). Stochastic depth and the samplers' draws come from
generators seeded by (seed, step). On a data-parallel mesh, as Trainer
describes: the matcher and the samplers stay per scene, their draws are
made for the global batch and sliced, and the losses' counts are the
global batch's. Batches are tensors on the trainer's
device: {"grids": [B, R, R, R, 4], "sizes": [B, 3], "gt_boxes": [B, G,
6|7], "gt_valid": [B, G]}.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from nerf_mae_torch.config import SwinConfig, TrainConfig
from nerf_mae_torch.convert import rcnn_params_from_jax, rpn_params_from_jax
from nerf_mae_torch.models.rcnn import RCNNConfig, RCNNStage
from nerf_mae_torch.models.rpn import NeRFRPN, RPNConfig
from nerf_mae_torch.parallel.mesh import DataMesh
from nerf_mae_torch.train.det_trainer import DetectionTrainer
from nerf_mae_torch.train.trainer import _DROPPATH, Trainer, TrainState

_SAMPLE = 2  # the generator stream of a step's sampler draws


class RPNTrainer(Trainer):
    def __init__(self, swin: SwinConfig, rpn: RPNConfig, train_cfg: TrainConfig,
                 total_steps: int, device="cuda", backbone: str = "swin_s",
                 compute_dtype: str = "bfloat16", remat: bool = True,
                 mesh: Optional[DataMesh] = None):
        super().__init__(None, train_cfg, total_steps, device, mesh)
        self.swin, self.rpn, self.backbone = swin, rpn, backbone
        self.dtype = getattr(torch, compute_dtype)
        self.remat = remat

    def _build_model(self) -> NeRFRPN:
        return NeRFRPN(self.swin, self.rpn, self.backbone, dtype=self.dtype, remat=self.remat,
                       device=self.device)

    def _init_model(self, seed: int) -> NeRFRPN:
        return self._build_model().init_weights(seed)

    # the MAE's patch embedding and stages into the Swin body, as the FCOS
    # detector's (the body is the same module under the same name)
    graft_mae = DetectionTrainer.graft_mae
    graft_mae_trunk = graft_mae  # the JAX trainer's name

    def params_from_jax(self, tree) -> Dict[str, torch.Tensor]:
        return rpn_params_from_jax(tree, self.swin, self.rpn, self.backbone)

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                   sample_draws: Optional[torch.Tensor] = None):
        """One optimizer step; returns (state, metrics): 0-d device tensors
        loss_objectness, loss_reg, num_pos, num_sampled, loss and grad_norm
        (before clipping). `sample_draws` [B, A] replaces the sampler's
        drawn uniforms (tests)."""
        model = state.model
        model.train()
        b = batch["grids"].shape[0]
        loss, aux = model(batch["grids"], batch["sizes"], batch["gt_boxes"], batch["gt_valid"],
                          deterministic=False, training=True,
                          droppath_generator=self._generator(state.seed, state.step, _DROPPATH,
                                                             b),
                          sample_generator=self._generator(state.seed, state.step, _SAMPLE, b),
                          sample_draws=sample_draws, count_sum=self.count_sum)
        grad_norm = self._update(state, loss)
        metrics = {k: v.detach() for k, v in aux.items()}
        return state, self._global({**metrics, "loss": loss.detach(), "grad_norm": grad_norm})

    @torch.no_grad()
    def predict_step(self, state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict:
        """The proposals of the batch (NeRFRPN.propose)."""
        model = state.model
        model.eval()
        return model(batch["grids"], batch["sizes"])


class RCNNTrainer(Trainer):
    """The RCNN stage over a frozen first stage's features and proposals."""

    def __init__(self, rcnn: RCNNConfig, train_cfg: TrainConfig, total_steps: int,
                 device="cuda", in_channels: int = 256, mesh: Optional[DataMesh] = None):
        super().__init__(None, train_cfg, total_steps, device, mesh)
        self.rcnn, self.in_channels = rcnn, in_channels

    def _build_model(self) -> RCNNStage:
        return RCNNStage(self.rcnn, self.in_channels, device=self.device)

    def _init_model(self, seed: int) -> RCNNStage:
        return self._build_model().init_weights(seed)

    def params_from_jax(self, tree) -> Dict[str, torch.Tensor]:
        return rcnn_params_from_jax(tree, self.rcnn, self.in_channels)

    def train_step(self, state: TrainState, feats: List[torch.Tensor],
                   proposals: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                   draws: Optional[torch.Tensor] = None):
        """One optimizer step on the RoIs sampled from `proposals` (boxes,
        valid); returns (state, metrics): loss_cls, loss_reg, num_pos, loss
        and grad_norm. `draws` [B, R] replaces the sampler's uniforms."""
        model = state.model
        model.train()
        loss, aux = model(feats, proposals["boxes"], proposals["valid"], batch["gt_boxes"],
                          batch["gt_valid"], draws=draws,
                          generator=self._generator(state.seed, state.step, _SAMPLE,
                                                    proposals["boxes"].shape[0]),
                          training=True, count_sum=self.count_sum)
        grad_norm = self._update(state, loss)
        metrics = {k: v.detach() for k, v in aux.items()}
        return state, self._global({**metrics, "loss": loss.detach(), "grad_norm": grad_norm})

    @torch.no_grad()
    def predict_step(self, state: TrainState, feats: List[torch.Tensor],
                     proposals: Dict[str, torch.Tensor]) -> Dict:
        """Refined boxes, foreground scores and validity of every proposal."""
        model = state.model
        model.eval()
        return model(feats, proposals["boxes"], proposals["valid"])
