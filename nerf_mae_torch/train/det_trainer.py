"""Detection trainer for FCOSDetector (counterpart of
nerf_mae_tpu/train/det_trainer.py, with its data mesh).

    trainer = DetectionTrainer(swin, fcos, train_cfg, total_steps, "cuda")
    state = trainer.init(seed=0)
    state = trainer.graft_mae(state, mae_state_dict)
    state, metrics = trainer.train_step(state, batch)
    det = trainer.predict_step(state, batch)

The reference's recipe (reference: nerf_rpn/run_fcos_pretrained.py:
310-1014): loss = cls + reg + centerness, AdamW + OneCycle + the clip with
its non-finite guard (train/optim.py, shared with the MAE trainer).
Stochastic depth is drawn from a generator seeded by (seed, step). On a
data-parallel mesh, as Trainer describes: num_pos and the centerness sum
are the global batch's. Batches
are tensors on the trainer's device: {"grids": [B, R, R, R, 4], "sizes":
[B, 3], "gt_boxes": [B, G, 6|7], "gt_valid": [B, G]}. The detector is 256
wide: the JAX trainer passes no width on either.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from nerf_mae_torch.config import SwinConfig, TrainConfig
from nerf_mae_torch.convert import det_params_from_jax
from nerf_mae_torch.models.detector import FCOSDetector
from nerf_mae_torch.models.fcos import FCOSConfig
from nerf_mae_torch.parallel.mesh import DataMesh
from nerf_mae_torch.train.checkpoint import extract_trunk, load_trunk_into
from nerf_mae_torch.train.trainer import _DROPPATH, Trainer, TrainState


class DetectionTrainer(Trainer):
    def __init__(self, swin: SwinConfig, fcos: FCOSConfig, train_cfg: TrainConfig,
                 total_steps: int, device="cuda", backbone: str = "swin_s",
                 compute_dtype: str = "bfloat16", remat: bool = True,
                 output_objectness: bool = False, mesh: Optional[DataMesh] = None):
        super().__init__(None, train_cfg, total_steps, device, mesh)
        self.swin, self.fcos, self.backbone = swin, fcos, backbone
        self.dtype = getattr(torch, compute_dtype)
        self.remat, self.output_objectness = remat, output_objectness

    def _build_model(self) -> FCOSDetector:
        return FCOSDetector(self.swin, self.fcos, self.backbone, dtype=self.dtype,
                            remat=self.remat, output_objectness=self.output_objectness,
                            device=self.device)

    def _init_model(self, seed: int) -> FCOSDetector:
        return self._build_model().init_weights(seed)

    def graft_mae(self, state: TrainState, mae_params: Dict[str, torch.Tensor]) -> TrainState:
        """Load a pretrained MAE's trunk (a port MAE state dict: its
        patch_partition and stages) into the Swin body; the FPN and the head
        keep their weights (reference: feature_extractor.py:1155-1176)."""
        trunk = {f"body.{k}": v for k, v in extract_trunk(mae_params).items()}
        state.model.load_state_dict(load_trunk_into(state.model.state_dict(), trunk))
        return state

    graft_mae_trunk = graft_mae  # the JAX trainer's name

    def params_from_jax(self, tree) -> Dict[str, torch.Tensor]:
        return det_params_from_jax(tree, self.swin, self.fcos, self.backbone)

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor]):
        """One optimizer step; returns (state, metrics): 0-d device tensors
        loss_cls, loss_reg, loss_centerness, num_pos, loss and grad_norm
        (before clipping)."""
        model = state.model
        model.train()
        b = batch["grids"].shape[0]
        loss, aux = model(batch["grids"], batch["sizes"], batch["gt_boxes"], batch["gt_valid"],
                          deterministic=False, training=True,
                          droppath_generator=self._generator(state.seed, state.step, _DROPPATH,
                                                             b),
                          count_sum=self.count_sum)
        grad_norm = self._update(state, loss)
        metrics = {k: v.detach() for k, v in aux.items()}
        return state, self._global({**metrics, "loss": loss.detach(), "grad_norm": grad_norm})

    @torch.no_grad()
    def predict_step(self, state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict:
        """Post-processed detections of the batch (FCOSDetector.forward)."""
        model = state.model
        model.eval()
        return model(batch["grids"], batch["sizes"])
