"""FCOSDetector: backbone + FPN + FCOS head (counterpart of
nerf_mae_tpu/models/detector.py; reference: nerf_rpn/model/fcos/
fcos.py:339-474 FCOSOverNeRF, run_fcos_pretrained.py:401-426).

    model = FCOSDetector(SWIN_PRESETS["swin_s"], FCOSConfig(use_obb=True))
    model.init_weights(seed=0)
    loss, aux = model(grids, sizes, gt_boxes, gt_valid, deterministic=False,
                      training=True, droppath_generator=gen)
    det = model(grids, sizes)  # boxes [B, K, 7], scores, levels, valid

backbone: "swin_t/s/b/l/nano" (SwinFPN, graftable from a MAE), "resnet",
"vgg_AF" or "vgg_EF". Parameters are created on `device` (default: the CUDA
card) uninitialised: load a state dict or call `init_weights`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from nerf_mae_torch.config import SwinConfig
from nerf_mae_torch.metrics import CountSum, one_rank
from nerf_mae_torch.models.backbones import init_body, make_body
from nerf_mae_torch.models.fcos import (
    FCOSConfig,
    FCOSHead,
    fcos_loss,
    fcos_objectness,
    fcos_postprocess,
)


class FCOSDetector(nn.Module):
    """grids [B, R, R, R, 4] + padded GT -> losses (training) or detections."""

    def __init__(self, swin: SwinConfig, fcos: FCOSConfig, backbone: str = "swin_s",
                 out_channels: int = 256, dtype: torch.dtype = torch.bfloat16,
                 remat: bool = True, output_objectness: bool = False, device="cuda"):
        super().__init__()
        self.fcos, self.backbone = fcos, backbone
        self.output_objectness = output_objectness
        self.body = make_body(backbone, swin, out_channels, dtype, remat, device)
        self.head = FCOSHead(fcos, out_channels, dtype=dtype, device=device)

    @torch.no_grad()
    def init_weights(self, seed: int) -> "FCOSDetector":
        """Random weights from `seed`: the body as init_body makes them,
        then the head's own initializers (FCOSHead.init_weights)."""
        self.head.init_weights(init_body(self.body, seed))
        return self

    def forward(self, grids: torch.Tensor, sizes: torch.Tensor,
                gt_boxes: Optional[torch.Tensor] = None,
                gt_valid: Optional[torch.Tensor] = None, deterministic: bool = True,
                training: bool = False,
                droppath_generator: Optional[torch.Generator] = None,
                count_sum: CountSum = one_rank):
        """training: (loss, {loss_cls, loss_reg, loss_centerness, num_pos}),
        `count_sum` going to fcos_loss; else the post-processed detections
        (fcos_postprocess), with the per-level objectness grids
        `objectness_level{i}` when output_objectness. A training forward
        (deterministic=False) draws the stochastic-depth keep factors from
        `droppath_generator`."""
        feats = self.body(grids, deterministic, droppath_generator)
        logits, bbox_reg, ctr = self.head(feats)
        if training:
            return fcos_loss(self.fcos, logits, bbox_reg, ctr, gt_boxes, gt_valid, sizes,
                             count_sum)
        out = fcos_postprocess(self.fcos, logits, bbox_reg, ctr, sizes)
        if self.output_objectness:
            for lvl, ob in enumerate(fcos_objectness(logits, ctr)):
                out[f"objectness_level{lvl}"] = ob
        return out
