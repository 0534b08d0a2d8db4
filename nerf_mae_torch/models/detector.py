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
from nerf_mae_torch.models.backbones import ResNetFPN, SwinFPN, VGGFPN
from nerf_mae_torch.models.fcos import (
    FCOSConfig,
    FCOSHead,
    fcos_loss,
    fcos_objectness,
    fcos_postprocess,
)
from nerf_mae_torch.models.mae import init_weights as init_trunk_weights


class FCOSDetector(nn.Module):
    """grids [B, R, R, R, 4] + padded GT -> losses (training) or detections."""

    def __init__(self, swin: SwinConfig, fcos: FCOSConfig, backbone: str = "swin_s",
                 out_channels: int = 256, dtype: torch.dtype = torch.bfloat16,
                 remat: bool = True, output_objectness: bool = False, device="cuda"):
        super().__init__()
        self.fcos, self.backbone = fcos, backbone
        self.output_objectness = output_objectness
        if backbone.startswith("swin"):
            self.body = SwinFPN(swin, out_channels=out_channels, dtype=dtype, remat=remat,
                                device=device)
        elif backbone == "resnet":
            self.body = ResNetFPN(out_channels=out_channels, dtype=dtype, device=device)
        elif backbone.startswith("vgg"):
            self.body = VGGFPN(backbone.split("_")[1], out_channels=out_channels, dtype=dtype,
                               device=device)
        else:
            raise ValueError(f"unknown backbone {backbone}")
        self.head = FCOSHead(fcos, out_channels, dtype=dtype, device=device)

    @torch.no_grad()
    def init_weights(self, seed: int) -> "FCOSDetector":
        """Random weights from `seed`: a Swin trunk as models.mae.init_weights
        makes it, xavier-uniform FPN kernels, fan-in normal kernels in the
        ResNet / VGG bodies, GroupNorm ones / zeros, zero biases, and the
        head's own initializers (FCOSHead.init_weights)."""
        dev = self.head.scales.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        if isinstance(self.body, SwinFPN):
            init_trunk_weights(self.body, seed)
        for name, p in self.body.named_parameters():
            if name.startswith(("patch_partition.", "stages.")):
                continue
            if name.startswith("fpn.") and p.ndim == 5:
                fan_in, fan_out = p[0].numel(), p[:, 0].numel()
                lim = (6.0 / (fan_in + fan_out)) ** 0.5
                p.uniform_(-lim, lim, generator=gen)
            elif p.ndim == 5:
                p.normal_(0.0, p[0].numel() ** -0.5, generator=gen)
            else:  # GroupNorm scale / bias, conv biases
                is_scale = name.endswith("weight") and p.ndim == 1
                p.fill_(1.0 if is_scale else 0.0)
        self.head.init_weights(gen)
        return self

    def forward(self, grids: torch.Tensor, sizes: torch.Tensor,
                gt_boxes: Optional[torch.Tensor] = None,
                gt_valid: Optional[torch.Tensor] = None, deterministic: bool = True,
                training: bool = False,
                droppath_generator: Optional[torch.Generator] = None):
        """training: (loss, {loss_cls, loss_reg, loss_centerness, num_pos});
        else the post-processed detections (fcos_postprocess), with the
        per-level objectness grids `objectness_level{i}` when
        output_objectness. A training forward (deterministic=False) draws the
        stochastic-depth keep factors from `droppath_generator`."""
        feats = self.body(grids, deterministic, droppath_generator)
        logits, bbox_reg, ctr = self.head(feats)
        if training:
            return fcos_loss(self.fcos, logits, bbox_reg, ctr, gt_boxes, gt_valid, sizes)
        out = fcos_postprocess(self.fcos, logits, bbox_reg, ctr, sizes)
        if self.output_objectness:
            for lvl, ob in enumerate(fcos_objectness(logits, ctr)):
                out[f"objectness_level{lvl}"] = ob
        return out
