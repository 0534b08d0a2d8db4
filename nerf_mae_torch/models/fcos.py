"""FCOS-style 3D detection head, loss and post-processing (counterpart of
nerf_mae_tpu/models/fcos.py).

The reference FCOS stack (reference: nerf_rpn/model/fcos/fcos.py:26-474,
fcos/loss.py:174-591, fcos/inference.py:11-195): shared cls / box towers
(4 x conv + GroupNorm(32) + ReLU) over the FPN levels with a learned scale
per level, focal-loss classification, (rotated) IoU box regression weighted
by centerness, centerness BCE, and a fixed-shape post-processor (masked
top-k, decode, NMS, final top-k).

GT boxes are padded [B, G, 6|7] with `gt_valid`; scene extents `sizes [B, 3]`;
detections are fixed-size [B, K, ...] with a validity mask. GroupNorm is
flax's (epsilon 1e-6, float32 statistics and output), so each tower runs
bf16 conv -> float32 GN -> float32 ReLU -> bf16 at the next conv.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nerf_mae_torch.metrics import CountSum, one_rank
from nerf_mae_torch.models.swin import Norm
from nerf_mae_torch.models.unetr import Conv3d, group_norm
from nerf_mae_torch.ops.boxes import clip_boxes_to_grid, small_box_mask
from nerf_mae_torch.ops.fcos_box import decode_fcos_aabb, decode_fcos_obb
from nerf_mae_torch.ops.fcos_targets import (
    assign_fcos_targets,
    centerness_targets,
    level_geometry,
)
from nerf_mae_torch.ops.nms import nms_mask, sort_desc, topk_by_score
from nerf_mae_torch.ops.rotated_iou import diou_3d_loss, giou_3d_loss, iou_3d


@dataclasses.dataclass(frozen=True)
class FCOSConfig:
    resolution: int = 160
    strides: Sequence[int] = (4, 8, 16, 32)
    num_convs: int = 4
    use_obb: bool = False
    norm_reg_targets: bool = True
    centerness_on_reg: bool = True
    center_sampling_radius: float = 1.5
    iou_loss_type: str = "iou"  # iou | linear_iou | giou | diou | smooth_l1
    use_additional_l1_loss: bool = False
    reg_loss_weight: float = 1.0  # (reference: run_fcos_pretrained.py:154)
    proj2d_loss_weight: float = 0.0  # OBB-only aux loss (fcos/loss.py:579)
    # post-processing (reference: run_fcos_pretrained.py:273-292)
    pre_nms_thresh: float = 0.0
    pre_nms_top_n: int = 2500
    nms_thresh: float = 0.3
    post_nms_top_n: int = 2500
    min_size: float = 0.0
    max_gt: int = 64  # padded GT capacity per scene
    # True starts the reg head at the reference's zero bias (fcos.py:121-135);
    # the default starts the 6 distance channels at 0.5, off the zero-volume
    # plateau of the IoU loss (the JAX package's _reg_bias_init)
    reference_init: bool = False

    @property
    def reg_dim(self) -> int:
        return 8 if self.use_obb else 6


class FCOSHead(nn.Module):
    """Weight-shared towers over the FPN levels (reference:
    fcos/fcos.py:26-139). Returns per level (logits [B, *S, 1], bbox
    [B, *S, 6|8], centerness [B, *S, 1]), all float32."""

    def __init__(self, cfg: FCOSConfig, in_channels: int = 256,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        for i in range(cfg.num_convs):
            for tower in ("cls", "box"):
                self.add_module(f"{tower}_tower{i}",
                                Conv3d(in_channels, in_channels, 3, device=device))
                self.add_module(f"{tower}_gn{i}", Norm(in_channels, device=device))
        self.cls_logits = Conv3d(in_channels, 1, 3, device=device)
        self.bbox_pred = Conv3d(in_channels, cfg.reg_dim, 3, device=device)
        self.centerness = Conv3d(in_channels, 1, 3, device=device)
        self.scales = nn.Parameter(torch.ones(len(cfg.strides), device=device))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """The JAX initializers: conv kernels normal(0.01), zero biases but
        cls_logits' -log((1 - 0.01) / 0.01) and bbox_pred's 0.5 on the 6
        distance channels (0 with reference_init), GroupNorm ones / zeros,
        scales ones."""
        for name, p in self.named_parameters():
            if p.ndim == 5:
                p.normal_(0.0, 0.01, generator=gen)
            elif "_gn" in name:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            else:
                p.fill_(1.0 if name == "scales" else 0.0)
        self.cls_logits.bias.fill_(-float(np.log((1 - 0.01) / 0.01)))
        if not self.cfg.reference_init:
            self.bbox_pred.bias[:6] = 0.5

    def _tower(self, x: torch.Tensor, tower: str) -> torch.Tensor:
        for i in range(self.cfg.num_convs):
            gn = getattr(self, f"{tower}_gn{i}")
            x = getattr(self, f"{tower}_tower{i}")(x, self.dtype)
            x = F.relu(group_norm(x, gn.weight, gn.bias, 32))
        return x

    def forward(self, features: List[torch.Tensor]):
        cfg, dt = self.cfg, self.dtype
        logits, bbox_reg, ctr = [], [], []
        for lvl, feat in enumerate(features):
            c = self._tower(feat, "cls")
            b = self._tower(feat, "box")
            logits.append(self.cls_logits(c, dt).float())
            ctr.append(self.centerness(b if cfg.centerness_on_reg else c, dt).float())
            reg = self.bbox_pred(b, dt).float() * self.scales[lvl]
            # distances through relu; the OBB midpoint offsets stay raw
            # (reference: fcos/fcos.py:121-135)
            bbox_reg.append(torch.cat([F.relu(reg[..., :6]), reg[..., 6:]], dim=-1))
        return logits, bbox_reg, ctr


def _flatten_levels(xs: List[torch.Tensor], last_dim: int) -> torch.Tensor:
    """[[B, W, L, H, C] per level] -> [B, sum(WLH), C]."""
    return torch.cat([x.reshape(x.shape[0], -1, last_dim) for x in xs], dim=1)


def sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy's formula."""
    return torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """Elementwise sigmoid focal loss (torchvision semantics, as the
    reference at fcos/loss.py:182,538)."""
    p = torch.sigmoid(logits)
    ce = sigmoid_ce(logits, targets)
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = loss * (alpha * targets + (1 - alpha) * (1 - targets))
    return loss


def _smooth_l1(pred, target, beta: float = 1.0):
    d = (pred - target).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def _aabb_iou_loss(pred, target, loss_type: str):
    """Offset-space AABB IoU / GIoU loss (reference: fcos/loss.py:77-132);
    pred and target [..., 6] non-negative distances."""
    pl, pt, pf, pr, pb, pk = (pred[..., i] for i in range(6))
    tl, tt, tf, tr, tb, tk = (target[..., i] for i in range(6))
    tv = (tl + tr) * (tt + tb) * (tf + tk)
    pv = (pl + pr) * (pt + pb) * (pf + pk)
    wi = torch.minimum(pl, tl) + torch.minimum(pr, tr)
    gwi = torch.maximum(pl, tl) + torch.maximum(pr, tr)
    hi = torch.minimum(pb, tb) + torch.minimum(pt, tt)
    ghi = torch.maximum(pb, tb) + torch.maximum(pt, tt)
    di = torch.minimum(pf, tf) + torch.minimum(pk, tk)
    gdi = torch.maximum(pf, tf) + torch.maximum(pk, tk)
    ac = gwi * ghi * gdi + 1e-7
    inter = wi * hi * di
    union = tv + pv - inter
    ious = (inter + 1.0) / (union + 1.0)
    if loss_type == "iou":
        return -torch.log(torch.clamp(ious, min=1e-7))
    if loss_type == "linear_iou":
        return 1.0 - ious
    if loss_type == "giou":
        return 1.0 - (ious - (ac - union) / ac)
    raise ValueError(loss_type)


def fcos_targets(cfg: FCOSConfig, gt_boxes: torch.Tensor, gt_valid: torch.Tensor):
    """(labels [B, L], reg_targets [B, L, 6|8], normalized by the stride
    where cfg.norm_reg_targets) on gt_boxes' device; no gradient."""
    _, locations, strides, size_ranges = level_geometry(
        cfg.resolution, tuple(cfg.strides), gt_boxes.device)
    labels, reg_targets = assign_fcos_targets(
        locations, strides, size_ranges, gt_boxes.float(), gt_valid.bool(),
        cfg.center_sampling_radius, cfg.use_obb)
    if cfg.norm_reg_targets:
        reg_targets = torch.cat([reg_targets[..., :6] / strides[None, :, None],
                                 reg_targets[..., 6:]], dim=-1)
    return labels, reg_targets


def fcos_loss(cfg: FCOSConfig, logits: List[torch.Tensor], bbox_reg: List[torch.Tensor],
              ctr: List[torch.Tensor], gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
              sizes: torch.Tensor, count_sum: CountSum = one_rank):
    """Returns (total, {loss_cls, loss_reg, loss_centerness, num_pos}), as
    FCOSLossComputation (reference: fcos/loss.py:477-591) and the JAX
    fcos_loss compute them. `count_sum` makes num_pos and the centerness sum
    global before their clamps; the aux num_pos counts the rows given."""
    _, locations, _, _ = level_geometry(cfg.resolution, tuple(cfg.strides), logits[0].device)
    labels, reg_targets = fcos_targets(cfg, gt_boxes, gt_valid)  # [B, L], [B, L, 6|8]

    cls_flat = _flatten_levels(logits, 1)[..., 0]  # [B, L]
    reg_flat = _flatten_levels(bbox_reg, cfg.reg_dim)  # [B, L, 6|8]
    ctr_flat = _flatten_levels(ctr, 1)[..., 0]  # [B, L]

    # padding mask: the location's centre inside the unpadded extent
    # (reference: fcos/fcos.py:301-320)
    pad_valid = (locations[None] < sizes[:, None, :]).all(-1).float()  # [B, L]
    pos = labels * pad_valid
    num_pos = pos.sum()
    ctr_targets = centerness_targets(reg_targets)  # [B, L]
    total_pos, total_ctr = count_sum(torch.stack([num_pos, (ctr_targets * pos).sum()]))
    num_pos_norm = torch.clamp(total_pos, min=1.0)
    sum_ctr = torch.clamp(total_ctr, min=1e-6)

    cls_loss = (sigmoid_focal_loss(cls_flat, labels) * pad_valid).sum() / num_pos_norm

    if cfg.iou_loss_type == "smooth_l1":
        per_loc = _smooth_l1(reg_flat, reg_targets).sum(-1)
        reg_loss = (per_loc * ctr_targets * pos).sum() / sum_ctr
    elif cfg.use_obb:
        dummy = torch.zeros(reg_flat.shape[:-1] + (3,), device=reg_flat.device)
        # non-positive locations are replaced BEFORE decoding: zero offsets
        # make degenerate boxes whose norm / polygon gradients are NaN, and a
        # later where() does not stop a NaN in the backward (0 * NaN = NaN)
        posm = pos[..., None] > 0
        safe = torch.ones(8, device=reg_flat.device)  # [1] * 6 + [0.2] * 2, made on
        safe[6:] = 0.2  # the device: a host tensor's copy would wait for the card
        pred_boxes = decode_fcos_obb(dummy, torch.where(posm, reg_flat, safe))
        tgt_boxes = decode_fcos_obb(dummy, torch.where(posm, reg_targets, safe))
        if cfg.iou_loss_type == "giou":
            per_loc = giou_3d_loss(pred_boxes, tgt_boxes)
        elif cfg.iou_loss_type == "diou":
            per_loc = diou_3d_loss(pred_boxes, tgt_boxes)
        else:
            iou, union = iou_3d(pred_boxes, tgt_boxes, return_union=True)
            smooth = (iou * union + 1.0) / (union + 1.0)
            per_loc = (-torch.log(torch.clamp(smooth, min=1e-7))
                       if cfg.iou_loss_type == "iou" else 1.0 - smooth)
        reg_loss = (per_loc * ctr_targets * pos).sum() / sum_ctr
        if cfg.use_additional_l1_loss:
            l1 = _smooth_l1(reg_flat[..., 6:], reg_targets[..., 6:]).sum(-1)
            reg_loss = reg_loss + (l1 * ctr_targets * pos).sum() / sum_ctr
    else:
        per_loc = _aabb_iou_loss(reg_flat, reg_targets, cfg.iou_loss_type)
        reg_loss = (per_loc * ctr_targets * pos).sum() / sum_ctr

    ctr_loss = (sigmoid_ce(ctr_flat, ctr_targets) * pos).sum() / num_pos_norm

    if cfg.use_obb and cfg.proj2d_loss_weight > 0:
        from nerf_mae_torch.ops.projection import projection_2d_loss

        # the reference's centerness-weighted pixel smooth-L1 / (4 views x 2
        # points x 2 coords), then / the centerness sum (fcos/loss.py:473-475,
        # :581-585)
        loss_2d = projection_2d_loss(pred_boxes, tgt_boxes, ctr_targets * pos,
                                     cfg.resolution) / 16.0 / sum_ctr
        reg_loss = reg_loss + cfg.proj2d_loss_weight * loss_2d

    total = cls_loss + cfg.reg_loss_weight * reg_loss + ctr_loss
    return total, {"loss_cls": cls_loss, "loss_reg": reg_loss,
                   "loss_centerness": ctr_loss, "num_pos": num_pos}


def fcos_objectness(logits: List[torch.Tensor], ctr: List[torch.Tensor]) -> List[torch.Tensor]:
    """Per-level per-voxel objectness sqrt(sigmoid(cls) * sigmoid(ctr))
    (reference: fcos/fcos.py:322-337 output_objectness)."""
    return [torch.sqrt(torch.clamp(torch.sigmoid(l[..., 0].float())
                                   * torch.sigmoid(c[..., 0].float()), min=0.0))
            for l, c in zip(logits, ctr)]


@torch.no_grad()
def fcos_candidates(cfg: FCOSConfig, logits: List[torch.Tensor], bbox_reg: List[torch.Tensor],
                    ctr: List[torch.Tensor], sizes: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The per-level half of the post-processing (reference:
    fcos/inference.py:11-195): sigmoid scores masked by padding and
    pre_nms_thresh, the top min(pre_nms_top_n, Li) per level (ties to the
    lower index), decoded at their locations. Returns boxes [B, N, 7] (OBB
    form; AABBs as (centre, size, 0) after clipping to the scene), scores
    [B, N] (0 where invalid), levels [B, N], valid [B, N]."""
    per_level, _, _, _ = level_geometry(cfg.resolution, tuple(cfg.strides), logits[0].device)
    b = logits[0].shape[0]
    boxes_all, scores_all, level_all, valid_all = [], [], [], []
    for lvl in range(len(logits)):
        locs = per_level[lvl]  # [Li, 3]
        n_i = locs.shape[0]
        cls = torch.sigmoid(logits[lvl].reshape(b, -1).float())  # [B, Li]
        ctr_s = torch.sigmoid(ctr[lvl].reshape(b, -1).float())
        reg = bbox_reg[lvl].reshape(b, n_i, cfg.reg_dim).float()
        if cfg.norm_reg_targets:
            reg = torch.cat([reg[..., :6] * cfg.strides[lvl], reg[..., 6:]], dim=-1)

        pad_valid = (locs[None] < sizes[:, None, :]).all(-1)  # [B, Li]
        cand = (cls > cfg.pre_nms_thresh) & pad_valid
        score = torch.sqrt(torch.clamp(cls * ctr_s, min=0.0))
        top_scores, top_idx, ok = topk_by_score(score, min(cfg.pre_nms_top_n, n_i), cand)
        top_locs = locs[top_idx]  # [B, k, 3]
        top_reg = torch.gather(reg, 1, top_idx[..., None].expand(-1, -1, reg.shape[-1]))
        if cfg.use_obb:
            det = decode_fcos_obb(top_locs, top_reg)  # [B, k, 7]
        else:
            aabb = decode_fcos_aabb(top_locs, top_reg)  # [B, k, 6]
            aabb = clip_boxes_to_grid(aabb, sizes.to(aabb.dtype)[:, None, :])
            c = (aabb[..., :3] + aabb[..., 3:6]) / 2
            s = aabb[..., 3:6] - aabb[..., :3]
            det = torch.cat([c, s, torch.zeros_like(c[..., :1])], dim=-1)
        if cfg.min_size > 0:
            ok = ok & small_box_mask(det, cfg.min_size)
        boxes_all.append(det)
        scores_all.append(torch.where(ok, top_scores, torch.zeros_like(top_scores)))
        level_all.append(torch.full(ok.shape, lvl, dtype=torch.int32, device=ok.device))
        valid_all.append(ok)
    return {"boxes": torch.cat(boxes_all, 1), "scores": torch.cat(scores_all, 1),
            "levels": torch.cat(level_all, 1), "valid": torch.cat(valid_all, 1)}


def nms_boxes(cfg: FCOSConfig, boxes: torch.Tensor) -> torch.Tensor:
    """What NMS compares: the OBBs, or in AABB mode the corner form of the
    (centre, size) boxes."""
    if cfg.use_obb:
        return boxes
    return torch.cat([boxes[..., :3] - boxes[..., 3:6] / 2,
                      boxes[..., :3] + boxes[..., 3:6] / 2], dim=-1)


@torch.no_grad()
def fcos_select(cfg: FCOSConfig, cand: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The joint half: NMS per scene (rotated IoU for OBB, AABB IoU
    otherwise), then the final top min(post_nms_top_n, N) by score. Returns
    boxes [B, K, 7], scores [B, K] (0 where invalid), levels [B, K], valid
    [B, K]."""
    boxes, scores, valid = cand["boxes"], cand["scores"], cand["valid"]
    keep = nms_mask(nms_boxes(cfg, boxes), scores, cfg.nms_thresh, valid=valid,
                    max_keep=cfg.post_nms_top_n)
    k_out = min(cfg.post_nms_top_n, boxes.shape[1])
    final = torch.where(keep, scores, torch.full_like(scores, float("-inf")))
    top_idx = sort_desc(final)[:, :k_out]
    top_scores = torch.gather(final, 1, top_idx)
    ok = torch.isfinite(top_scores)
    return {
        "boxes": torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, boxes.shape[-1])),
        "scores": torch.where(ok, top_scores, torch.zeros_like(top_scores)),
        "levels": torch.gather(cand["levels"], 1, top_idx),
        "valid": ok,
    }


def fcos_postprocess(cfg: FCOSConfig, logits: List[torch.Tensor], bbox_reg: List[torch.Tensor],
                     ctr: List[torch.Tensor], sizes: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Fixed-shape detection decoding (reference: fcos/inference.py:11-195):
    fcos_candidates, then fcos_select."""
    return fcos_select(cfg, fcos_candidates(cfg, logits, bbox_reg, ctr, sizes))
