"""RCNN second stage: RoI sampling, aligned pooling and a classification /
refinement head (counterpart of nerf_mae_tpu/models/rcnn.py; reference:
nerf_rpn/model/detector.py:12-641 ProposalTargetLayer, ROIPool, RCNN,
Classification_Model).

Proposals come padded, [B, R, 6] AABB corners or [B, R, 7] OBBs, with a
validity mask. Training samples rois_per_scene of them per scene (a
fixed-size FG / BG split ranked by a uniform draw), pools each over an S^3
lattice (ops/roi_align.py) and takes cross-entropy over the classes plus
smooth-L1 on the positives' deltas. Prediction scores and refines every
proposal. The head is float32 and channel-last: its flatten of [N, S, S, S,
C] is the JAX package's, so the dense layers' inputs line up.

    stage = RCNNStage(RCNNConfig(), device="cuda").init_weights(seed=0)
    loss, aux = stage(feats, boxes, valid, gt_boxes, gt_valid, generator=g,
                      training=True)
    det = stage(feats, boxes, valid)  # boxes, scores, valid
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from nerf_mae_torch.metrics import CountSum, one_rank
from nerf_mae_torch.models.unetr import Conv3d
from nerf_mae_torch.ops.anchors import rank_by_draw
from nerf_mae_torch.ops.boxes import box_iou_aabb, unit_box_where
from nerf_mae_torch.ops.coders import (
    decode_aabb_deltas,
    decode_rotated_deltas,
    encode_aabb_deltas,
    encode_rotated_deltas,
)
from nerf_mae_torch.ops.draws import batch_rand
from nerf_mae_torch.ops.nms import sort_desc
from nerf_mae_torch.ops.obb import obb2hbb_3d
from nerf_mae_torch.ops.roi_align import aabb_to_rois7, fpn_level_for_boxes, roi_align_rotated_3d


@dataclasses.dataclass(frozen=True)
class RCNNConfig:
    resolution: int = 160
    strides: Sequence[int] = (4, 8, 16, 32)
    rois_per_scene: int = 128
    fg_fraction: float = 0.5
    fg_threshold: float = 0.5
    bg_threshold: float = 0.2
    output_size: int = 5
    enlarge_scale: float = 0.2
    num_classes: int = 2
    rotated: bool = False
    conv_depth: int = 2

    @property
    def reg_dim(self) -> int:
        return 7 if self.rotated else 6


@torch.no_grad()
def sample_rois(cfg: RCNNConfig, proposals: torch.Tensor, prop_valid: torch.Tensor,
                gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                draws: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
    """FG / BG RoI sampling per scene (reference: detector.py:60-168):
    proposals [B, R, 6|7] (native form), gt_boxes [B, G, 6|7]; the uniform
    draws [B, R] are `draws` or come from `generator`. Returns (sel [B, K],
    labels [B, K] int64, matched_gt [B, K, 6|7], sel_valid [B, K]) with K =
    min(rois_per_scene, R): the sampled FG first, then the BG, then unused
    slots, each group by descending priority (ties to the lower index, as
    jax.lax.top_k)."""
    b, r = proposals.shape[:2]
    if draws is None:
        draws = batch_rand(generator, (b, r))
    to_aabb = obb2hbb_3d if cfg.rotated else (lambda x: x)
    iou = torch.stack([box_iou_aabb(p, g) for p, g in zip(to_aabb(proposals), to_aabb(gt_boxes))])
    iou = torch.where(gt_valid[:, None, :], iou, torch.full_like(iou, -1.0))  # [B, R, G]
    max_iou = iou.amax(-1)
    assign = torch.argmax(iou, dim=-1)
    fg = (max_iou >= cfg.fg_threshold) & prop_valid
    bg = (max_iou < cfg.bg_threshold) & prop_valid

    k = min(cfg.rois_per_scene, r)
    n_fg = torch.clamp(fg.sum(-1, keepdim=True), max=int(round(cfg.fg_fraction * k)))
    n_bg = torch.minimum(bg.sum(-1, keepdim=True), k - n_fg)
    take_fg = fg & (rank_by_draw(fg, draws) < n_fg)
    take_bg = bg & (rank_by_draw(bg, draws) < n_bg)
    priority = take_fg.float() * 2.0 + take_bg.float() + draws * 1e-3
    sel = sort_desc(priority)[:, :k]
    labels = torch.gather(take_fg, 1, sel).long()  # binary RPN classification
    sel_valid = torch.gather(take_fg | take_bg, 1, sel)
    idx = torch.gather(assign, 1, sel)
    matched = torch.gather(gt_boxes, 1, idx[..., None].expand(-1, -1, gt_boxes.shape[-1]))
    return sel, labels, matched, sel_valid


class RCNNHead(nn.Module):
    """conv_depth 3^3 convs with ReLU, the channel-last flatten, then dense
    layers to reg_dim deltas and num_classes scores (reference:
    detector.py:441-494). float32 out."""

    def __init__(self, cfg: RCNNConfig, in_channels: int = 256,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        for i in range(cfg.conv_depth):
            self.add_module(f"conv{i}", Conv3d(in_channels, in_channels, 3, device=device))
        flat = cfg.output_size ** 3 * in_channels
        self.bbox_pred = nn.Linear(flat, cfg.reg_dim, device=device)
        self.cls_score = nn.Linear(flat, cfg.num_classes, device=device)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """Fan-in normal kernels (flax's lecun-normal, untruncated), zero
        biases."""
        for p in self.parameters():
            if p.ndim == 1:
                p.zero_()
            else:
                p.normal_(0.0, p[0].numel() ** -0.5, generator=gen)

    def forward(self, pooled: torch.Tensor):
        x = pooled.to(self.dtype)
        for i in range(self.cfg.conv_depth):
            x = F.relu(getattr(self, f"conv{i}")(x, self.dtype))
        x = x.reshape(x.shape[0], -1)
        return self.bbox_pred(x).float(), self.cls_score(x).float()


def rcnn_loss(cfg: RCNNConfig, deltas: torch.Tensor, scores: torch.Tensor, rois: torch.Tensor,
              labels: torch.Tensor, matched: torch.Tensor, sel_valid: torch.Tensor,
              count_sum: CountSum = one_rank):
    """Cross-entropy over the valid sampled RoIs plus smooth-L1 (beta 1/9)
    on the positives' deltas (reference: detector.py:580-627). RoIs or
    targets with a side <= 1e-3 are dropped, and replaced by a unit box
    before encoding: their log-size deltas would be NaN, which survives a
    multiplication by a zero mask. `count_sum` makes the valid and positive
    counts global before their clamps. Returns (total, {loss_cls, loss_reg,
    num_pos}), num_pos of the rows given."""
    with torch.no_grad():
        side = lambda x: x[..., 3:6] if cfg.rotated else x[..., 3:6] - x[..., 0:3]
        ok = sel_valid & (side(rois) > 1e-3).all(-1) & (side(matched) > 1e-3).all(-1)
        rois_s, matched_s = unit_box_where(ok, rois), unit_box_where(ok, matched)
        reg_targets = (encode_rotated_deltas(matched_s, rois_s) if cfg.rotated
                       else encode_aabb_deltas(matched_s, rois_s))
    valid_f = ok.float()
    logp = F.log_softmax(scores, dim=-1)
    cls_nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    pos = (labels > 0).float() * valid_f
    n_valid, n_pos = count_sum(torch.stack([valid_f.sum(), pos.sum()]))
    cls_loss = (cls_nll * valid_f).sum() / torch.clamp(n_valid, min=1.0)
    d = (deltas - reg_targets).abs()
    beta = 1.0 / 9.0
    sl1 = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta).sum(-1)
    reg_loss = (sl1 * pos).sum() / torch.clamp(n_pos, min=1.0)
    return cls_loss + reg_loss, {"loss_cls": cls_loss, "loss_reg": reg_loss, "num_pos": pos.sum()}


class RCNNStage(nn.Module):
    """Second-stage classification and refinement over padded proposals
    (reference: detector.py:499-627 Classification_Model). Parameters are
    created on `device` uninitialised: load a state dict or call
    `init_weights`."""

    def __init__(self, cfg: RCNNConfig, in_channels: int = 256,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.head = RCNNHead(cfg, in_channels, dtype, device)

    @torch.no_grad()
    def init_weights(self, seed: int) -> "RCNNStage":
        gen = torch.Generator(device=self.head.bbox_pred.weight.device)
        gen.manual_seed(seed)
        self.head.init_weights(gen)
        return self

    def sample(self, proposals: torch.Tensor, prop_valid: torch.Tensor, gt_boxes: torch.Tensor,
               gt_valid: torch.Tensor, draws: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
        """sample_rois, with the sampled RoIs gathered: (rois [B, K, 6|7],
        labels, matched_gt, sel_valid)."""
        sel, labels, matched, sel_valid = sample_rois(self.cfg, proposals, prop_valid, gt_boxes,
                                                      gt_valid, draws, generator)
        rois = torch.gather(proposals, 1, sel[..., None].expand(-1, -1, proposals.shape[-1]))
        return rois, labels, matched, sel_valid

    def pool(self, features: List[torch.Tensor], rois: torch.Tensor) -> torch.Tensor:
        """rois [B, K, 6|7] (native form) -> [B, K, S, S, S, C] aligned
        from the FPN level of each RoI's volume."""
        cfg = self.cfg
        rois7 = aabb_to_rois7(rois) if rois.shape[-1] == 6 else rois
        levels = fpn_level_for_boxes(rois7, k_max=len(cfg.strides) - 1,
                                     canonical_scale=cfg.resolution)
        return roi_align_rotated_3d(features, rois7, levels, tuple(cfg.strides), cfg.output_size,
                                    cfg.enlarge_scale)

    def scores(self, pooled: torch.Tensor):
        """[B, K, S, S, S, C] -> (deltas [B, K, reg_dim], scores [B, K,
        num_classes])."""
        b, k = pooled.shape[:2]
        deltas, scores = self.head(pooled.reshape((b * k,) + pooled.shape[2:]))
        return deltas.reshape(b, k, -1), scores.reshape(b, k, -1)

    def forward(self, features: List[torch.Tensor], proposals: torch.Tensor,
                prop_valid: torch.Tensor, gt_boxes: Optional[torch.Tensor] = None,
                gt_valid: Optional[torch.Tensor] = None, draws: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                training: bool = False, count_sum: CountSum = one_rank):
        """features: per level [B, W, L, H, C]. training: (loss, {loss_cls,
        loss_reg, num_pos}) over RoIs sampled with `draws` [B, R] or draws
        from `generator`, `count_sum` going to rcnn_loss; else {boxes
        (refined), scores (best foreground probability), valid} for every
        proposal."""
        cfg = self.cfg
        if not training:
            deltas, scores = self.scores(self.pool(features, proposals))
            refined = (decode_rotated_deltas(deltas, proposals) if cfg.rotated
                       else decode_aabb_deltas(deltas, proposals))
            probs = torch.softmax(scores, dim=-1)
            return {"boxes": refined, "scores": probs[..., 1:].amax(-1), "valid": prop_valid}
        rois, labels, matched, sel_valid = self.sample(proposals, prop_valid, gt_boxes, gt_valid,
                                                       draws, generator)
        deltas, scores = self.scores(self.pool(features, rois))
        return rcnn_loss(cfg, deltas, scores, rois, labels, matched, sel_valid, count_sum)
