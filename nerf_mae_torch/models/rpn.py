"""Anchor-based 3D region proposal network (counterpart of
nerf_mae_tpu/models/rpn.py; reference: nerf_rpn/model/anchor.py:177-213
RPNHead, model/rpn.py:167-549 RegionProposalNetwork, model/nerf_rpn.py:
21-217 NeRFRegionProposalNetwork).

A conv head over the FPN levels gives per anchor an objectness logit and 6
(AABB) or 8 (midpoint-offset OBB) deltas. Training matches the anchors to
the GT boxes by AABB IoU with the low-quality restore, samples a balanced
set per scene and adds the objectness BCE to the box regression (smooth-L1
or an IoU loss). Prediction decodes the top anchors of each level, clips
them, runs an NMS per level and scene, and keeps the best overall.

    model = NeRFRPN(SWIN_PRESETS["swin_s"], RPNConfig(conv_depth=2))
    model.init_weights(seed=0)
    loss, aux = model(grids, sizes, gt_boxes, gt_valid, deterministic=False,
                      training=True, droppath_generator=g, sample_generator=h)
    props = model(grids, sizes)  # boxes [B, K, 6|7], scores, levels, valid

The head runs in the compute dtype with float32 outputs; the loss and the
post-processing in float32. Batches are channel-last: grids [B, R, R, R,
4], sizes [B, 3], gt_boxes [B, G, 6|7], gt_valid [B, G].
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from nerf_mae_torch.config import SwinConfig
from nerf_mae_torch.models.backbones import init_body, make_body
from nerf_mae_torch.models.unetr import Conv3d
from nerf_mae_torch.ops.anchors import (
    DEFAULT_ANCHOR_SIZES,
    DEFAULT_ASPECT_RATIOS,
    anchor_padding_mask,
    anchor_quality,
    anchors_on,
    balanced_sample,
    grid_anchors,
    match_anchors,
)
from nerf_mae_torch.ops.boxes import clip_boxes_to_grid, unit_box_where
from nerf_mae_torch.ops.coders import (
    decode_aabb_deltas,
    decode_midpoint_offset,
    encode_aabb_deltas,
    encode_midpoint_offset,
)
from nerf_mae_torch.ops.nms import nms_mask, sort_desc, topk_by_score
from nerf_mae_torch.ops.obb import obb2hbb_3d
from nerf_mae_torch.ops.rotated_iou import iou_3d


@dataclasses.dataclass(frozen=True)
class RPNConfig:
    resolution: int = 160
    strides: Sequence[int] = (4, 8, 16, 32)
    anchor_sizes: Sequence[Sequence[float]] = DEFAULT_ANCHOR_SIZES
    aspect_ratios: Sequence[Sequence[float]] = DEFAULT_ASPECT_RATIOS
    normalize_ratios: bool = False
    conv_depth: int = 1
    rotated_bbox: bool = False
    reg_loss_type: str = "smooth_l1"  # smooth_l1 | iou | linear_iou
    fg_iou_thresh: float = 0.35
    bg_iou_thresh: float = 0.2
    batch_size_per_mesh: int = 256
    positive_fraction: float = 0.5
    reg_loss_weight: float = 5.0  # (reference: run_rpn.py:89)
    proj2d_loss_weight: float = 0.0  # (reference: run_rpn.py:91, default 0)
    pre_nms_top_n: int = 2500
    post_nms_top_n: int = 2500
    nms_thresh: float = 0.3
    score_thresh: float = 0.0
    min_size: float = 1e-3
    max_gt: int = 64

    @property
    def delta_dim(self) -> int:
        return 8 if self.rotated_bbox else 6

    @property
    def anchors_per_loc(self) -> int:
        n = sum(len(set(itertools.permutations(r))) for r in self.aspect_ratios)
        return n * len(self.anchor_sizes[0])

    def anchor_key(self):
        """grid_anchors' arguments."""
        return (self.resolution, tuple(self.strides),
                tuple(tuple(s) for s in self.anchor_sizes),
                tuple(tuple(r) for r in self.aspect_ratios), self.normalize_ratios)


class RPNHead3D(nn.Module):
    """Shared conv head over the FPN levels (reference: anchor.py:177-213):
    conv_depth 3^3 convs with ReLU, then 1^3 convs to A logits and A *
    delta_dim deltas per location, float32 out."""

    def __init__(self, anchors_per_loc: int, delta_dim: int, in_channels: int = 256,
                 conv_depth: int = 1, dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.conv_depth, self.dtype = conv_depth, dtype
        for i in range(conv_depth):
            self.add_module(f"conv{i}", Conv3d(in_channels, in_channels, 3, device=device))
        self.cls_logits = Conv3d(in_channels, anchors_per_loc, 1, device=device)
        self.bbox_pred = Conv3d(in_channels, anchors_per_loc * delta_dim, 1, device=device)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """The JAX initializers: kernels normal(0.01), zero biases."""
        for p in self.parameters():
            if p.ndim == 5:
                p.normal_(0.0, 0.01, generator=gen)
            else:
                p.zero_()

    def forward(self, features: List[torch.Tensor]):
        dt = self.dtype
        logits, deltas = [], []
        for f in features:
            t = f
            for i in range(self.conv_depth):
                t = F.relu(getattr(self, f"conv{i}")(t, dt))
            logits.append(self.cls_logits(t, dt).float())
            deltas.append(self.bbox_pred(t, dt).float())
        return logits, deltas


def _flatten_rpn_outputs(logits: List[torch.Tensor], deltas: List[torch.Tensor], delta_dim: int):
    """Per level [B, W, L, H, A * C] -> [B, sum(WLH * A)] objectness and
    [B, sum(WLH * A), C] deltas: location-major, then anchor, as
    grid_anchors orders them (the channel-last layout needs no permute)."""
    b = logits[0].shape[0]
    return (torch.cat([l.reshape(b, -1) for l in logits], dim=1),
            torch.cat([d.reshape(b, -1, delta_dim) for d in deltas], dim=1))


@torch.no_grad()
def rpn_assign_and_encode(cfg: RPNConfig, anchors: torch.Tensor, anchor_valid: torch.Tensor,
                          gt_boxes: torch.Tensor, gt_valid: torch.Tensor):
    """Matching and target encoding, scene by scene (the [G, A] IoU of one
    scene in anchor chunks: at 160^3 and 64 GT boxes a whole batch's would
    take ~17 GB of temporaries). Returns (labels [B, A], reg_targets [B, A,
    delta_dim], matched_boxes [B, A, 6|7])."""
    labels, regs, matched = [], [], []
    for gt, gv, av in zip(gt_boxes.float(), gt_valid.bool(), anchor_valid):
        quality = anchor_quality(obb2hbb_3d(gt) if cfg.rotated_bbox else gt, anchors)
        lab, best_gt = match_anchors(quality, gv, av, cfg.bg_iou_thresh, cfg.fg_iou_thresh)
        del quality
        m = gt[best_gt]
        labels.append(lab)
        regs.append(encode_midpoint_offset(m, anchors) if cfg.rotated_bbox
                    else encode_aabb_deltas(m, anchors))
        matched.append(m)
    return torch.stack(labels), torch.stack(regs), torch.stack(matched)


def rpn_loss(cfg: RPNConfig, objectness: torch.Tensor, pred_deltas: torch.Tensor,
             anchors: torch.Tensor, anchor_valid: torch.Tensor, gt_boxes: torch.Tensor,
             gt_valid: torch.Tensor, draws: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None):
    """Objectness BCE over a balanced sample and box regression on its
    positives (reference: rpn.py:372-456): smooth-L1 (beta 1/9) summed and
    divided by the number sampled, or an IoU loss on the decoded boxes; plus
    the 2D projection loss when proj2d_loss_weight > 0 (the reference
    weights it 0 by default, run_rpn.py:91). The sampler's uniform draws
    [B, A] are `draws` or come from `generator`. Returns (objectness loss,
    regression loss, {num_pos, num_sampled[, loss_reg_2d]})."""
    labels, reg_targets, matched = rpn_assign_and_encode(cfg, anchors, anchor_valid, gt_boxes,
                                                         gt_valid)
    pos_mask, neg_mask = balanced_sample(labels, cfg.batch_size_per_mesh, cfg.positive_fraction,
                                         draws=draws, generator=generator)
    pos = pos_mask.float()
    sampled = (pos_mask | neg_mask).float()
    n_sampled = torch.clamp(sampled.sum(), min=1.0)

    if cfg.reg_loss_type == "smooth_l1":
        d = (pred_deltas - reg_targets).abs()
        beta = 1.0 / 9.0
        sl1 = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta).sum(-1)
        reg_loss = (sl1 * pos).sum() / n_sampled
    elif cfg.rotated_bbox:
        # the rotated IoU of the positives only: at most batch_size *
        # positive_fraction a scene, gathered (positives first, in index
        # order) in place of the B x A boxes the JAX package decodes
        k = min(int(cfg.batch_size_per_mesh * cfg.positive_fraction), pos.shape[1])
        idx = sort_desc(pos)[:, :k]
        pm = torch.gather(pos_mask, 1, idx)
        take = lambda x: torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
        decoded = decode_midpoint_offset(take(pred_deltas), anchors[idx])
        iou, union = iou_3d(unit_box_where(pm, decoded), unit_box_where(pm, take(matched)),
                            return_union=True)
        smooth = (iou * union + 1.0) / (union + 1.0)
        per = (-torch.log(torch.clamp(smooth, min=1e-7)) if cfg.reg_loss_type == "iou"
               else 1.0 - smooth)
        reg_loss = (per * pm.float()).sum() / n_sampled
    else:
        decoded = decode_aabb_deltas(pred_deltas, anchors[None])
        lt = torch.maximum(decoded[..., :3], matched[..., :3])
        rb = torch.minimum(decoded[..., 3:6], matched[..., 3:6])
        whd = torch.clamp(rb - lt, min=0)
        inter = whd[..., 0] * whd[..., 1] * whd[..., 2]
        v1 = torch.clamp(decoded[..., 3:6] - decoded[..., :3], min=0).prod(-1)
        v2 = (matched[..., 3:6] - matched[..., :3]).prod(-1)
        iou = (inter + 1.0) / (v1 + v2 - inter + 1.0)
        per = -torch.log(torch.clamp(iou, min=1e-7)) if cfg.reg_loss_type == "iou" else 1.0 - iou
        reg_loss = (per * pos).sum() / n_sampled

    logp = (torch.clamp(objectness, min=0) - objectness * labels
            + torch.log1p(torch.exp(-objectness.abs())))
    obj_loss = (logp * sampled).sum() / n_sampled

    aux = {"num_pos": pos.sum(), "num_sampled": sampled.sum()}
    if cfg.proj2d_loss_weight > 0:
        from nerf_mae_torch.ops.projection import projection_2d_loss

        decoded2 = (decode_midpoint_offset(pred_deltas, anchors[None]) if cfg.rotated_bbox
                    else decode_aabb_deltas(pred_deltas, anchors[None]))
        loss_2d = projection_2d_loss(unit_box_where(pos_mask, decoded2),
                                     unit_box_where(pos_mask, matched), pos, cfg.resolution)
        loss_2d = loss_2d / torch.clamp(pos.sum(), min=1.0)  # / sampled positives, rpn.py:452
        aux["loss_reg_2d"] = loss_2d
        reg_loss = reg_loss + cfg.proj2d_loss_weight * loss_2d
    return obj_loss, reg_loss, aux


@torch.no_grad()
def rpn_candidates(cfg: RPNConfig, objectness: torch.Tensor, pred_deltas: torch.Tensor,
                   anchors: torch.Tensor, anchor_valid: torch.Tensor,
                   sizes: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
    """Per level: the top min(pre_nms_top_n, A_l) valid anchors by
    objectness (ties to the lower index), decoded (AABBs clipped to the
    scene), filtered by min_size, finiteness and score_thresh. Returns per
    level {boxes [B, k, 6|7], scores [B, k] (sigmoid), valid [B, k]}."""
    scores = torch.where(anchor_valid, objectness, torch.full_like(objectness, float("-inf")))
    per_level = grid_anchors(*cfg.anchor_key())[3]
    out, start = [], 0
    for n in per_level:
        sl = slice(start, start + n)
        start += n
        top_s, top_i, _ = topk_by_score(scores[:, sl], min(cfg.pre_nms_top_n, n))
        top_anchors = anchors[sl][top_i]
        top_deltas = torch.gather(pred_deltas[:, sl], 1,
                                  top_i[..., None].expand(-1, -1, pred_deltas.shape[-1]))
        if cfg.rotated_bbox:
            boxes = decode_midpoint_offset(top_deltas, top_anchors)
            ok = (boxes[..., 3:6] >= cfg.min_size).all(-1)
        else:
            boxes = decode_aabb_deltas(top_deltas, top_anchors)
            boxes = clip_boxes_to_grid(boxes, sizes.to(boxes.dtype)[:, None, :])
            ok = (boxes[..., 3:6] - boxes[..., 0:3] >= cfg.min_size).all(-1)
        prob = torch.sigmoid(top_s)
        ok = ok & torch.isfinite(top_s) & (prob >= cfg.score_thresh)
        out.append({"boxes": boxes, "scores": prob, "valid": ok})
    return out


@torch.no_grad()
def rpn_level_nms(cfg: RPNConfig, cands: List[Dict[str, torch.Tensor]]) -> List[torch.Tensor]:
    """The NMS of each level and scene (the reference's batched_nms keyed
    on the level; JAX's vmap over scenes): per level keep [B, k]. All of
    them run as one batched nms_mask over the levels' candidates padded to
    the largest k with invalid entries, which are visited last and never
    kept, so each set keeps what its own NMS keeps."""
    k = max(c["scores"].shape[1] for c in cands)
    pad = lambda x, v: F.pad(x, (0, 0) * (x.ndim - 2) + (0, k - x.shape[1]), value=v)
    keep = nms_mask(torch.stack([pad(c["boxes"], 0.0) for c in cands]),
                    torch.stack([pad(c["scores"], 0.0) for c in cands]), cfg.nms_thresh,
                    valid=torch.stack([pad(c["valid"], False) for c in cands]))
    return [keep[lvl, :, : c["scores"].shape[1]] for lvl, c in enumerate(cands)]


@torch.no_grad()
def rpn_select(cfg: RPNConfig, cands: List[Dict[str, torch.Tensor]],
               keeps: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The top min(post_nms_top_n, N) kept candidates over all levels by
    score (ties to the lower index). Returns boxes [B, K, 6|7], scores
    [B, K] (0 where invalid), levels [B, K] int32, valid [B, K]."""
    boxes = torch.cat([c["boxes"] for c in cands], 1)
    valid = torch.cat(keeps, 1)
    levels = torch.cat([torch.full(k.shape, lvl, dtype=torch.int32, device=k.device)
                        for lvl, k in enumerate(keeps)], 1)
    prob = torch.cat([torch.where(k, c["scores"], torch.zeros_like(c["scores"]))
                      for c, k in zip(cands, keeps)], 1)
    top_s, top_i, ok = topk_by_score(prob, min(cfg.post_nms_top_n, boxes.shape[1]), valid)
    return {
        "boxes": torch.gather(boxes, 1, top_i[..., None].expand(-1, -1, boxes.shape[-1])),
        "scores": torch.where(ok, top_s, torch.zeros_like(top_s)),
        "levels": torch.gather(levels, 1, top_i),
        "valid": ok,
    }


def rpn_filter_proposals(cfg: RPNConfig, objectness: torch.Tensor, pred_deltas: torch.Tensor,
                         anchors: torch.Tensor, anchor_valid: torch.Tensor,
                         sizes: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Fixed-shape proposal filtering (reference: rpn.py:293-371):
    rpn_candidates, rpn_level_nms, then rpn_select."""
    cands = rpn_candidates(cfg, objectness, pred_deltas, anchors, anchor_valid, sizes)
    return rpn_select(cfg, cands, rpn_level_nms(cfg, cands))


class NeRFRPN(nn.Module):
    """Detection body + RPN head (reference: nerf_rpn.py:21-217). The body
    is "swin_t/s/b/l/nano" (SwinFPN, graftable from a MAE), "resnet",
    "vgg_AF" or "vgg_EF". Parameters are created on `device` (default: the
    CUDA card) uninitialised: load a state dict or call `init_weights`."""

    def __init__(self, swin: SwinConfig, rpn: RPNConfig, backbone: str = "swin_s",
                 out_channels: int = 256, dtype: torch.dtype = torch.bfloat16,
                 remat: bool = True, device="cuda"):
        super().__init__()
        self.rpn = rpn
        self.body = make_body(backbone, swin, out_channels, dtype, remat, device)
        self.head = RPNHead3D(rpn.anchors_per_loc, rpn.delta_dim, out_channels, rpn.conv_depth,
                              dtype=dtype, device=device)

    @torch.no_grad()
    def init_weights(self, seed: int) -> "NeRFRPN":
        """Random weights from `seed`: the body as init_body makes them,
        then the head's (RPNHead3D.init_weights)."""
        self.head.init_weights(init_body(self.body, seed))
        return self

    def anchors(self, sizes: torch.Tensor):
        """(anchors [A, 6], anchor_valid [B, A]) on sizes' device."""
        anchors, centers, _ = anchors_on(sizes.device, *self.rpn.anchor_key())
        return anchors, anchor_padding_mask(centers, sizes)

    def head_outputs(self, features: List[torch.Tensor]):
        """(objectness [B, A], deltas [B, A, delta_dim]), float32."""
        return _flatten_rpn_outputs(*self.head(features), self.rpn.delta_dim)

    def propose(self, features: List[torch.Tensor], sizes: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Proposals from the body's features (rpn_filter_proposals)."""
        anchors, valid = self.anchors(sizes)
        return rpn_filter_proposals(self.rpn, *self.head_outputs(features), anchors, valid, sizes)

    def forward(self, grids: torch.Tensor, sizes: torch.Tensor,
                gt_boxes: Optional[torch.Tensor] = None, gt_valid: Optional[torch.Tensor] = None,
                deterministic: bool = True, training: bool = False,
                droppath_generator: Optional[torch.Generator] = None,
                sample_generator: Optional[torch.Generator] = None,
                sample_draws: Optional[torch.Tensor] = None):
        """training: (objectness + reg_loss_weight * regression loss,
        {loss_objectness, loss_reg, num_pos, num_sampled}), the sampler's
        draws [B, A] from `sample_draws` or `sample_generator`; else the
        proposals (propose). A training forward (deterministic=False) draws
        the stochastic-depth keep factors from `droppath_generator`."""
        feats = self.body(grids, deterministic, droppath_generator)
        if not training:
            return self.propose(feats, sizes)
        anchors, valid = self.anchors(sizes)
        obj_loss, reg_loss, aux = rpn_loss(self.rpn, *self.head_outputs(feats), anchors, valid,
                                           gt_boxes, gt_valid, draws=sample_draws,
                                           generator=sample_generator)
        total = obj_loss + self.rpn.reg_loss_weight * reg_loss
        return total, {"loss_objectness": obj_loss, "loss_reg": reg_loss, **aux}
