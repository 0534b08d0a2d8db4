"""3D anchors, the IoU matcher and the balanced sampler of the anchor RPN
(counterpart of nerf_mae_tpu/ops/anchors.py; reference:
nerf_rpn/model/anchor.py:14-174 AnchorGenerator3D, model/utils.py:35-96
BalancedPositiveNegativeSampler, :98-213 Matcher).

The anchors are a numpy constant per (resolution, strides, sizes, ratios),
made once and kept on each device once. Matching is the torchvision
Matcher over one scene's [G, A] IoU, with the low-quality restore; the
sampler ranks candidates by a uniform draw (a stable argsort, as the JAX
package's), which is passed in or drawn from a torch.Generator.
"""

from __future__ import annotations

import functools
import itertools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from nerf_mae_torch.ops.boxes import box_iou_aabb
from nerf_mae_torch.ops.draws import batch_rand

DEFAULT_ANCHOR_SIZES = ((8.0,), (16.0,), (32.0,), (64.0,))
DEFAULT_ASPECT_RATIOS = ((1, 1, 1), (1, 1, 2), (1, 2, 2), (1, 1, 3), (1, 3, 3))
# anchors per chunk of the [G, A] IoU: its [G, chunk, 3] temporaries stay
# near 100 MB at 64 GT boxes
ANCHORS_PER_CHUNK = 1 << 17


def base_anchors_for_level(sizes: Sequence[float],
                           ratios: Sequence[Tuple[float, float, float]],
                           normalize: bool = False) -> np.ndarray:
    """[A0, 6] zero-centred base anchors; each ratio expands to its unique
    axis permutations (reference: anchor.py:51-82)."""
    perms = []
    for r in ratios:
        uniq = sorted(set(itertools.permutations(r)))
        if normalize:
            w = float(np.prod(r)) ** (1.0 / 3.0)
            uniq = [tuple(x / w for x in p) for p in uniq]
        perms.extend(uniq)
    perms = np.asarray(perms, np.float32)  # [P, 3]
    scales = np.asarray(sizes, np.float32)
    whd = (perms[:, None, :] * scales[None, :, None]).reshape(-1, 3)
    return np.round(np.concatenate([-whd / 2, whd / 2], axis=1))


@functools.lru_cache(maxsize=8)
def grid_anchors(resolution: int, strides: Tuple[int, ...],
                 sizes: Tuple[Tuple[float, ...], ...] = DEFAULT_ANCHOR_SIZES,
                 ratios: Tuple[Tuple[float, float, float], ...] = DEFAULT_ASPECT_RATIOS,
                 normalize: bool = False):
    """Anchors over the padded grid: (anchors [A, 6] float32, centres
    [A, 3], level_id [A] int32, anchors per level), location-major (x, then
    y, then z, as the FPN levels' [W, L, H] layout), then anchor. Centres
    sit at stride * index, with no half-cell offset (reference:
    anchor.py:98-122)."""
    all_anchors, all_centers, level_ids, per_level = [], [], [], []
    for lvl, s in enumerate(strides):
        base = base_anchors_for_level(sizes[lvl], ratios, normalize)
        n = int(np.ceil(resolution / s))
        ax = np.arange(n, dtype=np.float32) * s
        gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
        shifts = np.stack([gx.ravel(), gy.ravel(), gz.ravel()] * 2, axis=1)  # [L, 6]
        a = (shifts[:, None, :] + base[None, :, :]).reshape(-1, 6)
        all_anchors.append(a)
        all_centers.append(np.repeat(shifts[:, :3], base.shape[0], axis=0))
        level_ids.append(np.full((a.shape[0],), lvl, np.int32))
        per_level.append(a.shape[0])
    return (np.concatenate(all_anchors).astype(np.float32),
            np.concatenate(all_centers).astype(np.float32),
            np.concatenate(level_ids), per_level)


@functools.lru_cache(maxsize=16)
def anchors_on(device: torch.device, resolution: int, strides: Tuple[int, ...],
               sizes: Tuple[Tuple[float, ...], ...], ratios: Tuple[Tuple[float, ...], ...],
               normalize: bool = False):
    """grid_anchors' anchors [A, 6], centres [A, 3] and level ids [A] as
    tensors on `device`, made once (a copy from host memory in the step
    would wait for the card)."""
    anchors, centers, levels, _ = grid_anchors(resolution, strides, sizes, ratios, normalize)
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(x).to(device) for x in (anchors, centers, levels))


def anchor_padding_mask(centers: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """[A, 3] anchor cell centres + [B, 3] scene extents -> [B, A]
    validity: the cell at index i (coordinate i * stride) is valid iff
    i < ceil(size / stride), i.e. i * stride < size (reference:
    anchor.py:124-152)."""
    return (centers[None] < sizes[:, None, :]).all(-1)


def anchor_quality(gt_aabb: torch.Tensor, anchors: torch.Tensor,
                   chunk: int = ANCHORS_PER_CHUNK) -> torch.Tensor:
    """box_iou_aabb(gt [G, 6], anchors [A, 6]) -> [G, A], computed in
    chunks of anchors: each entry is the same elementwise arithmetic as the
    whole product, so the result is bitwise the same."""
    out = torch.empty((gt_aabb.shape[0], anchors.shape[0]), dtype=torch.float32,
                      device=anchors.device)
    for s in range(0, anchors.shape[0], chunk):
        out[:, s: s + chunk] = box_iou_aabb(gt_aabb, anchors[s: s + chunk])
    return out


def match_anchors(quality: torch.Tensor, gt_valid: torch.Tensor, anchor_valid: torch.Tensor,
                  low_thresh: float, high_thresh: float, allow_low_quality: bool = True):
    """The torchvision Matcher (reference: model/utils.py:98-213, its use in
    rpn.py:240-290) over quality [G, A] (rows of invalid GT arbitrary).
    Returns (labels [A] float in {1, 0, -1}, matched_gt [A] int64: the
    first best GT). The restore compares each IoU with its own row's
    maximum within one tensor, so equality is exact."""
    q = torch.where(gt_valid[:, None], quality, torch.full_like(quality, float("-inf")))
    q = torch.where(anchor_valid[None, :], q, torch.full_like(q, -1.0))
    best_val = q.amax(0)
    best_gt = torch.argmax(q, dim=0)
    one, zero, ignore = (torch.full_like(best_val, v) for v in (1.0, 0.0, -1.0))
    labels = torch.where(best_val >= high_thresh, one,
                         torch.where(best_val < low_thresh, zero, ignore))
    if allow_low_quality:
        gt_best = q.amax(1, keepdim=True)  # [G, 1]
        restore = ((q == gt_best) & gt_valid[:, None] & (gt_best > 0)).any(0)
        labels = torch.where(restore, one, labels)
    return torch.where(anchor_valid, labels, ignore), best_gt


def rank_by_draw(mask: torch.Tensor, draws: torch.Tensor) -> torch.Tensor:
    """Each entry's rank along the last dim among `mask`'s entries ordered
    by draw, ties to the lower index (a stable argsort, as the JAX
    package's); the other entries rank after them."""
    order = torch.argsort(torch.where(mask, draws, torch.full_like(draws, float("inf"))),
                          dim=-1, stable=True)
    ar = torch.arange(order.shape[-1], device=order.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, ar)


def balanced_sample(labels: torch.Tensor, batch_size: int, positive_fraction: float,
                    draws: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None):
    """Balanced positive / negative selection (reference: model/utils.py:
    35-96) over labels [..., A] in {1, 0, -1}: the min(#pos, batch_size *
    positive_fraction) positives and the min(#neg, batch_size - that)
    negatives with the lowest uniform draw (ties to the lower index).
    `draws` [..., A] in [0, 1), else drawn from `generator`. Returns
    (pos_mask, neg_mask) [..., A]."""
    if draws is None:
        draws = batch_rand(generator, labels.shape)
    pos, neg = labels == 1.0, labels == 0.0
    num_pos = torch.clamp(pos.sum(-1, keepdim=True), max=int(batch_size * positive_fraction))
    num_neg = torch.minimum(neg.sum(-1, keepdim=True), batch_size - num_pos)

    return pos & (rank_by_draw(pos, draws) < num_pos), neg & (rank_by_draw(neg, draws) < num_neg)
