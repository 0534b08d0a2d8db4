"""Greedy NMS and top-k with the JAX package's tie rules (counterpart of
nerf_mae_tpu/ops/nms.py).

The JAX package builds the whole [N, N] IoU matrix and runs a fixed-trip
`fori_loop` over score-sorted candidates (nms.py:36-61). Here the
suppress matrix (IoU > threshold, in visiting order, above the diagonal) is
built in row chunks on the device (`suppress_matrix`; for OBBs the rotated
IoU only of the pairs whose extents overlap, the others being exactly 0);
the greedy scan (`greedy_keep`) stays on the device too, as a fixed-point
iteration of matrix-vector products in place of one launch per candidate.
The semantics are the JAX scan's: a candidate is kept iff it is valid and
no kept higher-ranked box j has suppress[j, i].

Sorts are stable and descending, so ties keep the lower index first, as
jax.lax.top_k and the stable jnp.argsort do (torch.topk promises no order
on ties).
"""

from __future__ import annotations

from typing import Optional

import torch

from nerf_mae_torch.ops.boxes import box_iou_aabb
from nerf_mae_torch.ops.fcos_box import obb_footprint_aabb
from nerf_mae_torch.ops.rotated_iou import PAIRS_PER_CHUNK, iou_3d

# AABB pairs of the suppress matrices per chunk: ~60 bytes of temporaries a
# pair, so ~1 GB at a time
AABB_PAIRS_PER_CHUNK = 1 << 24


def sort_desc(scores: torch.Tensor) -> torch.Tensor:
    """Indices of a stable descending sort along the last dim (equal scores
    keep their index order)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices


def extents_overlap(boxes: torch.Tensor, rows: slice) -> torch.Tensor:
    """[rows, N] bool: True where the pair's z-extents overlap and their
    footprint AABBs overlap or lie within 1e-4 x (1 + both extents) of each
    other. Every other pair has a rotated IoU of exactly 0: z-extents that do
    not overlap make iou_3d's z term (the same expression) 0, and footprints
    that far apart leave no corner inside the other box (its test allows
    1e-6 of an edge) and no edge crossing, so the polygon has no area."""
    aabb = obb_footprint_aabb(boxes)
    lo, hi = aabb[:, :3], aabb[:, 3:]
    z_lo, z_hi = boxes[:, 2] - boxes[:, 5] / 2, boxes[:, 2] + boxes[:, 5] / 2
    ok = (torch.minimum(z_hi[rows, None], z_hi[None]) - torch.maximum(z_lo[rows, None], z_lo[None])
          ) > 0
    ext = hi - lo
    for a in range(2):
        gap = torch.minimum(hi[rows, None, a], hi[None, :, a]) - torch.maximum(
            lo[rows, None, a], lo[None, :, a])
        ok &= gap > -1e-4 * (1 + ext[rows, None, a] + ext[None, :, a])
    return ok


@torch.no_grad()
def suppress_matrix(boxes: torch.Tensor, iou_threshold: float,
                    pairs_per_chunk: int = PAIRS_PER_CHUNK) -> torch.Tensor:
    """[..., N, N] bool, True at j < i where IoU(boxes[j], boxes[i]) >
    iou_threshold, False elsewhere: the strict upper triangle, all that the
    greedy scan reads (a box's IoU with itself, where corners lie on edges,
    is not even well defined by the polygon). AABB [..., N, 6] or OBB
    [..., N, 7], on the boxes' device, in row chunks. The AABB matrices of
    all leading indices are made together, AABB_PAIRS_PER_CHUNK pairs a
    chunk (each entry the same elementwise arithmetic); the OBB ones one at
    a time, where the rotated IoU is computed only for the pairs whose
    extents overlap (extents_overlap): the others have IoU 0, not above a
    threshold >= 0."""
    if iou_threshold < 0:
        raise ValueError(f"iou_threshold {iou_threshold} < 0")
    n = boxes.shape[-2]
    if boxes.shape[-1] == 6:
        # a row holds one box's pairs in every matrix
        rows = max(1, AABB_PAIRS_PER_CHUNK // max(boxes[..., 0].numel(), 1))
        col = torch.arange(n, device=boxes.device)
        out = torch.zeros(boxes.shape[:-1] + (n,), dtype=torch.bool, device=boxes.device)
        for s in range(0, n, rows):
            out[..., s: s + rows, :] = (box_iou_aabb(boxes[..., s: s + rows, :], boxes)
                                        > iou_threshold) & (col[None, :] > col[s: s + rows, None])
        return out
    if boxes.ndim > 2:
        return torch.stack([suppress_matrix(b, iou_threshold, pairs_per_chunk)
                            for b in boxes.reshape(-1, n, 7)]).reshape(boxes.shape[:-1] + (n,))
    rows = max(1, pairs_per_chunk // max(n, 1))
    col = torch.arange(n, device=boxes.device)
    upper = lambda s: col[None, :] > col[s: s + rows, None]
    out = torch.zeros((n, n), dtype=torch.bool, device=boxes.device)
    js, is_ = [], []
    for s in range(0, n, rows):
        j, i = torch.nonzero(extents_overlap(boxes, slice(s, s + rows)) & upper(s),
                             as_tuple=True)
        js.append(j + s)
        is_.append(i)
    js, is_ = torch.cat(js), torch.cat(is_)
    for s in range(0, js.shape[0], pairs_per_chunk):
        j, i = js[s: s + pairs_per_chunk], is_[s: s + pairs_per_chunk]
        out[j, i] = iou_3d(boxes[j], boxes[i]) > iou_threshold
    return out


@torch.no_grad()
def greedy_keep(suppress: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The greedy scan over candidates in visiting order: suppress [..., N,
    N] bool (row j = a higher-ranked box; only j < i is read), valid [..., N]
    bool -> keep [..., N] bool, on their device, each leading index its own
    scan. keep[i] = valid[i] and no kept j < i has suppress[j, i] (the JAX
    fori_loop). Computed as a fixed-point iteration, keep <- valid & ~(keep
    @ suppress > 0), a (batched) matrix-vector product per round: an entry
    whose longest chain of earlier suppressors has length t is final after
    t + 1 rounds, and a round that changes nothing ends it. The sums count
    kept suppressors, so any positive sum is exact in fp16 (no term is
    negative)."""
    s = torch.triu(suppress, diagonal=1).to(torch.float16 if suppress.is_cuda
                                            else torch.float32)
    keep = valid
    while True:
        for _ in range(4):  # check for the fixed point every 4 rounds
            hits = torch.matmul(keep.unsqueeze(-2).to(s.dtype), s).squeeze(-2)
            prev, keep = keep, valid & ~(hits > 0)
        if torch.equal(keep, prev):
            return keep


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
             valid: Optional[torch.Tensor] = None,
             max_keep: Optional[int] = None) -> torch.Tensor:
    """Greedy NMS: boxes [..., N, 6] (AABB) or [..., N, 7] (OBB), scores
    [..., N] -> keep [..., N] bool on the boxes' device, each leading index
    its own candidate set, their greedy scans run together. Candidates are
    visited in descending score order (a stable sort of the valid scores,
    invalid ones last); a candidate is kept iff it is valid and no
    already-kept higher-ranked box has IoU > threshold with it; at most
    `max_keep` are kept."""
    n, d = boxes.shape[-2:]
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=boxes.device)
    order = sort_desc(torch.where(valid, scores, torch.full_like(scores, float("-inf"))))
    ordered = torch.gather(boxes, -2, order.unsqueeze(-1).expand(*order.shape, d))
    keep_sorted = greedy_keep(suppress_matrix(ordered, iou_threshold),
                              torch.gather(valid, -1, order))
    if max_keep is not None:
        keep_sorted = keep_sorted & (torch.cumsum(keep_sorted, -1) <= max_keep)
    return torch.zeros_like(valid).scatter(-1, order, keep_sorted)


def topk_by_score(scores: torch.Tensor, k: int, valid: Optional[torch.Tensor] = None):
    """(values, indices, valid_out) of the top-k valid scores along the last
    dim; ties keep the lower index first (jax.lax.top_k)."""
    masked = scores if valid is None else torch.where(
        valid, scores, torch.full_like(scores, float("-inf")))
    idx = sort_desc(masked)[..., :k]
    vals = torch.gather(masked, -1, idx)
    return vals, idx, torch.isfinite(vals)
