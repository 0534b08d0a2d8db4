"""Detection eval: proposal recall / AR, precision and VOC-style AP (numpy
copy of nerf_mae_tpu/eval/detection.py).

The reference's Detectron-derived greedy matching (reference:
nerf_rpn/eval.py:14-81 recall, :84-226 precision, :319-395 AP): recall
greedily matches the best-covered GT first; AP walks the detections by
descending score, a TP when the best-IoU unused GT exceeds the threshold,
then integrates the VOC precision envelope. Runs on the host; the IoU
matrices are numpy for AABBs and the port's rotated IoU on CPU tensors for
OBBs.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from nerf_mae_torch.ops.rotated_iou import box_iou_obb_pairwise


def _iou_matrix(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """[N, 6|7] x [M, 6|7] -> [N, M] IoU (AABB analytic; OBB through the
    rotated IoU on the CPU)."""
    if boxes1.size == 0 or boxes2.size == 0:
        return np.zeros((boxes1.shape[0], boxes2.shape[0]), np.float32)
    if boxes1.shape[1] == 6:
        lt = np.maximum(boxes1[:, None, :3], boxes2[None, :, :3])
        rb = np.minimum(boxes1[:, None, 3:6], boxes2[None, :, 3:6])
        whd = np.clip(rb - lt, 0, None)
        inter = whd[..., 0] * whd[..., 1] * whd[..., 2]
        v1 = np.prod(boxes1[:, 3:6] - boxes1[:, :3], axis=1)
        v2 = np.prod(boxes2[:, 3:6] - boxes2[:, :3], axis=1)
        union = v1[:, None] + v2[None, :] - inter
        return (inter / np.maximum(union, 1e-9)).astype(np.float32)
    with torch.no_grad():
        return box_iou_obb_pairwise(torch.from_numpy(boxes1.astype(np.float32)),
                                    torch.from_numpy(boxes2.astype(np.float32))).numpy()


def proposal_recall(
    proposals_list: Sequence[np.ndarray],
    scores_list: Sequence[np.ndarray],
    gt_list: Sequence[np.ndarray],
    thresholds: Optional[np.ndarray] = None,
    limit: Optional[int] = None,
) -> Dict:
    """Detectron proposal recall (reference: eval.py:14-81)."""
    gt_overlaps = []
    num_pos = 0
    for proposals, scores, gts in zip(proposals_list, scores_list, gt_list):
        order = np.argsort(-scores)
        proposals = np.asarray(proposals)[order]
        if proposals.shape[0] == 0 or gts.shape[0] == 0:
            continue
        num_pos += gts.shape[0]
        if limit is not None:
            proposals = proposals[:limit]
        overlaps = _iou_matrix(proposals, np.asarray(gts))
        covered = np.zeros(gts.shape[0], np.float32)
        for j in range(min(proposals.shape[0], gts.shape[0])):
            max_over = overlaps.max(axis=0)  # best proposal per gt
            gt_ind = int(max_over.argmax())  # best-covered gt
            box_ind = int(overlaps[:, gt_ind].argmax())
            covered[j] = overlaps[box_ind, gt_ind]
            overlaps[box_ind, :] = -1
            overlaps[:, gt_ind] = -1
        gt_overlaps.append(covered)

    gt_overlaps = (
        np.concatenate(gt_overlaps) if gt_overlaps else np.zeros(0, np.float32)
    )
    if thresholds is None:
        thresholds = np.arange(0.5, 0.95 + 1e-5, 0.05, dtype=np.float32)
    recalls = np.array(
        [(gt_overlaps >= t).sum() / max(num_pos, 1) for t in thresholds],
        np.float32,
    )
    return {
        "ar": float(recalls.mean()),
        "recalls": recalls,
        "thresholds": thresholds,
        "num_pos": num_pos,
    }


def proposal_average_precision(
    proposals_list: Sequence[np.ndarray],
    scores_list: Sequence[np.ndarray],
    gt_list: Sequence[np.ndarray],
    iou_thresh: float = 0.25,
    top_k: Optional[int] = None,
) -> Dict:
    """VOC AP with greedy per-detection GT matching
    (reference: eval.py:319-395)."""
    scene_ids, all_dets, all_scores = [], [], []
    num_gt = 0
    for i, (proposals, scores, gts) in enumerate(
        zip(proposals_list, scores_list, gt_list)
    ):
        proposals = np.asarray(proposals)
        scores = np.asarray(scores)
        if top_k is not None and len(proposals) > top_k:
            ids = np.argsort(-scores)[:top_k]
            proposals, scores = proposals[ids], scores[ids]
        scene_ids.extend([i] * len(proposals))
        all_dets.append(proposals)
        all_scores.append(scores)
        num_gt += np.asarray(gts).shape[0]

    if not all_dets or num_gt == 0:
        return {"ap": 0.0, "num_det": 0}
    scene_ids = np.asarray(scene_ids)
    all_dets = np.concatenate(all_dets, 0)
    all_scores = np.concatenate(all_scores, 0)
    order = np.argsort(-all_scores)
    all_dets, scene_ids = all_dets[order], scene_ids[order]

    # precompute per-scene IoU of its detections vs its GTs
    iou_per_det = np.zeros(len(all_dets), np.float32)
    arg_per_det = np.zeros(len(all_dets), np.int64)
    for s, gts in enumerate(gt_list):
        sel = np.where(scene_ids == s)[0]
        if sel.size == 0 or np.asarray(gts).shape[0] == 0:
            continue
        m = _iou_matrix(all_dets[sel], np.asarray(gts))
        iou_per_det[sel] = m.max(axis=1)
        arg_per_det[sel] = m.argmax(axis=1)

    gt_used = [np.zeros(np.asarray(g).shape[0], bool) for g in gt_list]
    tp = np.zeros(len(all_dets), bool)
    for i in range(len(all_dets)):
        s = scene_ids[i]
        if iou_per_det[i] > iou_thresh and not gt_used[s][arg_per_det[i]]:
            tp[i] = True
            gt_used[s][arg_per_det[i]] = True
    fp = ~tp

    tp_c = np.cumsum(tp)
    fp_c = np.cumsum(fp)
    recalls = tp_c / num_gt
    precisions = tp_c / np.maximum(tp_c + fp_c, 1)

    mrec = np.concatenate([[0.0], recalls, [1.0]])
    mpre = np.concatenate([[0.0], precisions, [0.0]])
    for i in range(len(mpre) - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    ap = float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))
    return {"ap": ap, "num_det": int(len(all_dets))}


def proposal_precision(
    proposals_list: Sequence[np.ndarray],
    scores_list: Sequence[np.ndarray],
    gt_list: Sequence[np.ndarray],
    score_thresh: float = 0.0,
    thresholds: Optional[np.ndarray] = None,
    limit: Optional[int] = None,
) -> Dict:
    """Precision at a confidence threshold, averaged over IoU thresholds
    .5:.05:.95 (reference: eval.py:84-226 evaluate_box_proposals_precision):
    greedily match each proposal to its best-covered unused GT, record
    coverage IoUs, precision(t) = #(coverage >= t) / #detections."""
    box_overlaps = []
    num_det = 0
    for proposals, scores, gts in zip(proposals_list, scores_list, gt_list):
        proposals = np.asarray(proposals)
        scores = np.asarray(scores)
        gts = np.asarray(gts)
        keep = scores >= score_thresh
        proposals, scores = proposals[keep], scores[keep]
        order = np.argsort(-scores)
        proposals = proposals[order]
        if proposals.shape[0] == 0:
            continue
        if limit is not None and len(proposals) > limit:
            proposals = proposals[:limit]
        num_det += proposals.shape[0]
        if gts.shape[0] == 0:
            box_overlaps.append(np.zeros(proposals.shape[0], np.float32))
            continue
        overlaps = _iou_matrix(proposals, gts)
        ov = np.zeros(proposals.shape[0], np.float32)
        for j in range(min(proposals.shape[0], gts.shape[0])):
            max_ov = overlaps.max(axis=1)
            box_ind = int(max_ov.argmax())
            gt_ind = int(overlaps[box_ind].argmax())
            ov[j] = overlaps[box_ind, gt_ind]
            overlaps[box_ind, :] = -1
            overlaps[:, gt_ind] = -1
        box_overlaps.append(ov)

    box_overlaps = (
        np.sort(np.concatenate(box_overlaps))
        if box_overlaps else np.zeros(0, np.float32)
    )
    if thresholds is None:
        thresholds = np.arange(0.5, 0.95 + 1e-5, 0.05, dtype=np.float32)
    precisions = np.array(
        [(box_overlaps >= t).sum() / max(float(num_det), 1.0)
         for t in thresholds],
        np.float32,
    )
    return {
        "ap": float(precisions.mean()),
        "precisions": precisions,
        "thresholds": thresholds,
        "score_thresh": score_thresh,
        "box_overlaps": box_overlaps,
        "num_det": num_det,
    }


def detection_eval_summary(
    proposals_list, scores_list, gt_list, top_n: Sequence[int] = (300, 1000, 2500)
) -> Dict[str, float]:
    """The reference CLI's metric suite: Recall@{.25,.5}, AR, AP@{.25,.5,.75}
    at several proposal limits (reference: run_fcos_pretrained.py:875-960)."""
    out = {}
    for limit in top_n:
        r25 = proposal_recall(
            proposals_list, scores_list, gt_list,
            thresholds=np.array([0.25], np.float32), limit=limit,
        )
        r50 = proposal_recall(
            proposals_list, scores_list, gt_list,
            thresholds=np.array([0.5], np.float32), limit=limit,
        )
        ar = proposal_recall(proposals_list, scores_list, gt_list, limit=limit)
        out[f"recall25_top{limit}"] = float(r25["recalls"][0])
        out[f"recall50_top{limit}"] = float(r50["recalls"][0])
        out[f"ar_top{limit}"] = ar["ar"]
    for t in (0.25, 0.5, 0.75):
        out[f"ap{int(t * 100)}"] = proposal_average_precision(
            proposals_list, scores_list, gt_list, iou_thresh=t
        )["ap"]
    return out
