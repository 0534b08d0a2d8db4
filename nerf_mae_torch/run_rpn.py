"""Anchor-RPN CLI (counterpart of scripts/run_rpn.py), with its flag names
plus --device; --mode {train,eval,benchmark}. Runs on the CUDA card unless
--device cpu.

    python -m nerf_mae_torch.run_rpn --mode train --dataset synthetic \
        --backbone_type swin_s --resolution 160 --batch_size 8 --lr 3e-4 \
        --weight_decay 1e-3 --steps 100 --mae_checkpoint checkpoints/mae_swin_s

--mae_checkpoint grafts a pretrained MAE's trunk into the Swin-FPN body.
--backbone_type also takes resnet, vgg_AF and vgg_EF. --dataset synthetic
draws blob scenes with their boxes (the validation draw from seed + 10000);
front3d, hypersim and scannet read --features_path and --boxes_path (one
[N, 6|7] .npy per scene), the training set augmented by --flip_prob /
--rotate_prob / --rot_scale_prob. AABB proposals unless --rotated_bbox
(midpoint-offset OBBs). Eval reports recall, AR and AP25/50/75 of the
proposals (eval/detection.py); training keeps the best recall50_top2500
checkpoint at --eval_interval. --mode benchmark times 20 prediction steps
(forward and proposal filtering) after 3 warm-ups and prints one JSON line.
"""

from __future__ import annotations

import argparse
import logging
import time

from nerf_mae_torch.common import (
    ListDataset,
    add_common_flags,
    benchmark_steps,
    prepare_state,
    run,
    scene_datasets,
    setup_logging,
    to_device,
    train_config,
)
from nerf_mae_torch.config import SWIN_PRESETS, MAEConfig
from nerf_mae_torch.data import detection_batch_iterator, synthetic_detection_scenes
from nerf_mae_torch.eval.detection import detection_eval_summary
from nerf_mae_torch.inference import resolve_device
from nerf_mae_torch.models.rpn import RPNConfig
from nerf_mae_torch.train.rpn_trainer import RPNTrainer

log = logging.getLogger("nerf_mae_torch.run_rpn")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train/eval the anchor-based NeRF RPN (PyTorch)")
    add_common_flags(p, other_backbones=("resnet", "vgg_AF", "vgg_EF"))
    p.add_argument("--boxes_path", default=None)
    p.add_argument("--percent_train", default=1.0, type=float)
    p.add_argument("--flip_prob", default=0.0, type=float)
    p.add_argument("--rotate_prob", default=0.0, type=float)
    p.add_argument("--rot_scale_prob", default=0.0, type=float)
    p.add_argument("--synthetic_hard", action="store_true",
                   help="the harder synthetic distribution: clutter, smaller and "
                        "fainter objects, alpha noise")
    p.add_argument("--rotated_bbox", action="store_true")
    p.add_argument("--reg_loss_type", default="smooth_l1",
                   choices=["smooth_l1", "iou", "linear_iou"])
    p.add_argument("--rpn_head_conv_depth", default=2, type=int)
    p.add_argument("--rpn_pre_nms_top_n", default=2500, type=int)
    p.add_argument("--rpn_post_nms_top_n", default=2500, type=int)
    p.add_argument("--rpn_nms_thresh", default=0.3, type=float)
    p.add_argument("--rpn_fg_iou_thresh", default=0.35, type=float)
    p.add_argument("--rpn_bg_iou_thresh", default=0.2, type=float)
    p.add_argument("--rpn_batch_size_per_mesh", default=256, type=int)
    p.add_argument("--rpn_positive_fraction", default=0.5, type=float)
    p.add_argument("--rpn_score_thresh", default=0.0, type=float)
    p.add_argument("--max_gt", default=64, type=int)
    return p.parse_args(argv)


def rpn_config(args) -> RPNConfig:
    return RPNConfig(
        resolution=args.resolution, rotated_bbox=args.rotated_bbox,
        reg_loss_type=args.reg_loss_type, conv_depth=args.rpn_head_conv_depth,
        fg_iou_thresh=args.rpn_fg_iou_thresh, bg_iou_thresh=args.rpn_bg_iou_thresh,
        batch_size_per_mesh=args.rpn_batch_size_per_mesh,
        positive_fraction=args.rpn_positive_fraction, pre_nms_top_n=args.rpn_pre_nms_top_n,
        post_nms_top_n=args.rpn_post_nms_top_n, nms_thresh=args.rpn_nms_thresh,
        score_thresh=args.rpn_score_thresh, max_gt=args.max_gt)


def build_datasets(args):
    if args.dataset != "synthetic":
        augment = dict(flip_prob=args.flip_prob, rotate_prob=args.rotate_prob,
                       rot_scale_prob=args.rot_scale_prob, percent_train=args.percent_train)
        return scene_datasets(args, train_only=augment, boxes_path=args.boxes_path)
    # a disjoint validation draw (seed offset), so eval measures generalization
    n_val = args.n_synthetic_val or max(args.n_synthetic // 4, 4)
    mk = lambda n, seed: ListDataset(synthetic_detection_scenes(
        n, args.resolution, seed, obb=args.rotated_bbox, hard=args.synthetic_hard))
    return mk(args.n_synthetic, args.seed), mk(n_val, args.seed + 10_000)


def batch_iter(ds, args):
    return detection_batch_iterator(ds, args.batch_size, args.resolution, max_gt=args.max_gt,
                                    seed=args.seed, workers=args.workers)


def corpus_iter(ds, args):
    """One pass over every scene, the corpus --device_data uploads."""
    return detection_batch_iterator(ds, args.batch_size, args.resolution, max_gt=args.max_gt,
                                    shuffle=False, loop=False, drop_last=False,
                                    workers=args.workers)


def benchmark(args, trainer, state, batch):
    """benchmark_steps of predict_step on one training batch, with the mean
    number of valid proposals per scene."""
    kind = "obb" if args.rotated_bbox else "aabb"
    return benchmark_steps(
        args, trainer.device, lambda: trainer.predict_step(state, batch),
        f"predict_ms_rpn_{kind}_{args.backbone_type}_{args.resolution}",
        summary=lambda det: {"proposals_per_scene": float(det["valid"].sum()) / args.batch_size})


def main(argv=None):
    """CLI entry. Returns the eval metrics (eval: recall25/50 and AR at
    300 / 1000 / 2500 proposals, AP25/50/75), the benchmark's JSON dict
    (benchmark), or {"steps", "history", "checkpoint_dir"} (train)."""
    args = parse_args(argv)
    setup_logging()
    device = resolve_device(args.device)
    swin = SWIN_PRESETS.get(args.backbone_type, SWIN_PRESETS["swin_s"])
    train_ds, val_ds = build_datasets(args)
    total_steps = args.steps or max(len(train_ds) // args.batch_size, 1) * args.num_epochs
    trainer = RPNTrainer(swin, rpn_config(args), train_config(args), total_steps, device,
                         backbone=args.backbone_type, compute_dtype=args.compute_dtype,
                         remat=not args.no_remat)
    mae_cfg = MAEConfig(swin=swin, resolution=args.resolution, compute_dtype=args.compute_dtype)
    state = prepare_state(args, trainer, mae_cfg)

    def run_eval(state):
        t0 = time.perf_counter()
        props, scores, gts = [], [], []
        for batch in detection_batch_iterator(val_ds, min(args.batch_size, len(val_ds)),
                                              args.resolution, max_gt=args.max_gt,
                                              shuffle=False, loop=False, drop_last=False):
            det = trainer.predict_step(state, to_device(batch, device))
            det = {k: v.cpu().numpy() for k, v in det.items()}
            for i in range(batch["grids"].shape[0]):
                keep = det["valid"][i]
                props.append(det["boxes"][i][keep])
                scores.append(det["scores"][i][keep])
                gts.append(batch["gt_boxes"][i][batch["gt_valid"][i]])
        if not props:
            return {}
        out = detection_eval_summary(props, scores, gts)
        log.info("eval of %d scenes in %.1f ms: %s", len(props),
                 (time.perf_counter() - t0) * 1e3, out)
        return out

    return run(args, trainer, state, batch_iter, train_ds, run_eval, best_key="recall50_top2500",
               log_keys=("loss", "loss_objectness", "loss_reg", "num_pos", "grad_norm"),
               task="rpn", out_resolution=args.resolution, benchmark=benchmark,
               corpus_iter=lambda: corpus_iter(train_ds, args))


if __name__ == "__main__":
    main()
