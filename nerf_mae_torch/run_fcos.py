"""FCOS 3D object detection CLI (counterpart of scripts/run_fcos.py), with
its flag names plus --device; --mode {train,eval,benchmark}. Runs on the
CUDA card unless --device cpu.

    python -m nerf_mae_torch.run_fcos --mode train --dataset synthetic \
        --backbone_type swin_s --resolution 160 --batch_size 8 --rotated_bbox \
        --iou_loss_type iou --center_sampling_radius 1.5 --steps 100 \
        --mae_checkpoint checkpoints/mae_swin_s

--mae_checkpoint grafts a pretrained MAE's trunk into the Swin-FPN body (the
"_pretrained" variant); without it the detector trains from scratch.
--backbone_type also takes resnet, vgg_AF and vgg_EF. --dataset synthetic
draws blob scenes with their boxes (the validation draw from seed + 10000);
front3d, hypersim and scannet read --features_path and --boxes_path (one
[N, 6|7] .npy per scene), the training set augmented by --flip_prob /
--rotate_prob / --rot_scale_prob. Eval reports recall, AR and AP25/50/75
(eval/detection.py); training keeps the best-AP50 checkpoint at
--eval_interval. --mode benchmark times 20 prediction steps (forward and
post-processing) after 3 warm-ups and prints one JSON line. --out_channels
is parsed and unused, as in scripts/run_fcos.py: the detector is 256 wide.
Under torchrun it trains data-parallel over the ranks, --batch_size global
(common.build_mesh; --mesh_space is refused, as JAX's detection refuses
it); the eval gathers every rank's detections before AP and recall, and
rank 0 writes --output_proposals / --output_voxel_scores.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np

from nerf_mae_torch.common import (
    ListDataset,
    add_common_flags,
    benchmark_steps,
    build_mesh,
    eval_shards,
    gather_rows,
    prepare_state,
    run,
    scene_datasets,
    setup_logging,
    train_config,
)
from nerf_mae_torch.config import SWIN_PRESETS, MAEConfig
from nerf_mae_torch.data import detection_batch_iterator, synthetic_detection_scenes
from nerf_mae_torch.eval.detection import detection_eval_summary
from nerf_mae_torch.models.fcos import FCOSConfig
from nerf_mae_torch.parallel import is_main
from nerf_mae_torch.train.det_trainer import DetectionTrainer

log = logging.getLogger("nerf_mae_torch.run_fcos")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train/eval 3D FCOS over NeRF grids (PyTorch)")
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
    p.add_argument("--num_convs", default=4, type=int)
    p.add_argument("--iou_loss_type", default="iou",
                   choices=["iou", "linear_iou", "giou", "diou", "smooth_l1"])
    p.add_argument("--center_sampling_radius", default=1.5, type=float)
    p.add_argument("--use_additional_l1_loss", action="store_true")
    p.add_argument("--pre_nms_top_n", default=2500, type=int)
    p.add_argument("--fpn_post_nms_top_n", default=2500, type=int)
    p.add_argument("--nms_thresh", default=0.3, type=float)
    p.add_argument("--pre_nms_thresh", default=0.0, type=float)
    p.add_argument("--min_size", default=0.0, type=float)
    p.add_argument("--max_gt", default=64, type=int)
    p.add_argument("--out_channels", default=256, type=int,
                   help="unused, as in scripts/run_fcos.py (the detector is 256 wide)")
    p.add_argument("--output_proposals", default=None,
                   help="eval mode: write per-scene npz (boxes, scores, gt_boxes, "
                        "grid, size) here")
    p.add_argument("--output_voxel_scores", default=None,
                   help="eval mode: write per-voxel objectness npz dumps here")
    return p.parse_args(argv)


def fcos_config(args) -> FCOSConfig:
    return FCOSConfig(
        resolution=args.resolution, use_obb=args.rotated_bbox, num_convs=args.num_convs,
        iou_loss_type=args.iou_loss_type, center_sampling_radius=args.center_sampling_radius,
        use_additional_l1_loss=args.use_additional_l1_loss,
        pre_nms_thresh=args.pre_nms_thresh, pre_nms_top_n=args.pre_nms_top_n,
        nms_thresh=args.nms_thresh, post_nms_top_n=args.fpn_post_nms_top_n,
        min_size=args.min_size, max_gt=args.max_gt)


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


def batch_iter(ds, args, rank=0, world=1):
    return detection_batch_iterator(ds, args.batch_size, args.resolution, max_gt=args.max_gt,
                                    seed=args.seed, workers=args.workers, rank=rank,
                                    world=world)


def corpus_iter(ds, args):
    """One pass over every scene, the corpus --device_data uploads."""
    return detection_batch_iterator(ds, args.batch_size, args.resolution, max_gt=args.max_gt,
                                    shuffle=False, loop=False, drop_last=False,
                                    workers=args.workers)


def benchmark(args, trainer, state, batch):
    """benchmark_steps of predict_step on one training batch, with the mean
    number of valid detections per scene."""
    kind = "obb" if args.rotated_bbox else "aabb"
    return benchmark_steps(
        args, trainer.device, lambda: trainer.predict_step(state, batch),
        f"predict_ms_fcos_{kind}_{args.backbone_type}_{args.resolution}",
        summary=lambda det: {"detections_per_scene": float(det["valid"].sum())
                             / det["valid"].shape[0]},
        mesh=trainer.mesh)


def main(argv=None):
    """CLI entry. Returns the eval metrics (eval: recall25/50 and AR at
    300 / 1000 / 2500 proposals, AP25/50/75), the benchmark's JSON dict
    (benchmark), or {"steps", "history", "checkpoint_dir"} (train)."""
    args = parse_args(argv)
    setup_logging()
    with build_mesh(args, spatial_ok=False) as mesh:
        return _main(args, mesh)


def _main(args, mesh):
    swin = SWIN_PRESETS.get(args.backbone_type, SWIN_PRESETS["swin_s"])
    fcos = fcos_config(args)
    train_ds, val_ds = build_datasets(args)
    total_steps = args.steps or max(len(train_ds) // args.batch_size, 1) * args.num_epochs
    trainer = DetectionTrainer(swin, fcos, train_config(args), total_steps, mesh.device,
                               backbone=args.backbone_type, compute_dtype=args.compute_dtype,
                               remat=not args.no_remat,
                               output_objectness=args.output_voxel_scores is not None,
                               mesh=mesh)
    mae_cfg = MAEConfig(swin=swin, resolution=args.resolution, compute_dtype=args.compute_dtype)
    state = prepare_state(args, trainer, mae_cfg)
    write = is_main(mesh)

    def run_eval(state):
        t0 = time.perf_counter()
        props, scores, gts = [], [], []
        batches = detection_batch_iterator(val_ds, min(args.batch_size, len(val_ds)),
                                           args.resolution, max_gt=args.max_gt,
                                           shuffle=False, loop=False, drop_last=False)
        for batch, rows in eval_shards(batches, mesh):
            det = gather_rows(trainer.predict_step(state, rows), mesh)
            for i in range(batch["grids"].shape[0]):
                if args.output_voxel_scores and write:
                    os.makedirs(args.output_voxel_scores, exist_ok=True)
                    dump = {}
                    for lvl, s in enumerate(fcos.strides):
                        lim = np.ceil(batch["sizes"][i] / s).astype(int)
                        ob = det[f"objectness_level{lvl}"][i]
                        dump[str(lvl)] = ob[: lim[0], : lim[1], : lim[2]]
                    np.savez_compressed(os.path.join(args.output_voxel_scores,
                                                     f"scene_{len(props)}.npz"), **dump)
                keep = det["valid"][i]
                boxes = det["boxes"][i][keep]
                if not args.rotated_bbox:  # report AABBs
                    boxes = np.concatenate([boxes[:, :3] - boxes[:, 3:6] / 2,
                                            boxes[:, :3] + boxes[:, 3:6] / 2], axis=1)
                props.append(boxes)
                scores.append(det["scores"][i][keep])
                gts.append(batch["gt_boxes"][i][batch["gt_valid"][i]])
                if args.output_proposals and write:
                    os.makedirs(args.output_proposals, exist_ok=True)
                    np.savez_compressed(
                        os.path.join(args.output_proposals, f"scene_{len(props) - 1}.npz"),
                        boxes=props[-1], scores=scores[-1], gt_boxes=gts[-1],
                        grid=batch["grids"][i], size=batch["sizes"][i])
        if not props:
            return {}
        out = detection_eval_summary(props, scores, gts)
        log.info("eval of %d scenes in %.1f ms: %s", len(props),
                 (time.perf_counter() - t0) * 1e3, out)
        return out

    return run(args, trainer, state, batch_iter, train_ds, run_eval, best_key="ap50",
               log_keys=("loss", "loss_cls", "loss_reg", "loss_centerness", "num_pos",
                         "grad_norm"),
               task="fcos", out_resolution=args.resolution, benchmark=benchmark,
               corpus_iter=lambda: corpus_iter(train_ds, args))


if __name__ == "__main__":
    main()
