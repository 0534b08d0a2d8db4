"""RCNN second-stage CLI (counterpart of scripts/run_rpn_detect.py), with
its flag names plus --device; --mode {train,eval}. Runs on the CUDA card
unless --device cpu.

    python -m nerf_mae_torch.run_rpn_detect --mode train --dataset synthetic \
        --backbone_type swin_s --resolution 160 --batch_size 8 --steps 100 \
        --rpn_checkpoint checkpoints/rpn --checkpoint_dir checkpoints/rcnn

A frozen first stage, the RPN of --rpn_checkpoint (a run_rpn checkpoint
dir or the .npz of a JAX one; random weights from --seed without one),
gives the body's features and --proposals_per_scene proposals a scene (per
level before its NMS, and overall after). Its head is built with the number of 3^3 convs the
checkpoint holds, and every other parameter must match. The body runs once
a step, under no_grad, for both the proposals and the RoI features. The
RCNN stage (RoI sampling, aligned pooling, classification and refinement)
trains on them with AdamW + OneCycle + the clip, fed through
common.overlap_batches (--workers, --prefetch, --transfer_dtype; no
--device_data, as in JAX); eval reports recall, AR
and AP25/50/75 of its refined boxes at 300 (eval/detection.py), from
--checkpoint when given (a checkpoint dir of this driver, or a JAX RCNN
state .npz from tools.orbax_to_npz --state, which in train mode resumes
JAX's AdamW state). --roi_path is parsed and unused, as in
scripts/run_rpn_detect.py. Under torchrun it trains data-parallel over the
ranks, --batch_size global (common.build_mesh): each rank runs the frozen
RPN on its scenes and the RCNN's sampling counts are the global batch's.
"""

from __future__ import annotations

import argparse
import logging
import re
import time

import torch

from nerf_mae_torch.common import (
    ListDataset,
    add_common_flags,
    build_mesh,
    eval_shards,
    gather_rows,
    metric_logger,
    overlap_batches,
    profiled_steps,
    refuse_orbax,
    restore_state,
    save_on_main,
    scene_datasets,
    setup_logging,
    train_config,
    write_eval_json,
)
from nerf_mae_torch.config import SWIN_PRESETS, TrainConfig
from nerf_mae_torch.convert import jax_params, read_npz
from nerf_mae_torch.data import detection_batch_iterator, synthetic_detection_scenes
from nerf_mae_torch.eval.detection import detection_eval_summary
from nerf_mae_torch.models.rcnn import RCNNConfig
from nerf_mae_torch.models.rpn import RPNConfig
from nerf_mae_torch.train.checkpoint import restore_checkpoint
from nerf_mae_torch.train.rpn_trainer import RCNNTrainer, RPNTrainer

log = logging.getLogger("nerf_mae_torch.run_rpn_detect")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train/eval the RCNN second stage (PyTorch)")
    add_common_flags(p, other_backbones=("resnet", "vgg_AF", "vgg_EF"))
    p.add_argument("--boxes_path", default=None)
    p.add_argument("--roi_path", default=None,
                   help="unused, as in scripts/run_rpn_detect.py (proposals come from "
                        "--rpn_checkpoint)")
    p.add_argument("--rpn_checkpoint", default=None,
                   help="trained RPN checkpoint (run_rpn) to generate proposals, or the "
                        ".npz of a JAX one (tools.orbax_to_npz)")
    p.add_argument("--rotated_bbox", action="store_true")
    p.add_argument("--rois_per_scene", default=128, type=int)
    p.add_argument("--proposals_per_scene", default=256, type=int)
    p.add_argument("--fg_threshold", default=0.5, type=float)
    p.add_argument("--bg_threshold", default=0.2, type=float)
    p.add_argument("--roi_output_size", default=5, type=int)
    p.add_argument("--max_gt", default=64, type=int)
    args = p.parse_args(argv)
    if args.mode == "benchmark":
        p.error("--mode benchmark: scripts/run_rpn_detect.py has none (train or eval)")
    if args.device_data:
        p.error("--device_data: the RCNN stage streams its batches from the host "
                "(scripts/run_rpn_detect.py feeds through overlap_batches only)")
    return args


def rcnn_config(args) -> RCNNConfig:
    return RCNNConfig(resolution=args.resolution, rois_per_scene=args.rois_per_scene,
                      fg_threshold=args.fg_threshold, bg_threshold=args.bg_threshold,
                      output_size=args.roi_output_size, rotated=args.rotated_bbox)


def frozen_rpn(args, device, mesh=None):
    """The first stage's TrainState, in eval mode: the RPN of
    --rpn_checkpoint (a run_rpn checkpoint dir, or the .npz of a JAX
    run_rpn checkpoint from tools.orbax_to_npz, with or without --state)
    with as many head convs as the checkpoint holds (load_state_dict is
    strict, so any other mismatch raises), or random
    weights from --seed at the JAX driver's depth 1 without one; on a mesh,
    replicated from rank 0."""
    params, jax_tree = {}, None
    if args.rpn_checkpoint and args.rpn_checkpoint.endswith(".npz"):
        jax_tree = jax_params(read_npz(args.rpn_checkpoint))
        depth = sum(1 for k in jax_tree if re.fullmatch(r"head/conv\d+/kernel", k)) or 1
    else:
        if args.rpn_checkpoint:
            refuse_orbax(args.rpn_checkpoint)
            params = restore_checkpoint(args.rpn_checkpoint)["params"]
        depth = sum(1 for k in params if re.fullmatch(r"head\.conv\d+\.weight", k)) or 1
    rpn = RPNConfig(resolution=args.resolution, rotated_bbox=args.rotated_bbox,
                    conv_depth=depth, pre_nms_top_n=args.proposals_per_scene,
                    post_nms_top_n=args.proposals_per_scene, max_gt=args.max_gt)
    trainer = RPNTrainer(SWIN_PRESETS.get(args.backbone_type, SWIN_PRESETS["swin_s"]), rpn,
                         TrainConfig(batch_size=args.batch_size), 10, device,
                         backbone=args.backbone_type, compute_dtype=args.compute_dtype,
                         remat=not args.no_remat, mesh=mesh)
    state = trainer.init(args.seed)
    if jax_tree is not None:
        params = trainer.params_from_jax(jax_tree)
    if params:
        state.model.load_state_dict(params)
        log.info("restored the RPN (head depth %d) from %s", depth, args.rpn_checkpoint)
    state.model.eval()
    return state


def features_and_proposals(rpn_state, batch):
    """The frozen body's features of the batch (computed once) and the
    RPN's proposals from them."""
    with torch.no_grad():
        feats = rpn_state.model.body(batch["grids"])
        return feats, rpn_state.model.propose(feats, batch["sizes"])


def build_datasets(args):
    if args.dataset != "synthetic":
        return scene_datasets(args, boxes_path=args.boxes_path)
    ds = ListDataset(synthetic_detection_scenes(args.n_synthetic, args.resolution, args.seed,
                                                obb=args.rotated_bbox))
    return ds, ds  # as scripts/run_rpn_detect.py: the training scenes


def main(argv=None):
    """CLI entry. Returns the eval metrics (eval: recall25/50 and AR at 300
    proposals, AP25/50/75) or {"steps", "history", "checkpoint_dir"}
    (train)."""
    args = parse_args(argv)
    setup_logging()
    with build_mesh(args, spatial_ok=False) as mesh:
        return _main(args, mesh)


def _main(args, mesh):
    device = mesh.device
    rpn_state = frozen_rpn(args, device, mesh)
    train_ds, val_ds = build_datasets(args)
    total_steps = args.steps or max(len(train_ds) // args.batch_size, 1) * args.num_epochs
    trainer = RCNNTrainer(rcnn_config(args), train_config(args), total_steps, device,
                          mesh=mesh)
    state = trainer.init(args.seed)
    if args.checkpoint:
        state = restore_state(args, trainer, state)

    if args.mode == "eval":
        t0 = time.perf_counter()
        props, scores, gts = [], [], []
        batches = detection_batch_iterator(val_ds, min(args.batch_size, len(val_ds)),
                                           args.resolution, max_gt=args.max_gt,
                                           shuffle=False, loop=False, drop_last=False)
        for batch, rows in eval_shards(batches, mesh):
            feats, det = features_and_proposals(rpn_state, rows)
            out = gather_rows(trainer.predict_step(state, feats, det), mesh)
            for i in range(batch["grids"].shape[0]):
                keep = out["valid"][i]
                props.append(out["boxes"][i][keep])
                scores.append(out["scores"][i][keep])
                gts.append(batch["gt_boxes"][i][batch["gt_valid"][i]])
        agg = detection_eval_summary(props, scores, gts, top_n=(300,)) if props else {}
        log.info("eval of %d scenes in %.1f ms: %s", len(props),
                 (time.perf_counter() - t0) * 1e3, agg)
        write_eval_json(args, mesh, agg)
        return agg

    batches = overlap_batches(
        detection_batch_iterator(train_ds, args.batch_size, args.resolution,
                                 max_gt=args.max_gt, seed=args.seed, workers=args.workers,
                                 rank=mesh.rank, world=mesh.world_size),
        device, args.prefetch, transfer_dtype=args.transfer_dtype)
    mlog = metric_logger(args, mesh, f"rcnn_{args.backbone_type}")
    history = []
    t0 = time.time()
    try:
        for step in profiled_steps(args, device, range(state.step + 1, total_steps + 1),
                                   mesh):
            batch = next(batches)
            feats, det = features_and_proposals(rpn_state, batch)
            state, metrics = trainer.train_step(state, feats, det, batch)
            if step % args.log_interval == 0:
                m = {k: float(v) for k, v in metrics.items()}
                rate = args.log_interval * args.batch_size / (time.time() - t0)
                log.info("step %d/%d loss %.4f (cls %.4f reg %.4f) pos %d %.2f grids/s",
                         step, total_steps, m["loss"], m["loss_cls"], m["loss_reg"],
                         int(m["num_pos"]), rate)
                mlog.log(step, {**m, "grids_per_sec": rate})
                history.append({"step": step, **m, "grids_per_sec": rate})
                t0 = time.time()
            if step % args.ckpt_interval == 0 or step == total_steps:
                save_on_main(mesh, args.checkpoint_dir, step, state)
    finally:
        batches.close()
        mlog.close()
    log.info("done: %d steps", state.step)
    return {"steps": state.step, "history": history, "checkpoint_dir": args.checkpoint_dir}


if __name__ == "__main__":
    main()
