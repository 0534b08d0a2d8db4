"""Voxel semantic segmentation CLI, 19 (Front3D) or 21 (HM3D) classes
(counterpart of scripts/run_voxel_semantics.py), with its flag names plus
--device; --mode {train,eval,benchmark}. Runs on the CUDA card unless
--device cpu.

    python -m nerf_mae_torch.run_voxel_semantics --mode train \
        --dataset synthetic --backbone_type swin_s --resolution 160 \
        --batch_size 8 --num_classes 19 --steps 100 --mae_checkpoint ckpt/

Weighted masked cross-entropy training (--class_weights: an npy of per-class
weights, e.g. models.heads.calculate_class_weights of the training labels);
eval reports mIoU / mAcc / allAcc from the hard confusion counts.
--dataset synthetic draws blob scenes whose colour band encodes the class;
front3d, hypersim and scannet read --features_path and --sem_feat_path.
--mode benchmark times 20 eval steps after 3 warm-up steps and prints one
JSON line. Under torchrun it trains data-parallel over the ranks,
--batch_size global (common.build_mesh); the eval's confusion counts are
summed over the ranks. --mesh_space S shards every grid
(the targets too) over [world / S, S] (common.build_mesh).
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

import torch

from nerf_mae_torch.common import (
    ListDataset,
    add_common_flags,
    build_mesh,
    eval_shards,
    mae_config,
    prepare_state,
    run,
    scene_datasets,
    setup_logging,
    train_config,
)
from nerf_mae_torch.data import pad_to_cube
from nerf_mae_torch.models.heads import intersection_and_union
from nerf_mae_torch.parallel import all_reduce_sum, batch_rows
from nerf_mae_torch.train.head_trainer import VoxelSemanticsTrainer

log = logging.getLogger("nerf_mae_torch.run_voxel_semantics")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="NeRF voxel semantic segmentation (PyTorch)")
    add_common_flags(p)
    p.add_argument("--sem_feat_path", default=None)
    p.add_argument("--num_classes", default=19, type=int,
                   help="19 for Front3D, 21 for HM3D")
    p.add_argument("--class_weights", default=None,
                   help="npy file of per-class CE weights")
    return p.parse_args(argv)


def batch_iter(ds, args, shuffle=True, loop=True, rank=0, world=1):
    """{"grids": [B, R, R, R, 4] float32, "semantics": [B, R, R, R] int32}
    batches of min(batch_size, len(ds)) scenes, ragged tail dropped;
    world > 1: rank's rows of each."""
    rng = np.random.RandomState(args.seed)
    n = len(ds)
    bs = min(args.batch_size, n)
    own = batch_rows(bs, rank, world)
    r = args.resolution
    while True:
        order = rng.permutation(n) if shuffle else np.arange(n)
        for s in range(0, n - bs + 1, bs):
            sel = order[s: s + bs][own]
            grids = np.zeros((len(sel), r, r, r, 4), np.float32)
            sems = np.zeros((len(sel), r, r, r), np.int32)
            for i, j in enumerate(sel):
                item = ds[int(j)]
                grids[i], _ = pad_to_cube(item["rgbsigma"], r)
                sem = item["semantics"][:r, :r, :r]
                sems[i, : sem.shape[0], : sem.shape[1], : sem.shape[2]] = sem
            yield {"grids": grids, "semantics": sems}
        if not loop:
            return


def synthetic_semantic_scenes(n: int, resolution: int, num_classes: int, seed: int):
    """Blob scenes whose semantic label is learnable from the grid: each
    blob's class sets its colour band (class 0 = empty); the draws of
    scripts/run_voxel_semantics.py, number for number."""
    rs = np.random.RandomState(seed)
    r = resolution
    scenes = []
    for _ in range(n):
        g = np.zeros((r, r, r, 4), np.float32)
        sem = np.zeros((r, r, r), np.int32)
        for _ in range(rs.randint(4, 9)):
            cls = rs.randint(1, num_classes)
            c = rs.randint(4, r - 4, 3)
            e = rs.randint(3, max(r // 5, 4), 3)
            s0, s1 = np.maximum(c - e, 0), np.minimum(c + e, r)
            sl = (slice(s0[0], s1[0]), slice(s0[1], s1[1]), slice(s0[2], s1[2]))
            base = (cls - 1) / max(num_classes - 1, 1)
            g[sl + (slice(0, 3),)] = np.clip(base + rs.randn(3) * 0.05, 0, 1)
            g[sl + (3,)] = rs.uniform(0.5, 1.0)
            sem[sl] = cls
        scenes.append({"rgbsigma": g, "semantics": sem})
    return scenes


def build_datasets(args):
    if args.dataset != "synthetic":
        return scene_datasets(args, sem_feat_path=args.sem_feat_path)
    n_val = args.n_synthetic_val or max(args.n_synthetic // 4, 2)
    mk = lambda n, seed: ListDataset(
        synthetic_semantic_scenes(n, args.resolution, args.num_classes, seed))
    return mk(args.n_synthetic, args.seed), mk(n_val, args.seed + 10_000)


def main(argv=None):
    """CLI entry. Returns the eval metrics (eval: loss, mIoU, mAcc, allAcc),
    the benchmark's JSON dict (benchmark), or {"steps", "history",
    "checkpoint_dir"} (train)."""
    args = parse_args(argv)
    setup_logging()
    with build_mesh(args) as mesh:
        return _main(args, mesh)


def _main(args, mesh):
    mae_cfg = mae_config(args)
    weights = np.load(args.class_weights) if args.class_weights else None
    train_ds, val_ds = build_datasets(args)
    total_steps = args.steps or max(len(train_ds) // args.batch_size, 1) * args.num_epochs
    trainer = VoxelSemanticsTrainer(mae_cfg, train_config(args), total_steps, mesh.device,
                                    num_classes=args.num_classes, class_weights=weights,
                                    mesh=mesh)
    state = prepare_state(args, trainer, mae_cfg)

    def run_eval(state):
        c = args.num_classes
        inter, union, tgt = np.zeros(c), np.zeros(c), np.zeros(c)
        losses = []
        for batch, rows in eval_shards(batch_iter(val_ds, args, shuffle=False, loop=False),
                                       mesh):
            m = trainer.eval_step(state, rows)
            losses.append(float(m["loss"]))
            i, u, t = intersection_and_union(m["pred_labels"].cpu().numpy(),
                                             rows["semantics"].cpu().numpy(), c)
            inter += i
            union += u
            tgt += t
        if not losses:
            return {}
        # the confusion counts of every rank's rows
        inter, union, tgt = (v.cpu().numpy() for v in all_reduce_sum(
            [torch.as_tensor(v, device=mesh.device) for v in (inter, union, tgt)], mesh))
        present = tgt > 0
        iou = np.where(union > 0, inter / np.maximum(union, 1), 0.0)
        acc = np.where(tgt > 0, inter / np.maximum(tgt, 1), 0.0)
        out = {
            "loss": float(np.mean(losses)),
            "mIoU": float(iou[present].mean()) if present.any() else 0.0,
            "mAcc": float(acc[present].mean()) if present.any() else 0.0,
            "allAcc": float(inter.sum() / max(tgt.sum(), 1)),
        }
        log.info("eval: %s", out)
        return out

    # the corpus pass at batch size 1, so that --device_data holds every
    # scene (batch_iter drops ragged tails)
    one = argparse.Namespace(**{**vars(args), "batch_size": 1})
    return run(args, trainer, state, batch_iter, train_ds, run_eval, best_key="mIoU",
               log_keys=("loss", "soft_miou", "grad_norm"), task="voxel_semantics",
               out_resolution=args.resolution,
               corpus_iter=lambda: batch_iter(train_ds, one, shuffle=False, loop=False))


if __name__ == "__main__":
    main()
