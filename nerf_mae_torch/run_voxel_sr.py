"""Voxel super-resolution CLI, R^3 -> out_resolution^3 (counterpart of
scripts/run_voxel_sr.py), with its flag names plus --device; --mode
{train,eval,benchmark}. Runs on the CUDA card unless --device cpu.

    python -m nerf_mae_torch.run_voxel_sr --mode train --dataset synthetic \
        --backbone_type swin_s --resolution 160 --out_resolution 256 \
        --batch_size 8 --steps 100 --mae_checkpoint checkpoints/mae

--dataset synthetic draws blob scenes at the output resolution and takes the
input as their strided subsample; front3d, hypersim and scannet read
--features_path (inputs) and --out_feat_path (high-resolution targets).
--mae_checkpoint grafts a pretrained MAE's trunk and decoder4/3/2 (the
"_Pretrained_Skip" variant). --mode benchmark times 20 eval steps on one
training batch after 3 warm-up steps and prints one JSON line.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

from nerf_mae_torch.common import (
    ListDataset,
    add_common_flags,
    mae_config,
    prepare_state,
    run,
    scene_datasets,
    setup_logging,
    to_device,
    train_config,
)
from nerf_mae_torch.data import pad_to_cube, synthetic_scenes
from nerf_mae_torch.inference import resolve_device
from nerf_mae_torch.train.head_trainer import VoxelSRTrainer

log = logging.getLogger("nerf_mae_torch.run_voxel_sr")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="NeRF voxel super-resolution (PyTorch)")
    add_common_flags(p)
    p.add_argument("--out_feat_path", default=None)
    p.add_argument("--out_resolution", default=256, type=int,
                   help="output grid edge (the reference uses 256 or 384 from a "
                        "160^3 input)")
    return p.parse_args(argv)


def batch_iter(ds, args, shuffle=True, loop=True):
    """{"grids": [B, R, R, R, 4], "out_grids": [B, R_out, R_out, R_out, 4]}
    float32 batches of min(batch_size, len(ds)) scenes, ragged tail dropped."""
    rng = np.random.RandomState(args.seed)
    n = len(ds)
    bs = min(args.batch_size, n)
    r, ro = args.resolution, args.out_resolution
    while True:
        order = rng.permutation(n) if shuffle else np.arange(n)
        for s in range(0, n - bs + 1, bs):
            grids = np.zeros((bs, r, r, r, 4), np.float32)
            outs = np.zeros((bs, ro, ro, ro, 4), np.float32)
            for i, j in enumerate(order[s: s + bs]):
                item = ds[int(j)]
                grids[i], _ = pad_to_cube(item["rgbsigma"], r)
                outs[i], _ = pad_to_cube(item["out_rgbsigma"], ro)
            yield {"grids": grids, "out_grids": outs}
        if not loop:
            return


def build_datasets(args):
    if args.dataset != "synthetic":
        return scene_datasets(args, out_feat_path=args.out_feat_path)

    def mk(n, seed):
        # structured blob scenes at full output resolution; the low-res input
        # is a strided subsample (learnable SR, unlike iid noise)
        his = synthetic_scenes(n, args.out_resolution, seed, min_size=args.out_resolution)
        idx = (np.arange(args.resolution) * (args.out_resolution / args.resolution)).astype(int)
        return ListDataset([{"rgbsigma": hi[idx][:, idx][:, :, idx], "out_rgbsigma": hi}
                            for hi in his])

    n_val = args.n_synthetic_val or max(args.n_synthetic // 4, 2)
    return mk(args.n_synthetic, args.seed), mk(n_val, args.seed + 10_000)


def main(argv=None):
    """CLI entry. Returns the eval metrics (eval), the benchmark's JSON dict
    (benchmark), or {"steps", "history", "checkpoint_dir"} (train)."""
    args = parse_args(argv)
    setup_logging()
    device = resolve_device(args.device)
    mae_cfg = mae_config(args)
    train_ds, val_ds = build_datasets(args)
    total_steps = args.steps or max(len(train_ds) // args.batch_size, 1) * args.num_epochs
    trainer = VoxelSRTrainer(mae_cfg, train_config(args), total_steps, device,
                             out_resolution=args.out_resolution)
    state = prepare_state(args, trainer, mae_cfg)

    def run_eval(state):
        ms = [{k: float(v) for k, v in trainer.eval_step(state, to_device(b, device)).items()}
              for b in batch_iter(val_ds, args, shuffle=False, loop=False)]
        out = {k: float(np.mean([m[k] for m in ms])) for k in ms[0]} if ms else {}
        log.info("eval: %s", out)
        return out

    # the corpus pass at batch size 1, so that --device_data holds every
    # scene (batch_iter drops ragged tails)
    one = argparse.Namespace(**{**vars(args), "batch_size": 1})
    return run(args, trainer, state, batch_iter, train_ds, run_eval, best_key="psnr",
               log_keys=("loss", "psnr", "grad_norm"), task="voxel_sr",
               out_resolution=args.out_resolution,
               corpus_iter=lambda: batch_iter(train_ds, one, shuffle=False, loop=False))


if __name__ == "__main__":
    main()
