"""MAE pretraining driver (counterpart of scripts/run_mae_pretrain.py), with
the same flag names where the port has the feature; --mode
{train,eval,benchmark}. Runs on the CUDA card unless --device cpu.

    python -m nerf_mae_torch.run_mae_pretrain --mode train --dataset synthetic \
        --backbone_type swin_b --resolution 160 --batch_size 8 --steps 100

--dataset synthetic draws scenes from a seed (--synthetic_hard: the grids of
the hard detection scenes, so that the e2e recipe pretrains on what FCOS
finetunes on); front3d, hypersim and scannet read a features directory of
rgbsigma npz files (--features_path, split by --dataset_split, the training
set augmented by --flip_prob / --rotate_prob and cut by --percent_train).

The feed (common.make_train_batches): --workers threads assemble each batch
with the native collate (patch-major by default), a prefetch thread keeps
--prefetch batches ready and copies each to the card from a ring of reused
pinned buffers on a copy stream while the card runs the previous step, and
--transfer_dtype casts the grids on the host (which also quantises the
reconstruction targets, as in JAX). --device_data uploads the corpus once
and serves batches as device gathers, in the same order. --mode benchmark
times 20 synchronized train steps after one warm-up step on one batch
(under torch.profiler with --profile_dir) and prints one JSON line
(metric, grids/s, step_ms, MFU against the H100's dense bf16 peak, peak
memory, device); a batch that fails to run (out of memory, say) is not
retried at a smaller size. --log_dir writes the metrics as jsonl (and
--wandb forwards them where wandb can be imported).

Data parallelism: under torchrun the step runs on the process group's ranks
(NCCL on cards, one a rank), --batch_size being the global batch:

    torchrun --nproc_per_node 8 -m nerf_mae_torch.run_mae_pretrain \
        --dataset synthetic --backbone_type swin_b --batch_size 64 --steps 100

Each rank loads its rows of every batch, the step gives what one process
gives on the whole batch (trainer.py), and rank 0 alone writes checkpoints,
the metric log, --eval_json, the trace and the benchmark's line (with the
world size, the data and space axes, the per-rank batch and the global
grids/s). --mesh_space S shards the grid too, over [world / S, S]:

    torchrun --nproc_per_node 4 -m nerf_mae_torch.run_mae_pretrain \
        --dataset synthetic --backbone_type swin_b --batch_size 2 --mesh_space 2

each rank of a data row computing on its slab of axis 1 (parallel/spatial.py;
the plain attention, as JAX runs XLA's there), --mode benchmark included.
"""

from __future__ import annotations

import argparse
import json
import logging
import re
import time

import numpy as np
import torch

from nerf_mae_torch.common import (
    ListDataset,
    add_feed_flags,
    add_mesh_flags,
    build_mesh,
    eval_shards,
    make_train_batches,
    maybe_profile,
    mesh_fields,
    metric_logger,
    profile_dir,
    profiled_steps,
    restore_state,
    save_on_main,
    scene_datasets,
    write_eval_json,
)
from nerf_mae_torch.config import SWIN_PRESETS, MAEConfig, TrainConfig
from nerf_mae_torch.data import (
    mae_batch_iterator,
    synthetic_detection_scenes,
    synthetic_scenes,
)
from nerf_mae_torch.flops import train_mfu
from nerf_mae_torch.parallel import is_main
from nerf_mae_torch.train.trainer import MAETrainer

log = logging.getLogger("nerf_mae_torch.run_mae_pretrain")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train/eval NeRF-MAE (PyTorch)")
    p.add_argument("--mode", default="train", choices=["train", "eval", "benchmark"])
    p.add_argument("--dataset", default="front3d",
                   choices=["front3d", "hypersim", "scannet", "synthetic"])
    p.add_argument("--features_path", default=None)
    p.add_argument("--dataset_split", default=None)
    p.add_argument("--backbone_type", default="swin_s", choices=list(SWIN_PRESETS))
    p.add_argument("--resolution", default=160, type=int)
    p.add_argument("--masking_prob", default=0.75, type=float)
    p.add_argument("--masking_strategy", default="random", choices=["random", "grid"])
    p.add_argument("--batch_size", default=32, type=int)
    p.add_argument("--num_epochs", default=2000, type=int)
    p.add_argument("--steps", default=None, type=int,
                   help="total train steps (overrides num_epochs)")
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--weight_decay", default=1e-3, type=float)
    p.add_argument("--clip_grad_norm", default=0.1, type=float)
    p.add_argument("--compute_dtype", default="bfloat16")
    p.add_argument("--no_remat", action="store_true")
    p.add_argument("--flip_prob", default=0.0, type=float)
    p.add_argument("--rotate_prob", default=0.0, type=float)
    p.add_argument("--percent_train", default=1.0, type=float)
    p.add_argument("--checkpoint_dir", default="checkpoints/mae")
    p.add_argument("--checkpoint", default=None,
                   help="resume or evaluate: a checkpoint dir of this driver, or a JAX "
                        "state .npz (tools.orbax_to_npz --state)")
    p.add_argument("--log_interval", default=10, type=int)
    p.add_argument("--eval_interval", default=200, type=int,
                   help="steps between eval passes")
    p.add_argument("--ckpt_interval", default=500, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--n_synthetic", default=16, type=int)
    p.add_argument("--n_synthetic_val", default=0, type=int,
                   help="held-out synthetic eval scenes (0: n_synthetic/4)")
    p.add_argument("--eval_json", default=None, help="dump eval metrics to json")
    p.add_argument("--patch_major_input", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="the host patchifies batches so the patch embed runs "
                        "as one dense matmul; --no-patch_major_input feeds the "
                        "voxel grid to the convolution path")
    p.add_argument("--synthetic_hard", action="store_true",
                   help="the harder synthetic distribution (matches run_fcos "
                        "--synthetic_hard for e2e pretrain->finetune)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    add_feed_flags(p)
    add_mesh_flags(p)
    return p.parse_args(argv)


def build_datasets(args):
    """(train, val): synthetic scenes, the val draw disjoint (seed offset) so
    eval PSNR measures generalization; or the scenes on disk, the training
    set augmented and cut by --percent_train."""
    if args.dataset != "synthetic":
        return scene_datasets(args, train_only=dict(
            flip_prob=args.flip_prob, rotate_prob=args.rotate_prob,
            percent_train=args.percent_train))
    if args.synthetic_hard:
        # the hard distribution the detector finetunes on (grids only)
        draw = lambda n, seed: [s["rgbsigma"] for s in synthetic_detection_scenes(
            n, args.resolution, seed, hard=True)]
    else:
        draw = lambda n, seed: synthetic_scenes(n, args.resolution, seed)
    n_val = args.n_synthetic_val or max(args.n_synthetic // 4, 2)
    mk = lambda n, seed: ListDataset([{"rgbsigma": g} for g in draw(n, seed)])
    return mk(args.n_synthetic, args.seed), mk(n_val, args.seed + 10_000)


def device_slug(device: torch.device) -> str:
    """'h100' for an NVIDIA H100, 'cpu' on the CPU: the metric name's device."""
    if device.type != "cuda":
        return "cpu"
    name = torch.cuda.get_device_name(device).lower()
    m = re.search(r"\b([a-z]\d{2,4})\b", name)
    return m.group(1) if m else re.sub(r"[^a-z0-9]+", "_", name).strip("_")


def main(argv=None):
    """CLI entry. Returns the eval metrics (eval), the JSON line's dict
    (benchmark), or {"steps", "history", "checkpoint_dir"} (train)."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    with build_mesh(args) as mesh:
        return _main(args, mesh)


def _main(args, mesh):
    device = mesh.device
    mae_cfg = MAEConfig(
        swin=SWIN_PRESETS[args.backbone_type],
        resolution=args.resolution,
        masking_prob=args.masking_prob,
        masking_strategy=args.masking_strategy,
        compute_dtype=args.compute_dtype,
        remat=not args.no_remat,
    )
    train_ds, val_ds = build_datasets(args)
    steps_per_epoch = max(len(train_ds) // args.batch_size, 1)
    total_steps = args.steps or steps_per_epoch * args.num_epochs
    train_cfg = TrainConfig(
        batch_size=args.batch_size, num_epochs=args.num_epochs, lr=args.lr,
        weight_decay=args.weight_decay, clip_grad_norm=args.clip_grad_norm,
        seed=args.seed,
    )
    log.info("device: %s", torch.cuda.get_device_name(device)
             if device.type == "cuda" else "cpu")
    trainer = MAETrainer(mae_cfg, train_cfg, total_steps, device, mesh)
    state = trainer.init(args.seed)
    if args.checkpoint:
        state = restore_state(args, trainer, state)

    pm = mae_cfg.swin.patch_size[0] if args.patch_major_input else 0

    def run_eval(state):
        it = mae_batch_iterator(val_ds, min(args.batch_size, len(val_ds)),
                                args.resolution, shuffle=False, loop=False,
                                drop_last=False, patch_major=pm)
        ms = [{k: float(v) for k, v in trainer.eval_step(state, b).items()}
              for _, b in eval_shards(it, mesh)]
        agg = {k: float(np.mean([m[k] for m in ms])) for k in ms[0]} if ms else {}
        log.info("eval: %s", agg)
        return agg

    if args.mode == "eval":
        agg = run_eval(state)
        write_eval_json(args, mesh, agg)
        return agg

    batches = make_train_batches(
        args, device,
        lambda: mae_batch_iterator(train_ds, args.batch_size, args.resolution, seed=args.seed,
                                   workers=args.workers, patch_major=pm,
                                   rank=mesh.data_rank, world=mesh.data_world),
        corpus_iter_factory=lambda: mae_batch_iterator(
            train_ds, args.batch_size, args.resolution, shuffle=False, loop=False,
            drop_last=False, workers=args.workers, patch_major=pm), mesh=mesh)
    if args.mode == "benchmark":
        batch = next(batches)
        batches.close()  # no feed work under the timed steps
        return benchmark(args, trainer, state, batch, mae_cfg, device)
    try:
        return train(args, trainer, state, batches, run_eval, val_ds, total_steps,
                     train_cfg.keep_checkpoints, device)
    finally:
        batches.close()


def train(args, trainer, state, batches, run_eval, val_ds, total_steps, keep, device):
    """The train loop: log, eval and keep the best-PSNR checkpoint, save
    (rank 0 writes, the metrics are the global batch's on every rank)."""
    mesh = trainer.mesh
    mlog = metric_logger(args, mesh, f"mae_{args.backbone_type}")
    history = []
    best_psnr = -1.0
    t0 = time.time()
    for step in profiled_steps(args, device, range(state.step + 1, total_steps + 1), mesh):
        state, metrics = trainer.train_step(state, next(batches))
        if step % args.log_interval == 0:
            m = {k: float(v) for k, v in metrics.items()}
            rate = args.log_interval * args.batch_size / (time.time() - t0)
            log.info("step %d/%d loss %.4f (rgb %.4f alpha %.4f) gnorm %.3f "
                     "%.2f grids/s", step, total_steps, m["loss"], m["loss_rgb"],
                     m["loss_alpha"], m["grad_norm"], rate)
            mlog.log(step, {**m, "grids_per_sec": rate})
            history.append({"step": step, **m, "grids_per_sec": rate})
            t0 = time.time()
        if step % args.eval_interval == 0 and len(val_ds):
            agg = run_eval(state)
            if agg:
                mlog.log(step, {f"val_{k}": v for k, v in agg.items()})
            if agg.get("psnr", -1) > best_psnr:  # the same on every rank
                best_psnr = agg["psnr"]
                save_on_main(mesh, args.checkpoint_dir, step, state,
                             extra={"psnr": best_psnr}, keep=keep)
                log.info("saved best-PSNR ckpt (%.3f) at step %d", best_psnr, step)
        elif step % args.ckpt_interval == 0:
            save_on_main(mesh, args.checkpoint_dir, step, state, keep=keep)
    save_on_main(mesh, args.checkpoint_dir, state.step, state, keep=keep)
    mlog.close()
    log.info("done: %d steps", state.step)
    return {"steps": state.step, "history": history,
            "checkpoint_dir": args.checkpoint_dir}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def benchmark(args, trainer, state, batch, mae_cfg, device):
    """One warm-up step, then 20 synchronized steps on `batch` (traced to
    --profile_dir when set); rank 0 prints the line, grids/s of the global
    batch."""
    state, _ = trainer.train_step(state, batch)
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    times = []
    with maybe_profile(profile_dir(args, trainer.mesh), device, "mae_train_step"):
        for _ in range(20):
            t = time.perf_counter()
            state, m = trainer.train_step(state, batch)
            _sync(device)
            times.append(time.perf_counter() - t)
    step_ms = float(np.mean(times) * 1e3)
    grids_per_sec = args.batch_size / (step_ms / 1e3)  # the global batch
    ranks = mesh_fields(args, trainer.mesh)
    per_device = grids_per_sec / ranks["world_size"]
    slug = device_slug(device)
    out = {
        "metric": f"grids_per_sec_per_{slug}_{args.backbone_type.replace('_', '')}"
                  f"_mae3d_{args.resolution}",
        "value": per_device,
        "unit": "grids/s/device",
        "step_ms": step_ms,
        "step_ms_std": float(np.std(times) * 1e3),
        "batch_size": args.batch_size,
        **ranks,
        "grids_per_sec": grids_per_sec,
        # MFU only against a card's peak; a CPU run has no device metric
        "mfu": train_mfu(per_device, mae_cfg) if slug == "h100" else None,
        "peak_mem_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                         if device.type == "cuda" else None),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "loss": float(m["loss"]),
        "phase": "done",
    }
    if is_main(trainer.mesh):
        print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
