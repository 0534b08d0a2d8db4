"""What the downstream task CLIs share (the port's counterpart of
scripts/common.py): their flags, the scene datasets on disk, the MAE
weights to graft, checkpoint restore, the benchmark, and the train / eval /
benchmark loop. Flag names and defaults are scripts/common.py's, for the
features the port has, plus --device.
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from nerf_mae_torch.config import SWIN_PRESETS, MAEConfig, TrainConfig
from nerf_mae_torch.data import SceneDataset, load_split
from nerf_mae_torch.train.checkpoint import restore_checkpoint, save_checkpoint

log = logging.getLogger("nerf_mae_torch")


def add_common_flags(p: argparse.ArgumentParser,
                     other_backbones: Sequence[str] = ()) -> argparse.ArgumentParser:
    p.add_argument("--mode", default="train", choices=["train", "eval", "benchmark"])
    p.add_argument("--backbone_type", default="swin_s",
                   choices=list(SWIN_PRESETS) + list(other_backbones))
    p.add_argument("--resolution", default=160, type=int)
    p.add_argument("--batch_size", default=8, type=int)
    p.add_argument("--num_epochs", default=100, type=int)
    p.add_argument("--steps", default=None, type=int)
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--weight_decay", default=1e-3, type=float)
    p.add_argument("--clip_grad_norm", default=0.1, type=float)
    p.add_argument("--compute_dtype", default="bfloat16")
    p.add_argument("--no_remat", action="store_true")
    p.add_argument("--checkpoint_dir", default="checkpoints/task")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--mae_checkpoint", default=None,
                   help="pretrained MAE to graft the trunk and decoder4/3/2 from: "
                        "a checkpoint dir of run_mae_pretrain, a .pt state dict, "
                        "or a .npz of the flattened JAX parameter tree")
    p.add_argument("--log_interval", default=10, type=int)
    p.add_argument("--eval_interval", default=200, type=int)
    p.add_argument("--ckpt_interval", default=500, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--eval_json", default=None)
    p.add_argument("--dataset", default="front3d",
                   choices=["front3d", "hypersim", "scannet", "synthetic"])
    p.add_argument("--features_path", default=None)
    p.add_argument("--dataset_split", default=None)
    p.add_argument("--n_synthetic", default=16, type=int)
    p.add_argument("--n_synthetic_val", default=0, type=int,
                   help="held-out synthetic eval scenes (0: n_synthetic/4)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def setup_logging() -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")


def mae_config(args) -> MAEConfig:
    return MAEConfig(swin=SWIN_PRESETS[args.backbone_type], resolution=args.resolution,
                     compute_dtype=args.compute_dtype, remat=not args.no_remat)


def train_config(args) -> TrainConfig:
    return TrainConfig(batch_size=args.batch_size, lr=args.lr,
                       weight_decay=args.weight_decay,
                       clip_grad_norm=args.clip_grad_norm, seed=args.seed)


class ListDataset:
    """A list of scene dicts as a dataset."""

    def __init__(self, scenes: Sequence[Dict]):
        self.scenes = list(scenes)

    def __len__(self):
        return len(self.scenes)

    def __getitem__(self, i):
        return self.scenes[i]


def scene_datasets(args, train_only: Optional[Dict] = None, **targets):
    """(train, val) SceneDatasets over --features_path, split by
    --dataset_split (val: its val scenes, else its test scenes; without a
    split both hold every scene). `targets` go to both, `train_only`
    (augments, percent_train) to the training set."""
    if not args.features_path:
        raise SystemExit(f"--dataset {args.dataset} needs --features_path")
    split = load_split(args.dataset_split) if args.dataset_split else {}
    mk = lambda scenes, **kw: SceneDataset(args.features_path, scene_list=scenes,
                                           dataset_type=args.dataset, **targets, **kw)
    return (mk(split.get("train"), **(train_only or {})),
            mk(split.get("val", split.get("test"))))


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """Host numpy batch -> tensors on `device`; to a card through pinned
    memory with a non-blocking copy."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def load_mae_params(path: str, mae_cfg: MAEConfig) -> Dict[str, torch.Tensor]:
    """A pretrained MAE's state dict (CPU tensors): from a checkpoint dir of
    run_mae_pretrain (its newest step), a .pt/.pth state dict (or a dict
    holding one under "state_dict"), or a .npz of the flattened JAX
    SwinMAE3D tree for `mae_cfg`."""
    if path.endswith(".npz"):
        from nerf_mae_torch.convert import params_from_jax

        with np.load(path, allow_pickle=False) as f:
            return params_from_jax({k: f[k] for k in f.files}, mae_cfg)
    if path.endswith((".pt", ".pth")):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        return sd.get("state_dict", sd)
    return restore_checkpoint(path)["params"]


def prepare_state(args, trainer, mae_cfg: MAEConfig):
    """init from --seed, then --mae_checkpoint grafted, then --checkpoint
    restored (with the optimizer state and step in train mode)."""
    state = trainer.init(args.seed)
    if args.mae_checkpoint:
        state = trainer.graft_mae(state, load_mae_params(args.mae_checkpoint, mae_cfg))
        log.info("grafted the MAE's weights from %s", args.mae_checkpoint)
    if args.checkpoint:
        restored = restore_checkpoint(args.checkpoint)
        state.model.load_state_dict(restored["params"])
        if args.mode == "train" and "opt_state" in restored:
            state.optimizer.load_state_dict(restored["opt_state"])
            state.step = int(restored["step"])
        log.info("restored step %d from %s", restored["step"], args.checkpoint)
    return state


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def benchmark_steps(args, device: torch.device, step: Callable[[], Dict], metric: str,
                    summary: Callable[[Dict], Dict] = lambda out: {},
                    reps: int = 20, warmup: int = 3) -> Dict:
    """Times `reps` synchronized calls of step() after `warmup`
    (scripts/common.py benchmark_step) and prints one JSON line: ms and its
    std per step, grids/s, peak device memory, the device, and
    summary(the last call's output). Returns that dict."""
    for _ in range(warmup):
        step()
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        m = step()
        _sync(device)
        times.append(time.perf_counter() - t)
    ms = float(np.mean(times) * 1e3)
    out = {
        "metric": metric,
        "ms": ms,
        "ms_std": float(np.std(times) * 1e3),
        "grids_per_sec": args.batch_size / (ms / 1e3),
        "batch_size": args.batch_size,
        "peak_mem_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                         if device.type == "cuda" else None),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        **summary(m),
    }
    print(json.dumps(out), flush=True)
    return out


def benchmark_eval(args, trainer, state, batch: Dict[str, torch.Tensor], task: str,
                   out_resolution: int) -> Dict:
    """benchmark_steps of the trainer's eval step on `batch`, with its loss."""
    return benchmark_steps(
        args, trainer.device, lambda: trainer.eval_step(state, batch),
        f"eval_ms_{task}_{args.backbone_type}_{args.resolution}_to_{out_resolution}",
        summary=lambda m: {"loss": float(m["loss"])})


def run(args, trainer, state, batch_iter: Callable[..., Iterator[Dict[str, np.ndarray]]],
        train_ds, run_eval: Callable, best_key: str, log_keys: Sequence[str],
        task: str, out_resolution: int, benchmark: Optional[Callable] = None):
    """The CLI's --mode: eval (run_eval's metrics, also to --eval_json),
    benchmark (benchmark_eval's dict, or benchmark(args, trainer, state,
    batch)'s) or train (returns {"steps", "history",
    "checkpoint_dir"}; checkpoints at --ckpt_interval, the best `best_key`
    eval at --eval_interval, and the last step)."""
    device = trainer.device
    if args.mode == "eval":
        out = run_eval(state)
        if args.eval_json:
            with open(args.eval_json, "w") as f:
                json.dump(out, f)
        return out
    batches = (to_device(b, device) for b in batch_iter(train_ds, args))
    if args.mode == "benchmark":
        if benchmark is not None:
            return benchmark(args, trainer, state, next(batches))
        return benchmark_eval(args, trainer, state, next(batches), task, out_resolution)

    history = []
    best = -float("inf")
    total = trainer.total_steps
    t0 = time.time()
    for step in range(state.step + 1, total + 1):
        state, metrics = trainer.train_step(state, next(batches))
        if step % args.log_interval == 0:
            m = {k: float(v) for k, v in metrics.items()}
            rate = args.log_interval * args.batch_size / (time.time() - t0)
            log.info("step %d/%d " + " ".join(f"{k} %.5f" for k in log_keys)
                     + " %.2f grids/s", step, total, *(m[k] for k in log_keys), rate)
            history.append({"step": step, **m, "grids_per_sec": rate})
            t0 = time.time()
        if step % args.eval_interval == 0:
            out = run_eval(state)
            if out.get(best_key, -float("inf")) > best:
                best = out[best_key]
                save_checkpoint(args.checkpoint_dir, step, state.model.state_dict(),
                                state.optimizer.state_dict(), extra={best_key: best})
        elif step % args.ckpt_interval == 0:
            save_checkpoint(args.checkpoint_dir, step, state.model.state_dict(),
                            state.optimizer.state_dict())
    save_checkpoint(args.checkpoint_dir, state.step, state.model.state_dict(),
                    state.optimizer.state_dict())
    log.info("done: %d steps", state.step)
    return {"steps": state.step, "history": history, "checkpoint_dir": args.checkpoint_dir}
