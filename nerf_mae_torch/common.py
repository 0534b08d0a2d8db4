"""What the task CLIs share (the port's counterpart of scripts/common.py):
their flags, the scene datasets on disk, the training feed, the MAE weights
to graft, checkpoint restore, the profiler, the benchmark, and the train /
eval / benchmark loop. Flag names and defaults are scripts/common.py's, for
the features the port has, plus --device.

The training feed (make_train_batches): by default a host batch iterator
(scenes assembled on --workers threads with the native collate) behind a
prefetch thread that keeps --prefetch batches ready and copies each to the
card while it runs the previous step. The copy (HostToDevice) flattens
patch-major leaves channel-flat, casts float32 grid leaves to
--transfer_dtype on the host, fills one of a ring of reused pinned buffers
and uploads it on a dedicated copy stream; the training stream waits on the
copy's event. --device_data instead uploads the whole corpus once and
serves batches as device gathers (data/device_cache.py).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import time
from typing import Callable, Dict, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from nerf_mae_torch.config import SWIN_PRESETS, MAEConfig, TrainConfig
from nerf_mae_torch.data import SceneDataset, load_split, prefetch
from nerf_mae_torch.data.device_cache import (
    TRANSFER_DTYPES,
    casts_to,
    corpus_from_iterator,
    device_corpus_batches,
)
from nerf_mae_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from nerf_mae_torch.utils import MetricLogger

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
    add_feed_flags(p)
    return p


def add_feed_flags(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The training feed's flags and the run's logging and profiling
    (scripts/common.py's names and defaults)."""
    p.add_argument("--workers", default=max((os.cpu_count() or 1) - 1, 0), type=int,
                   help="batch-assembly threads (0 = inline)")
    p.add_argument("--prefetch", default=2, type=int,
                   help="batches kept ready on a background thread, each copied to "
                        "the card while it runs the previous step (0 = synchronous)")
    p.add_argument("--transfer_dtype", default="float32", choices=list(TRANSFER_DTYPES),
                   help="cast float32 grid leaves on the host before the copy (halves "
                        "host->device bytes; also quantises the MAE's targets)")
    p.add_argument("--device_data", action="store_true",
                   help="upload the whole (fixed) training corpus to the card once and "
                        "serve batches as device gathers (excludes host augments)")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler chrome trace of the benchmark steps "
                        "(or the first --log_interval train steps) here")
    p.add_argument("--log_dir", default=None, help="jsonl metric log dir")
    p.add_argument("--wandb", action="store_true",
                   help="also log to wandb (when the package can be imported)")
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


def transfer_leaf(v: np.ndarray, transfer_dtype: Optional[str]) -> torch.dtype:
    """The dtype a host leaf is copied in: transfer_dtype for float32 grids
    (ndim >= 4), its own otherwise."""
    if casts_to(v, transfer_dtype):
        return TRANSFER_DTYPES[transfer_dtype]
    return torch.from_numpy(v).dtype


class HostToDevice:
    """The transfer half of the JAX package's shard_batch for one device:
    a host numpy batch -> tensors on `device`, patch-major leaves flattened
    channel-flat and float32 grid leaves cast to `transfer_dtype`.

    On a card the cast happens while filling one of a ring of `slots`
    pinned buffers, reused; the upload runs on a dedicated copy stream and
    `__call__` returns (batch, event). A slot is refilled only after its
    previous upload's event has completed. `ready` makes the consuming
    stream wait on the event and marks the tensors as used by it, so the
    allocator does not hand their memory to a later upload under a running
    step. On the CPU the batch is wrapped (cast where asked), event None."""

    def __init__(self, device: torch.device, transfer_dtype: Optional[str] = None,
                 slots: int = 1):
        self.device = torch.device(device)
        self.transfer_dtype = transfer_dtype
        cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        self._slots = [({}, None) for _ in range(max(slots, 1))]
        self._next = 0

    def __call__(self, batch: Dict[str, np.ndarray]):
        # patch-major [B, T, T, T, p^3, C] leaves travel channel-flat (a view)
        host = {k: v.reshape(*v.shape[:4], -1) if v.ndim == 6 else v
                for k, v in batch.items()}
        if self._stream is None:
            return {k: torch.from_numpy(v).to(transfer_leaf(v, self.transfer_dtype))
                    for k, v in host.items()}, None
        i = self._next
        self._next = (i + 1) % len(self._slots)
        bufs, event = self._slots[i]
        if event is not None:
            event.synchronize()  # the slot's previous upload has completed
        out = {}
        with torch.cuda.stream(self._stream):
            for k, v in host.items():
                dtype = transfer_leaf(v, self.transfer_dtype)
                buf = bufs.get(k)
                if buf is None or buf.shape != v.shape or buf.dtype != dtype:
                    buf = bufs[k] = torch.empty(v.shape, dtype=dtype, pin_memory=True)
                buf.copy_(torch.from_numpy(v))
                out[k] = buf.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._slots[i] = (bufs, event)
        return out, event

    def ready(self, copied) -> Dict[str, torch.Tensor]:
        """The batch of a __call__, once the current stream may use it."""
        batch, event = copied
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in batch.values():
                t.record_stream(stream)
        return batch


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """A host batch on `device`, ready for the current stream (the evals):
    one HostToDevice transfer, nothing cast."""
    put = HostToDevice(device)
    return put.ready(put(batch))


def overlap_batches(batches: Iterable[Dict[str, np.ndarray]], device: torch.device,
                    depth: int, transfer_dtype: Optional[str] = None
                    ) -> Iterator[Dict[str, torch.Tensor]]:
    """Host batches -> device batches. depth > 0: assembly and upload of
    batch N+1 run on a prefetch thread while the device runs step N (the
    reference's DataLoader workers, nerf_mae/run_swin_mae3d.py:578-586);
    depth 0: inline. The ring holds depth + 1 pinned slots."""
    put = HostToDevice(device, transfer_dtype, slots=depth + 1)
    source = prefetch(batches, depth=depth, map_fn=put) if depth > 0 else map(put, batches)
    try:
        for copied in source:
            yield put.ready(copied)
    finally:
        if depth > 0:
            source.close()  # also closes `batches` once its thread has stopped
        elif hasattr(batches, "close"):
            batches.close()


def make_train_batches(args, device: torch.device,
                       host_iter_factory: Callable[[], Iterator[Dict[str, np.ndarray]]],
                       corpus_iter_factory: Optional[Callable[[], Iterator]] = None
                       ) -> Iterator[Dict[str, torch.Tensor]]:
    """The training batch stream of a driver (scripts/common.py
    make_train_batches): the host iterator behind overlap_batches, or under
    --device_data the corpus (`corpus_iter_factory()`, or the host iterator,
    drained once: every scene exactly once) uploaded and served as device
    gathers in the host iterator's epoch order."""
    if not getattr(args, "device_data", False):
        return overlap_batches(host_iter_factory(), device, args.prefetch,
                               transfer_dtype=args.transfer_dtype)
    aug = [f for f in ("flip_prob", "rotate_prob", "rot_scale_prob")
           if getattr(args, f, 0.0)]
    if aug:
        raise SystemExit(
            "--device_data caches a fixed corpus once; per-epoch host "
            "augmentation is incompatible (drop "
            + ", ".join(f"--{a}" for a in aug) + ")")
    corpus = corpus_from_iterator((corpus_iter_factory or host_iter_factory)())
    return device_corpus_batches(corpus, device, args.batch_size, seed=args.seed,
                                 transfer_dtype=args.transfer_dtype)


@contextlib.contextmanager
def maybe_profile(profile_dir: Optional[str], device: torch.device, name: str = "steps"):
    """torch.profiler (CPU, and CUDA on a card) around the wrapped steps
    when profile_dir is set; writes <profile_dir>/<name>_<pid>_<time>.json,
    a chrome trace (scripts/common.py maybe_profile)."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        yield
        _sync(device)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"{name}_{os.getpid()}_{int(time.time() * 1e3)}.json")
    prof.export_chrome_trace(path)
    log.info("trace written to %s", path)


def profiled_steps(args, device: torch.device, steps: Iterable[int]) -> Iterator[int]:
    """The train loop's steps, the first --log_interval of them under
    maybe_profile(--profile_dir)."""
    steps = list(steps)
    with maybe_profile(getattr(args, "profile_dir", None), device, "train"):
        yield from steps[:args.log_interval]
    yield from steps[args.log_interval:]


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
    (scripts/common.py benchmark_step), under maybe_profile(--profile_dir),
    and prints one JSON line: ms and its std per step, grids/s, peak device
    memory, the device, and summary(the last call's output). Returns that
    dict."""
    for _ in range(warmup):
        step()
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    times = []
    with maybe_profile(getattr(args, "profile_dir", None), device, metric):
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
        task: str, out_resolution: int, benchmark: Optional[Callable] = None,
        corpus_iter: Optional[Callable[[], Iterator[Dict[str, np.ndarray]]]] = None):
    """The CLI's --mode: eval (run_eval's metrics, also to --eval_json),
    benchmark (benchmark_eval's dict, or benchmark(args, trainer, state,
    batch)'s) or train (returns {"steps", "history",
    "checkpoint_dir"}; checkpoints at --ckpt_interval, the best `best_key`
    eval at --eval_interval, and the last step). The training batches are
    make_train_batches' over batch_iter(train_ds, args), with `corpus_iter`
    the one-epoch pass that --device_data uploads."""
    device = trainer.device
    if args.mode == "eval":
        out = run_eval(state)
        if args.eval_json:
            with open(args.eval_json, "w") as f:
                json.dump(out, f)
        return out
    batches = make_train_batches(args, device, lambda: batch_iter(train_ds, args),
                                 corpus_iter)
    if args.mode == "benchmark":
        batch = next(batches)
        batches.close()  # no feed work under the timed steps
        if benchmark is not None:
            return benchmark(args, trainer, state, batch)
        return benchmark_eval(args, trainer, state, batch, task, out_resolution)
    try:
        return _train(args, trainer, state, batches, run_eval, best_key, log_keys, task)
    finally:
        batches.close()


def _train(args, trainer, state, batches, run_eval, best_key, log_keys, task):
    history = []
    best = -float("inf")
    total = trainer.total_steps
    mlog = MetricLogger(args.log_dir, use_wandb=args.wandb,
                        run_name=f"{task}_{args.backbone_type}", config=vars(args))
    t0 = time.time()
    for step in profiled_steps(args, trainer.device, range(state.step + 1, total + 1)):
        state, metrics = trainer.train_step(state, next(batches))
        if step % args.log_interval == 0:
            m = {k: float(v) for k, v in metrics.items()}
            rate = args.log_interval * args.batch_size / (time.time() - t0)
            log.info("step %d/%d " + " ".join(f"{k} %.5f" for k in log_keys)
                     + " %.2f grids/s", step, total, *(m[k] for k in log_keys), rate)
            mlog.log(step, {**m, "grids_per_sec": rate})
            history.append({"step": step, **m, "grids_per_sec": rate})
            t0 = time.time()
        if step % args.eval_interval == 0:
            out = run_eval(state)
            if out:
                mlog.log(step, {f"val_{k}": v for k, v in out.items()})
            if out.get(best_key, -float("inf")) > best:
                best = out[best_key]
                save_checkpoint(args.checkpoint_dir, step, state.model.state_dict(),
                                state.optimizer.state_dict(), extra={best_key: best})
        elif step % args.ckpt_interval == 0:
            save_checkpoint(args.checkpoint_dir, step, state.model.state_dict(),
                            state.optimizer.state_dict())
    save_checkpoint(args.checkpoint_dir, state.step, state.model.state_dict(),
                    state.optimizer.state_dict())
    mlog.close()
    log.info("done: %d steps", state.step)
    return {"steps": state.step, "history": history, "checkpoint_dir": args.checkpoint_dir}
