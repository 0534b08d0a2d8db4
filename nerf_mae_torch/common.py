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

Data parallelism (build_mesh): under torchrun every driver trains on the
process group's ranks, `--batch_size` being the global batch, as in JAX
(`torchrun --nproc_per_node N -m nerf_mae_torch.run_<task> ...`). A rank's
feed loads its rows of each batch; checkpoints, the metric log, --eval_json,
--profile_dir and the benchmark's JSON line are rank 0's (the others wait at
a barrier where rank 0 writes); the evals reduce to the global batch's
metrics on every rank.

Grid sharding (`--mesh_space S`, the MAE, SR and semantics drivers): the
world is a [world / S, S] mesh; a data row's S ranks load the same rows and
each keeps its slab of axis 1 of every grid leaf (parallel.mesh.host_slab,
also the device corpus's), so --batch_size divides over world / S ranks.
The detection drivers refuse it, as their JAX drivers do.
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

from nerf_mae_torch import tracing
from nerf_mae_torch.config import SWIN_PRESETS, MAEConfig, TrainConfig
from nerf_mae_torch.convert import jax_params, params_from_jax, read_npz, state_dict_of
from nerf_mae_torch.data import SceneDataset, load_split, prefetch
from nerf_mae_torch.data.device_cache import (
    TRANSFER_DTYPES,
    casts_to,
    corpus_from_iterator,
    device_corpus_batches,
)
from nerf_mae_torch.parallel.mesh import (
    DataMesh,
    barrier,
    distributed,
    gather_objects,
    host_slab,
    is_main,
    make_mesh,
    shard_batch,
)
from nerf_mae_torch.train.checkpoint import load_jax_state, restore_checkpoint, save_checkpoint
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
    p.add_argument("--checkpoint", default=None,
                   help="resume or evaluate: a checkpoint dir of this driver, or a JAX "
                        "state .npz (tools.orbax_to_npz --state)")
    p.add_argument("--mae_checkpoint", default=None,
                   help="pretrained MAE to graft the trunk and decoder4/3/2 from: "
                        "a checkpoint dir of run_mae_pretrain, a .pt state dict, "
                        "or a .npz of the flattened JAX parameter tree (tools.orbax_to_npz, "
                        "with or without --state)")
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
    add_mesh_flags(p)
    return p


def add_mesh_flags(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """--mesh_space (scripts/common.py's flag): the [data, space] grid
    sharding over the process group's ranks (build_mesh)."""
    p.add_argument("--mesh_space", default=1, type=int,
                   help="shard the voxel grid's first spatial dim over this many "
                        "ranks ([data, space] mesh; the world must be a multiple)")
    return p


def build_mesh(args, spatial_ok: bool = True) -> DataMesh:
    """The driver's mesh (parallel.make_mesh on --device): the process group
    of torchrun's environment, or one process without a group, laid out as
    [world / --mesh_space, --mesh_space]. Detection refuses --mesh_space > 1
    (spatial_ok=False) with its JAX drivers' words (SystemExit)."""
    space = getattr(args, "mesh_space", 1) or 1
    if space > 1 and not spatial_ok:
        raise SystemExit(
            "--mesh_space > 1 is only supported by the MAE/SR/semantics "
            "trainers (detection trainers are data-parallel only)")
    mesh = make_mesh(device=args.device, n_space=space)
    if distributed(mesh):
        log.info("mesh: rank %d of %d on %s over %s, [data %d, space %d], global batch %d "
                 "(%d a data rank)", mesh.rank, mesh.world_size, mesh.device,
                 torch.distributed.get_backend(mesh.group), mesh.data_world, mesh.space,
                 args.batch_size, args.batch_size // mesh.data_world)
    return mesh


def save_on_main(mesh: Optional[DataMesh], ckpt_dir: str, step: int, state, **kw) -> None:
    """Rank 0 writes the state's checkpoint (save_checkpoint), the others
    wait for it at a barrier."""
    if is_main(mesh):
        save_checkpoint(ckpt_dir, step, state.model.state_dict(),
                        state.optimizer.state_dict(), **kw)
    barrier(mesh)


def write_eval_json(args, mesh: Optional[DataMesh], out: Dict) -> None:
    if args.eval_json and is_main(mesh):
        with open(args.eval_json, "w") as f:
            json.dump(out, f)


def metric_logger(args, mesh: Optional[DataMesh], run_name: str) -> MetricLogger:
    """The run's MetricLogger (--log_dir, --wandb) on rank 0, one that
    writes nothing on the others."""
    main = is_main(mesh)
    return MetricLogger(args.log_dir if main else None, use_wandb=args.wandb and main,
                        run_name=run_name, config=vars(args))


def eval_shards(batches: Iterable[Dict[str, np.ndarray]], mesh: Optional[DataMesh]
                ) -> Iterator:
    """(host batch, this rank's rows (and slab) of it on the mesh's device)
    for each eval batch. On a group, a batch that does not divide over the
    data ranks is skipped, as the JAX drivers skip it (a static-shape ragged
    tail)."""
    world = 1 if mesh is None else mesh.data_world
    for batch in batches:
        if distributed(mesh) and len(batch["grids"]) % world:
            log.warning("eval: skipping a batch of %d scenes (not divisible over %d data "
                        "ranks)", len(batch["grids"]), world)
            continue
        yield batch, shard_batch(batch, mesh)


def gather_rows(det: Dict[str, torch.Tensor], mesh: Optional[DataMesh]
                ) -> Dict[str, np.ndarray]:
    """Every rank's rows of a prediction dict as host arrays, joined in rank
    order (the global batch's predictions), on every rank."""
    parts = gather_objects({k: v.cpu().numpy() for k, v in det.items()}, mesh)
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


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
                        "(or the first --log_interval train steps) here, and beside it "
                        "(also logged) the port's spans a step: calls, host, self host, "
                        "device interval, device busy and idle ms, and its counters")
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
    step. On the CPU the batch is wrapped (cast where asked), event None.
    On a card: span nerf_mae.feed.h2d (on the copy stream), counter
    feed.h2d_bytes (tracing.py)."""

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
        with torch.cuda.stream(self._stream), tracing.span("nerf_mae.feed.h2d"):
            for k, v in host.items():
                dtype = transfer_leaf(v, self.transfer_dtype)
                buf = bufs.get(k)
                if buf is None or buf.shape != v.shape or buf.dtype != dtype:
                    buf = bufs[k] = torch.empty(v.shape, dtype=dtype, pin_memory=True)
                buf.copy_(torch.from_numpy(v))
                out[k] = buf.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        if tracing.on():
            tracing.count("feed.h2d_bytes", sum(t.numel() * t.element_size()
                                                for t in out.values()))
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
            tracing.count("feed.batches")
            yield put.ready(copied)
    finally:
        if depth > 0:
            source.close()  # also closes `batches` once its thread has stopped
        elif hasattr(batches, "close"):
            batches.close()


def make_train_batches(args, device: torch.device,
                       host_iter_factory: Callable[[], Iterator[Dict[str, np.ndarray]]],
                       corpus_iter_factory: Optional[Callable[[], Iterator]] = None,
                       mesh: Optional[DataMesh] = None
                       ) -> Iterator[Dict[str, torch.Tensor]]:
    """The training batch stream of a driver (scripts/common.py
    make_train_batches): the host iterator (a rank's rows of each batch on
    a mesh) behind overlap_batches, or under --device_data the corpus
    (`corpus_iter_factory()`, or the host iterator, drained once: every
    scene exactly once; the whole corpus on every rank, its slabs on a space
    axis) uploaded and served as device gathers in the host iterator's epoch
    order, a rank gathering its rows. On a space axis the host iterator
    gives this rank's data row and the feed keeps its slabs."""
    if not getattr(args, "device_data", False):
        source = host_iter_factory()
        if mesh is not None and mesh.space > 1:
            source = (host_slab(b, mesh) for b in source)
        return overlap_batches(source, device, args.prefetch,
                               transfer_dtype=args.transfer_dtype)
    aug = [f for f in ("flip_prob", "rotate_prob", "rot_scale_prob")
           if getattr(args, f, 0.0)]
    if aug:
        raise SystemExit(
            "--device_data caches a fixed corpus once; per-epoch host "
            "augmentation is incompatible (drop "
            + ", ".join(f"--{a}" for a in aug) + ")")
    corpus = corpus_from_iterator((corpus_iter_factory or host_iter_factory)())
    if mesh is None:
        return device_corpus_batches(corpus, device, args.batch_size, seed=args.seed,
                                     transfer_dtype=args.transfer_dtype)
    return device_corpus_batches(corpus, device, args.batch_size, seed=args.seed,
                                 transfer_dtype=args.transfer_dtype, rank=mesh.data_rank,
                                 world=mesh.data_world, space_rank=mesh.space_rank,
                                 space=mesh.space)


@contextlib.contextmanager
def maybe_profile(profile_dir: Optional[str], device: torch.device, name: str = "steps",
                  mesh: Optional[DataMesh] = None):
    """torch.profiler (CPU, and CUDA on a card) around the wrapped steps
    when profile_dir is set; writes <profile_dir>/<name>_<pid>_<time>.json,
    a chrome trace (scripts/common.py maybe_profile). The port's spans are
    on while it records (tracing.py): their table (a row per span: calls,
    host, self host, device interval, device busy and idle ms a step) and
    the counters over the wrapped steps are logged and written beside the
    trace as <name>_<pid>_<time>.spans.json."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    tracing.reset()
    before = tracing.counters(mesh)
    with profile(activities=acts) as prof:
        yield
        _sync(device)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"{name}_{os.getpid()}_{int(time.time() * 1e3)}.json")
    prof.export_chrome_trace(path)
    log.info("trace written to %s", path)
    spans = tracing.table(prof, mesh, before)
    log.info("%s", tracing.format_table(spans))
    with open(path[:-len(".json")] + ".spans.json", "w") as f:
        json.dump(spans, f, indent=1)


def profile_dir(args, mesh: Optional[DataMesh] = None) -> Optional[str]:
    """--profile_dir on rank 0, None on the others."""
    return getattr(args, "profile_dir", None) if is_main(mesh) else None


def profiled_steps(args, device: torch.device, steps: Iterable[int],
                   mesh: Optional[DataMesh] = None) -> Iterator[int]:
    """The train loop's steps, the first --log_interval of them under
    maybe_profile(--profile_dir) on rank 0."""
    steps = list(steps)
    with maybe_profile(profile_dir(args, mesh), device, "train", mesh):
        yield from steps[:args.log_interval]
    yield from steps[args.log_interval:]


def is_orbax_checkpoint(path: str) -> bool:
    """Whether `path` is a JAX (orbax) checkpoint directory or one of its
    steps: a step holds `state/_METADATA`."""
    steps = [path] + [os.path.join(path, n) for n in os.listdir(path) if n.isdigit()]
    return any(os.path.isfile(os.path.join(s, "state", "_METADATA")) for s in steps)


def refuse_orbax(path: str) -> None:
    """Raise on a JAX (orbax) checkpoint directory, naming the tool that
    turns it into the .npz the port reads."""
    if os.path.isdir(path) and is_orbax_checkpoint(path):
        raise ValueError(
            f"{path} is a JAX (orbax) checkpoint; convert it where it was written with "
            f"`python -m nerf_mae_torch.tools.orbax_to_npz {path} --state --out state.npz` "
            "and pass the .npz")


def load_mae_params(path: str, mae_cfg: MAEConfig) -> Dict[str, torch.Tensor]:
    """A pretrained MAE's state dict (CPU tensors): from a checkpoint dir of
    run_mae_pretrain (its newest step), a .pt/.pth state dict or checkpoint
    (a step's state.pt; convert.state_dict_of), or an .npz of
    tools.orbax_to_npz (the flattened JAX SwinMAE3D tree for `mae_cfg`, or
    the `params/` part of a --state .npz). A JAX (orbax) checkpoint
    directory is refused, naming the tool."""
    if path.endswith(".npz"):
        return params_from_jax(jax_params(read_npz(path)), mae_cfg)
    if path.endswith((".pt", ".pth")):
        return dict(state_dict_of(torch.load(path, map_location="cpu", weights_only=True)))
    refuse_orbax(path)
    return restore_checkpoint(path)["params"]


def restore_state(args, trainer, state):
    """Restore --checkpoint into `state`: a checkpoint
    dir of the port's drivers (its newest step) or a JAX state .npz
    (tools.orbax_to_npz --state; train/checkpoint.load_jax_state through
    trainer.params_from_jax). The parameters load strictly; in train mode
    the optimizer state and the step too (the schedule then goes on from
    the optimizer's update count). A JAX orbax directory is refused."""
    path = args.checkpoint
    if path.endswith(".npz"):
        restored = load_jax_state(path, state.model, state.optimizer, trainer.params_from_jax)
    else:
        refuse_orbax(path)
        restored = restore_checkpoint(path)
    state.model.load_state_dict(restored["params"])
    if args.mode == "train" and "opt_state" in restored:
        state.optimizer.load_state_dict(restored["opt_state"])
        state.step = int(restored["step"])
    log.info("restored step %d from %s", restored["step"], path)
    return state


def prepare_state(args, trainer, mae_cfg: MAEConfig):
    """init from --seed, then --mae_checkpoint grafted, then --checkpoint
    restored (restore_state)."""
    state = trainer.init(args.seed)
    if args.mae_checkpoint:
        state = trainer.graft_mae(state, load_mae_params(args.mae_checkpoint, mae_cfg))
        log.info("grafted the MAE's weights from %s", args.mae_checkpoint)
    if args.checkpoint:
        state = restore_state(args, trainer, state)
    return state


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def mesh_fields(args, mesh: Optional[DataMesh]) -> Dict:
    """The benchmark line's mesh fields: the world size, the data and space
    axes and the per-rank batch (--batch_size is the global one; the ranks
    of a space group hold the same rows)."""
    if mesh is None:
        return {"world_size": 1, "data": 1, "space": 1, "batch_per_rank": args.batch_size}
    return {"world_size": mesh.world_size, "data": mesh.data_world, "space": mesh.space,
            "batch_per_rank": args.batch_size // mesh.data_world}


def benchmark_steps(args, device: torch.device, step: Callable[[], Dict], metric: str,
                    summary: Callable[[Dict], Dict] = lambda out: {},
                    reps: int = 20, warmup: int = 3, mesh: Optional[DataMesh] = None) -> Dict:
    """Times `reps` synchronized calls of step() after `warmup`
    (scripts/common.py benchmark_step), under maybe_profile(--profile_dir),
    and prints one JSON line on rank 0: ms and its std per step, grids/s
    of the global batch, peak device memory, the device, the world size and
    per-rank batch, and summary(the last call's output). Returns that
    dict."""
    for _ in range(warmup):
        step()
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    times = []
    with maybe_profile(profile_dir(args, mesh), device, metric, mesh):
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
        **mesh_fields(args, mesh),
        "peak_mem_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                         if device.type == "cuda" else None),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        **summary(m),
    }
    if is_main(mesh):
        print(json.dumps(out), flush=True)
    return out


def benchmark_eval(args, trainer, state, batch: Dict[str, torch.Tensor], task: str,
                   out_resolution: int) -> Dict:
    """benchmark_steps of the trainer's eval step on `batch`, with its loss."""
    return benchmark_steps(
        args, trainer.device, lambda: trainer.eval_step(state, batch),
        f"eval_ms_{task}_{args.backbone_type}_{args.resolution}_to_{out_resolution}",
        summary=lambda m: {"loss": float(m["loss"])}, mesh=trainer.mesh)


def run(args, trainer, state, batch_iter: Callable[..., Iterator[Dict[str, np.ndarray]]],
        train_ds, run_eval: Callable, best_key: str, log_keys: Sequence[str],
        task: str, out_resolution: int, benchmark: Optional[Callable] = None,
        corpus_iter: Optional[Callable[[], Iterator[Dict[str, np.ndarray]]]] = None):
    """The CLI's --mode: eval (run_eval's metrics, also to --eval_json),
    benchmark (benchmark_eval's dict, or benchmark(args, trainer, state,
    batch)'s) or train (returns {"steps", "history",
    "checkpoint_dir"}; checkpoints at --ckpt_interval, the best `best_key`
    eval at --eval_interval, and the last step). The training batches are
    make_train_batches' over batch_iter(train_ds, args, rank=, world=) (the
    trainer's mesh's data rank and data world), with `corpus_iter` the
    one-epoch pass that --device_data uploads."""
    device, mesh = trainer.device, trainer.mesh
    if args.mode == "eval":
        out = run_eval(state)
        write_eval_json(args, mesh, out)
        return out
    rank, world = (0, 1) if mesh is None else (mesh.data_rank, mesh.data_world)
    batches = make_train_batches(
        args, device, lambda: batch_iter(train_ds, args, rank=rank, world=world),
        corpus_iter, mesh)
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
    mesh = trainer.mesh
    mlog = metric_logger(args, mesh, f"{task}_{args.backbone_type}")
    t0 = time.time()
    for step in profiled_steps(args, trainer.device, range(state.step + 1, total + 1), mesh):
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
            if out.get(best_key, -float("inf")) > best:  # the same on every rank
                best = out[best_key]
                save_on_main(mesh, args.checkpoint_dir, step, state, extra={best_key: best})
        elif step % args.ckpt_interval == 0:
            save_on_main(mesh, args.checkpoint_dir, step, state)
    save_on_main(mesh, args.checkpoint_dir, state.step, state)
    mlog.close()
    log.info("done: %d steps", state.step)
    return {"steps": state.step, "history": history, "checkpoint_dir": args.checkpoint_dir}
