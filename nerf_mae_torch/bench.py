"""Headline benchmark of the port: swin_b MAE3D pretraining throughput at
160^3 (counterpart of the repository root's bench.py, with its JSON line).

    python -m nerf_mae_torch.bench [--profile_dir D] [--device cuda|cpu]
    torchrun --nproc_per_node N -m nerf_mae_torch.bench

Prints ONE JSON line (rank 0 under torchrun), bench.py's keys:
  {"metric": "grids_per_sec_per_chip_swinb_mae3d_160", "value": N,
   "unit": "grids/s/chip", "vs_baseline": N, "baseline_basis": "estimate",
   "phase": "done", "mfu": ..., "step_ms": ..., "device": "<card name>"}
and, with more than one rank, n_chips, value_total (grids/s over all
ranks) and scaling_efficiency (a card's throughput in the group over the
same per-card batch on rank 0 alone, measured in the same run).

The step is MAETrainer.train_step (22 fused-block forward and 22 backward
launches at swin_b on a card) on random grids from RandomState(0),
patch-major unless NERF_MAE_PATCH_MAJOR=0, one batch resident on the device
(NERF_MAE_BENCH_DEVICE_DATA=1: served from a device corpus of twice the
batch with bf16 transfer, the --device_data path): one warm-up step whose
loss must be finite, then NERF_MAE_BENCH_REPS timed steps (default 10), a
synchronize before each clock read. --profile_dir (or NERF_MAE_PROFILE_DIR)
traces the timed steps with torch.profiler on rank 0. MFU (flops.train_mfu
against the H100's dense bf16 peak) is reported at the full size on a card
only.

The line is printed even when the run is cut: SIGTERM and SIGINT print it
with the value measured so far (the running mean of the timed steps) or 0,
and the phase reached, then exit 0 if a value was measured and 1 if not.
Batch probes (8, 4, 2, 1 a data rank; NERF_MAE_BENCH_PER_CHIP_BATCH sets
the first) move on ONLY on torch.OutOfMemoryError, which all ranks agree on
in one all_reduce before any retries (the ranks run the same shapes, so an
OOM strikes all of them); NERF_MAE_BENCH_BUDGET_S (default 1500) stops the
probes after 0.6 of it and skips the one-card reference after 0.85. Any
other failure (a kernel that does not build, a non-finite loss, a
collective) prints the line with value 0 and phase "error_<phase>" and
raises: unlike bench.py, which retries on every exception, no failure is
hidden behind a smaller batch.

Size overrides: NERF_MAE_BENCH_PRESET (swin_b), NERF_MAE_BENCH_RESOLUTION
(160; the metric's name stays the full size's, as in bench.py),
NERF_MAE_BENCH_SPACE (the [data, space] mesh's space axis; the per-card
batch is then a data rank's). Below the full size the step runs in float32
without remat, as in bench.py. Runs on the CUDA card unless --device cpu;
asking for the card without one raises.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import signal
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from nerf_mae_torch.common import maybe_profile
from nerf_mae_torch.config import SWIN_PRESETS, MAEConfig, TrainConfig
from nerf_mae_torch.data.device_cache import device_corpus_batches
from nerf_mae_torch.flops import train_mfu
from nerf_mae_torch.ops.patchify import patchify_np
from nerf_mae_torch.parallel import (
    DataMesh,
    all_reduce_sum,
    barrier,
    is_main,
    make_mesh,
    shard_batch,
)
from nerf_mae_torch.train.trainer import MAETrainer

# BASELINE.md: the reference's estimated PyTorch A100 throughput (README's
# "~2 days, 8 A100, batch 32" for swin_b-class models), per GPU. No number
# is published; "baseline_basis": "estimate" says so.
BASELINE_GRIDS_PER_SEC = 3.0
METRIC = "grids_per_sec_per_chip_swinb_mae3d_160"

# the run's measurement and phase, read by the signal handler
_state: Dict = {}


def _fresh_state() -> Dict:
    return {"value": None, "mfu": None, "step_ms": None, "phase": "start",
            "n_chips": None, "value_total": None, "scaling_efficiency": None,
            "device": None, "emitted": False,
            "main": os.environ.get("RANK", "0") == "0"}


def _emit() -> Dict:
    """The JSON line (printed once, by rank 0); returns its dict."""
    value = _state["value"] or 0.0
    out = {
        "metric": METRIC,
        "value": value,
        "unit": "grids/s/chip",
        "vs_baseline": value / BASELINE_GRIDS_PER_SEC,
        "baseline_basis": "estimate",
        "phase": _state["phase"],
    }
    if _state["mfu"] is not None:
        out["mfu"] = _state["mfu"]
    if _state["step_ms"] is not None:
        out["step_ms"] = _state["step_ms"]
    if _state["n_chips"] and _state["n_chips"] > 1:
        out["n_chips"] = _state["n_chips"]
        if _state["value_total"] is not None:
            out["value_total"] = _state["value_total"]
        if _state["scaling_efficiency"] is not None:
            out["scaling_efficiency"] = _state["scaling_efficiency"]
    if _state["device"] is not None:
        out["device"] = _state["device"]
    if _state["main"] and not _state["emitted"]:
        _state["emitted"] = True
        print(json.dumps(out), flush=True)
    return out


def _on_term(signum, frame):
    _emit()
    os._exit(0 if _state["value"] else 1)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="MAE pretraining throughput (PyTorch port)")
    p.add_argument("--profile_dir", default=os.environ.get("NERF_MAE_PROFILE_DIR"),
                   help="torch.profiler trace of the timed steps (rank 0)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _any(flags, mesh: DataMesh):
    """Each flag, true on any rank (one collective)."""
    t = torch.tensor([float(f) for f in flags], device=mesh.device)
    return [bool(v > 0) for v in all_reduce_sum([t], mesh)[0].tolist()]


def _measure(cfg: MAEConfig, mesh: DataMesh, batch_size: int, reps: int,
             patch_major: bool, device_data: bool, profile_dir: Optional[str] = None,
             report: bool = True):
    """One warm-up and `reps` timed train steps of the global batch
    `batch_size` on `mesh`. With `report`, the phase and the running value
    go to the state the signal handler prints. Returns (grids/s a card,
    seconds a step)."""
    r = cfg.resolution
    device = mesh.device
    trainer = MAETrainer(cfg, TrainConfig(batch_size=batch_size), 1000, device, mesh)
    state = trainer.init(0)
    rng = np.random.RandomState(0)
    n_scenes = 2 * batch_size if device_data else batch_size
    grids = rng.rand(n_scenes, r, r, r, cfg.input_channels).astype(np.float32)
    if patch_major:
        grids = patchify_np(grids, cfg.swin.patch_size[0])
    host = {"grids": grids, "sizes": np.full((n_scenes, 3), r, np.int32)}
    if device_data:
        it = device_corpus_batches(host, device, batch_size, transfer_dtype="bfloat16",
                                   rank=mesh.data_rank, world=mesh.data_world,
                                   space_rank=mesh.space_rank, space=mesh.space)
        next_batch = lambda: next(it)
    else:
        fixed = shard_batch(host, mesh)
        next_batch = lambda: fixed
    del grids, host
    if report:
        _state["phase"] = f"warmup_batch{batch_size}"
    state, m = trainer.train_step(state, next_batch())
    loss = float(m["loss"])
    if not math.isfinite(loss):
        raise FloatingPointError(f"warm-up loss {loss} at batch {batch_size}")
    if report:
        _state["phase"] = f"timed_batch{batch_size}"
    print(f"# timing batch={batch_size} reps={reps}", file=sys.stderr, flush=True)
    with maybe_profile(profile_dir if is_main(mesh) else None, device, "bench"):
        _sync(device)
        t0 = time.perf_counter()
        for i in range(reps):
            state, m = trainer.train_step(state, next_batch())
            _sync(device)
            dt = (time.perf_counter() - t0) / (i + 1)
            value = batch_size / dt / mesh.world_size
            if report:  # the value so far, for a run cut by a signal
                _state.update(value=value, step_ms=dt * 1e3,
                              value_total=value * mesh.world_size)
    return value, dt


def _run(args) -> None:
    budget_s = float(os.environ.get("NERF_MAE_BENCH_BUDGET_S", "1500"))
    t_start = time.monotonic()
    preset = os.environ.get("NERF_MAE_BENCH_PRESET", "swin_b")
    resolution = int(os.environ.get("NERF_MAE_BENCH_RESOLUTION", "160"))
    reps = int(os.environ.get("NERF_MAE_BENCH_REPS", "10"))
    per_chip = int(os.environ.get("NERF_MAE_BENCH_PER_CHIP_BATCH", "8"))
    n_space = int(os.environ.get("NERF_MAE_BENCH_SPACE", "1"))
    device_data = os.environ.get("NERF_MAE_BENCH_DEVICE_DATA", "0") == "1"
    patch_major = os.environ.get("NERF_MAE_PATCH_MAJOR", "1") == "1"
    full_size = preset == "swin_b" and resolution == 160
    cfg = MAEConfig(swin=SWIN_PRESETS[preset], resolution=resolution,
                    compute_dtype="bfloat16" if full_size else "float32", remat=full_size)

    with make_mesh(device=args.device, n_space=n_space) as mesh:
        _state["main"] = is_main(mesh)
        n_chips = mesh.world_size
        _state["n_chips"] = n_chips
        cuda = mesh.device.type == "cuda"
        _state["device"] = torch.cuda.get_device_name(mesh.device) if cuda else "cpu"
        probes = [b * mesh.data_world for b in (per_chip, per_chip // 2, per_chip // 4, 1)
                  if b >= 1]
        over_budget = False
        for probe_i, batch_size in enumerate(dict.fromkeys(probes)):
            if probe_i and over_budget:
                _state["phase"] = f"budget_exhausted_before_batch{batch_size}"
                break
            oom = False
            try:
                value, dt = _measure(cfg, mesh, batch_size, reps, patch_major, device_data,
                                     args.profile_dir)
            except torch.OutOfMemoryError as e:
                print(f"# batch={batch_size} out of memory: {e}".splitlines()[0],
                      file=sys.stderr, flush=True)
                oom = True
            elapsed = time.monotonic() - t_start
            oom, over_budget = _any([oom, elapsed > budget_s * 0.6], mesh)
            if oom:  # every rank moves on to the next probe
                _state.update(value=None, step_ms=None, value_total=None)
                gc.collect()  # the failed probe's tensors, before the allocator's cache
                if cuda:
                    torch.cuda.empty_cache()
                continue
            _state.update(value=value, step_ms=dt * 1e3, value_total=value * n_chips,
                          mfu=train_mfu(value, cfg) if full_size and cuda else None,
                          phase="done")
            print(f"# batch={batch_size} step={dt * 1e3:.1f}ms -> {value:.2f} grids/s/chip "
                  f"x {n_chips} chips", file=sys.stderr, flush=True)
            break

        # scaling efficiency: the same per-card batch on rank 0 alone, the
        # other ranks waiting at a barrier
        late = _any([time.monotonic() - t_start >= budget_s * 0.85], mesh)[0]
        if _state["value"] and n_chips > 1 and not late:
            _state["phase"] = "single_chip_reference"
            if is_main(mesh):
                lone = DataMesh(0, 1, mesh.local_rank, mesh.device)
                try:
                    v1, _ = _measure(cfg, lone, batch_size // mesh.data_world, reps,
                                     patch_major, device_data, report=False)
                    _state["scaling_efficiency"] = _state["value"] / v1
                    print(f"# single-chip ref {v1:.2f} grids/s -> scaling eff "
                          f"{_state['scaling_efficiency']:.3f}", file=sys.stderr, flush=True)
                except torch.OutOfMemoryError as e:
                    print(f"# single-chip reference out of memory: {e}".splitlines()[0],
                          file=sys.stderr, flush=True)
            barrier(mesh)
            _state["phase"] = "done"


def main(argv=None) -> Dict:
    """CLI entry; returns the JSON line's dict (on every rank)."""
    args = parse_args(argv)
    _state.clear()
    _state.update(_fresh_state())
    handlers = {s: signal.signal(s, _on_term) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        _run(args)
    except Exception:
        _state.update(value=None, phase=f"error_{_state['phase']}")
        _emit()
        raise
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)
    return _emit()


if __name__ == "__main__":
    sys.exit(0 if main()["value"] else 1)
