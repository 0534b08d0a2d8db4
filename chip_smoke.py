#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (nerf_mae_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the exit code is not 0):
  1. device: the card's name and nvidia-smi's name / power limit;
  2. build: every kernel of csrc/ with nvcc (sm_90a), timed, with ptxas's
     registers, shared memory and spills of each kernel;
  3. kernels: each hand-written kernel against its plain PyTorch version at
     every (stage, shift) of the swin_b 160^3 forward (batch 1, 2 and 8, bf16)
     and one float32 case, with errors, tolerances and CUDA-event times
     beside the bound;
  4. the main path: two inference requests through
     nerf_mae_torch.inference.main at swin_b 160^3 (1 scene of 49-79 voxels
     a side each, padded to 160^3; the first also saves the features; random
     weights from a seed), with the fused-block launches counted, then a
     per-part time breakdown of one forward and a comparison of the whole
     reconstruction with the plain composition;
  5. the erf path: the fused window-attention kernel through the same
     model with gelu="erf", compared with the plain composition;
  6. backward kernels: each against its plain backward at every (stage,
     shift) of the swin_b 160^3 train step at batch 8 (bf16) and one
     float32 case, errors against tolerances, CUDA-event times beside the
     bound and the plain time; then both kernels forward and backward at
     bf16 shapes off that path (128-token windows, heads of 12, 64 and 128),
     each backward twice, bitwise equal;
  7. the train main path: `nerf_mae_torch.run_mae_pretrain.main` trains
     swin_b 160^3 at batch 8 for 6 steps on synthetic scenes (22 fused-block
     forward and 22 backward launches per step, finite losses), `--mode
     eval` reads the checkpoint back, then `--mode benchmark` times the step
     (step ms, grids/s, MFU, peak memory);
  8. gradients: one batch-2 step through the kernels and through the plain
     composition from the same weights, mask and keep factors, in float32
     (kernels against plain) and bf16 (each against the float32 plain
     step), loss and per-group gradient differences against their
     tolerances; every parameter must get a gradient; 22 fused-block
     forward and backward launches per kernel step;
  9. the same for the erf step: 22 fused-attention forward and backward
     launches;
 10. profile: torch.profiler over one block forward and one block backward
     at stage 0 and at stage 2 (batch 8, unshifted): device time per kernel
     name, sorted, with launch counts and the sum;
 11. swin_s kernel cases: the fused block forward and backward against their
     plain versions at every (stage, shift) of the swin_s 160^3 forward and
     train step at batch 8 (C 96 / 192 / 384, heads 3 / 6 / 12), bf16, at
     the phase 3 / 6 tolerances, CUDA-event medians beside bound and plain;
 12. voxel super-resolution: run_mae_pretrain writes a swin_s 160^3
     checkpoint (batch 8, 2 steps); `nerf_mae_torch.run_voxel_sr.main`
     trains swin_s 160^3 -> 256^3 at batch 8 for 4 steps from it (finite
     losses, 22 fused-block forward and 22 backward launches per step),
     `--mode eval` reads its checkpoint back, `--mode benchmark` runs at
     256^3 and 384^3; the graft is verified (every `base` tensor equals the
     MAE checkpoint's); one step's parts on the device timeline with the
     peak memory of each; one step under torch.profiler (device time by
     kernel name, the device's idle share); the batch-1 forward through
     the kernels against the plain composition (rel L2 <= 5e-2); one
     batch-1 float32 train step's gradients by group, kernels against plain
     (<= 1e-2);
 13. voxel semantics: the same at 19 classes, with class weights from
     calculate_class_weights on the synthetic training labels; eval prints
     mIoU / mAcc / allAcc;
 14. FCOS detection (OBB, swin_s 160^3, batch 8, the flags of
     launch/train_fcos_pretrained.sh): `nerf_mae_torch.run_fcos.main` trains
     4 steps from the same MAE checkpoint (finite losses, positives in
     every step, 22 fused-block forward and 22 backward launches per step),
     `--mode eval` reads its checkpoint back (AP25/50/75, recall, AR),
     `--mode benchmark` times the prediction step, OBB and AABB; the graft
     is verified; the parts of a train step (device timeline) and of a
     prediction step (body, head, top-k + decode, NMS + final top-k) with
     their peak memory; the NMS's parts (suppress matrix, greedy scan on the
     device and on the host) on the random-weight candidates and on as many
     clustered on the scenes' boxes; one train step under torch.profiler;
     batch-1 outputs and a float32 step's gradients against the plain
     composition; the post-processing on the card against the CPU, with
     an NMS case where suppression decides what is kept (suppress-matrix
     flips only within 1e-5 of the threshold, kept sets equal up to them);
 15. the anchor RPN and the RCNN (AABB, swin_s 160^3, batch 8, the flags of
     launch/train_rpn.sh): `nerf_mae_torch.run_rpn.main` trains 40 steps from
     the same MAE checkpoint (finite losses, positives in every step, 22
     fused-block forward and 22 backward launches per step), `--mode eval`
     reads its checkpoint back (recall, AR, AP), `--mode benchmark` times
     the prediction step, AABB and OBB; the graft is verified; the parts of
     a train step (body, head, assign + sample + loss, backward, clip +
     AdamW) and of a prediction step (body, head, per-level top-k + decode,
     per-level NMS, final top-k) with their peak memory; one train step
     and one prediction step under torch.profiler; batch-1 head outputs and
     a float32 step's
     gradients (the sampler's draws passed in) against the plain
     composition; the candidates, each level's NMS and the proposals on the
     card against the CPU; then `nerf_mae_torch.run_rpn_detect.main` trains
     the RCNN 4 steps over that RPN (its foreground proposals counted first;
     finite losses, positives in some step,
     22 fused-block forward launches and no backward per step), evals at
     300 (AP) and times the parts of its step (body + proposals, sampling +
     RoI align, head forward, loss + backward, clip + AdamW) with their peak
     memory;
 16. the training feed: `run_mae_pretrain.main` trains swin_b 160^3 at
     batch 8 for 11 steps from 16 scenes on disk (uncompressed npz, odd
     sizes up to 159^3) through four feeds: inline (--prefetch 0 --workers
     0), the pipeline (--prefetch 2 --workers 8, native collate), and
     --device_data with float32 and with bf16 transfer; for each, the
     wall-clock ms/step over steps 3-8 (a synchronize at each end),
     grids/s, the device's idle share under torch.profiler over steps
     9-11, peak memory, host-to-device bytes a step and 22 + 22 fused-block
     launches a step, beside the resident-batch benchmark of phase 7 and
     the host iterator alone at 0, 4 and 8 workers; the losses of steps
     1-11 of inline, pipeline and device float32 bitwise equal, bf16 within
     2e-2 of inline; every native collate function against numpy at 160^3
     (rotate_scale to 1.5e-4: float32 against float64 positions); then
     launch/e2e_synthetic_ap_torch.sh's stages in process, cut (swin_s
     96^3, 32 hard scenes, MAE 60 steps traced to --profile_dir, FCOS 40
     steps grafted and 40 from scratch, eval on 8 scenes): both eval dicts
     finite, a trace written;
 17. L0 data production: a room of 4 boxes seen from 96 orbit views
     (scripts/save_transforms.py, then views of 640x480 rendered on the card
     from an analytic stand-in field with the port's render_rays, PNG with
     16-bit depth); `nerf_mae_torch.run_nerf.main --task train_extract
     --ngp_frame` at the JAX defaults (8x256, 4096 rays, 64 + 64 samples,
     lr 5e-4, max_res 160), --steps cut to 400: the loss falls, the
     hierarchical step's median ms, rays/s, samples/s, TFLOP/s against the
     float32 bound, host ms/step, idle share and peak memory, the extraction
     ms over the 96 views; preprocess_boxes --format obb on the grid and the
     density's centroid on each box; a depth-guided run (--depth_guided
     --depth_loss_weight 0.1 --cam_embed_dim 16, the depth maps) with the
     same numbers; one hierarchical step and a small extraction on the card
     against the CPU (same weights, rays and draws, float32); then
     `run_fcos.main` trains swin_s 160^3 at batch 1 for 2 steps on the
     extracted grid and its boxes (finite losses, positives, 22 + 22
     fused-block launches a step);
 18. one JSON line of the four kernels, nvidia-smi's line, and the last line
     {"ok": true, "device": {...}}.
Every phase header prints the seconds since the start.
Without a CUDA card it exits with code 1 and prints no result.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from nerf_mae_torch import (inference, kernels, run_fcos, run_mae_pretrain, run_nerf, run_rpn,
                            run_rpn_detect, run_voxel_semantics, run_voxel_sr)
from nerf_mae_torch.common import load_mae_params
from nerf_mae_torch.config import SWIN_PRESETS, MAEConfig, TrainConfig
from nerf_mae_torch.data import (
    SceneDataset,
    detection_batch_iterator,
    mae_batch_iterator,
    native,
    rotate_and_scale_scene,
    synthetic_detection_scenes,
)
from nerf_mae_torch.ops.patchify import patchify_np
from nerf_mae_torch.models import heads
from nerf_mae_torch.models.detector import FCOSDetector
from nerf_mae_torch.models.fcos import (
    FCOSConfig,
    fcos_candidates,
    fcos_loss,
    fcos_select,
    nms_boxes,
)
from nerf_mae_torch.models.mae import SwinMAE3D, init_weights, mae_loss
from nerf_mae_torch.models.rcnn import rcnn_loss
from nerf_mae_torch.models.rpn import (
    NeRFRPN,
    RPNConfig,
    rpn_candidates,
    rpn_filter_proposals,
    rpn_level_nms,
    rpn_loss,
    rpn_select,
)
from nerf_mae_torch.ops.fused_attention import (
    fused_window_attention,
    fused_window_attention_bwd,
    fused_window_attention_bwd_plain,
    fused_window_attention_plain,
)
from nerf_mae_torch.ops.fused_block import (
    fused_swin_block,
    fused_swin_block_bwd,
    fused_swin_block_bwd_plain,
    fused_swin_block_plain,
)
from nerf_mae_torch.ops import nms
from nerf_mae_torch.ops.anchors import anchor_padding_mask, anchors_on
from nerf_mae_torch.ops.boxes import box_iou_aabb
from nerf_mae_torch.ops.masking import block_mask_3d
from nerf_mae_torch.ops.rotated_iou import iou_3d
from nerf_mae_torch.train import optim
from nerf_mae_torch.train.checkpoint import extract_trunk
from nerf_mae_torch.train.det_trainer import DetectionTrainer
from nerf_mae_torch.train.head_trainer import VoxelSemanticsTrainer, VoxelSRTrainer
from nerf_mae_torch.train.rpn_trainer import RCNNTrainer, RPNTrainer

# Published H100 SXM peaks (dense): bf16 tensor cores, float32 FMA units,
# HBM3 bandwidth. Bounds are stated against them, with the card's power
# limit printed beside every number.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
REPO = os.path.dirname(os.path.abspath(__file__))
RES = 160
SERVE_REQUESTS = 2  # phase 4; each writes a 160^3 prediction as PLY (~20 s on the host)
# The 22 fused blocks of one swin_b forward, by (stage, shifted): launches
# per forward. Every one of these cases is measured in phase 3.
LAUNCHES_PER_FORWARD = {(0, False): 1, (0, True): 1, (1, False): 1, (1, True): 1,
                        (2, False): 9, (2, True): 9}
# phase 3's batches: 1 is the serving path's (one scene per forward), 8 the
# train step's
KERNEL_BATCHES = (1, 2, 8)
TRAIN_BATCH = 8  # the train step's batch (phases 6 and 7)
TRAIN_STEPS = 6
STAGES = {0: (40, 128, 4), 1: (20, 256, 8), 2: (10, 512, 16)}  # grid, C, heads
# the downstream heads' trunk (the users' launch scripts: swin_s, batch 8);
# its depths 2/2/18/2 give the same 22 fused blocks per forward
SWIN_S_STAGES = {0: (40, 96, 3), 1: (20, 192, 6), 2: (10, 384, 12)}
HEAD_BATCH = 8
HEAD_STEPS = 4
SR_OUT = (256, 384)  # the reference's two output grids (train at the first)
NUM_CLASSES = 19


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print a line; a phase header ("[n] ...") also gets the seconds since
    the script started."""
    if msg.startswith("["):
        msg += f" (at {time.perf_counter() - _T0:.0f} s)"
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median of `reps` CUDA-event timings of fn() after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(max(x, 1e-30))) - 7)


def errors(got: torch.Tensor, want: torch.Tensor):
    got, want = got.float(), want.float()
    max_abs = (got - want).abs().max().item()
    rel_l2 = ((got - want).norm() / want.norm()).item()
    return max_abs, rel_l2, want.abs().max().item()


def check_close(name, got, want, dtype):
    """bf16: the kernel and its plain version round at the same points and
    differ only in float32 summation order, which can move a value across a
    bf16 rounding boundary: max error <= 4 bf16 ulps at the largest output
    magnitude, relative L2 <= 5e-3. float32: summation order only, max error
    <= 1e-4 of the largest output, relative L2 <= 1e-5."""
    max_abs, rel_l2, scale = errors(got, want)
    if dtype == torch.bfloat16:
        tol_abs, tol_rel = 4 * bf16_ulp(scale), 5e-3
    else:
        tol_abs, tol_rel = 1e-4 * max(scale, 1.0), 1e-5
    ok = math.isfinite(max_abs) and max_abs <= tol_abs and rel_l2 <= tol_rel
    log(f"  {name}: max_abs {max_abs:.3e} (tol {tol_abs:.3e}) rel_l2 "
        f"{rel_l2:.3e} (tol {tol_rel:.0e}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return max_abs


def block_weights(c: int, heads: int, gen: torch.Generator, dev, dtype, window=(4, 4, 4)):
    """Random block parameters (torch layout) from `gen`, scaled so that
    attention is peaked and every branch matters. The four weight matrices
    are in the compute dtype, as SwinBlock3D hands them to the kernels; the
    rest is float32."""
    r = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    f = 4 * c
    table = math.prod(2 * w - 1 for w in window)
    return dict(
        ln1_scale=1 + 0.1 * r(c), ln1_bias=0.1 * r(c),
        qkv_weight=(r(3 * c, c) / c ** 0.5).to(dtype), qkv_bias=0.1 * r(3 * c),
        proj_weight=(r(c, c) / c ** 0.5).to(dtype), proj_bias=0.1 * r(c),
        ln2_scale=1 + 0.1 * r(c), ln2_bias=0.1 * r(c),
        fc1_weight=(r(f, c) / c ** 0.5).to(dtype), fc1_bias=0.1 * r(f),
        fc2_weight=(r(c, f) / f ** 0.5).to(dtype), fc2_bias=0.1 * r(c),
        bias_table=r(table, heads),
    )


def block_args(w):
    return (w["ln1_scale"], w["ln1_bias"], w["qkv_weight"], w["qkv_bias"],
            w["proj_weight"], w["proj_bias"], w["ln2_scale"], w["ln2_bias"],
            w["fc1_weight"], w["fc1_bias"], w["fc2_weight"], w["fc2_bias"],
            w["bias_table"])


def work(kind, shape, heads, dtype):
    """(FLOPs, bytes) that one call needs. FLOPs per real token: 24 C^2 +
    4 N C for the block, 8 C^2 + 4 N C for the attention (N = 64 keys per
    window); their backwards recompute the forward and run two products per
    forward product: 72 C^2 + 12 N C and 24 C^2 + 12 N C. Pad rows need no
    product: their LN output is zero, so their keys and values are
    qkv_bias, and their queries and outputs are cropped away. Bytes: x in
    and out (the backward: x and dy in, dx out) in the compute dtype, the
    weight matrices in the compute dtype, the float32 LN parameters, biases
    and the [343, heads] rel-pos table, each once; a backward also writes
    the float32 gradients of all of them once."""
    b, g0, g1, g2, c = shape
    tokens, n, e = b * g0 * g1 * g2, 64, torch.finfo(dtype).bits // 8
    block = kind.startswith("block")
    mats, vecs = (12 * c * c, 13 * c) if block else (4 * c * c, 4 * c)
    flops = tokens * ((24 if block else 8) * c * c + 4 * n * c)
    nbytes = 2 * tokens * c * e + e * mats + 4 * (vecs + 343 * heads)
    if kind.endswith("bwd"):
        flops = tokens * ((72 if block else 24) * c * c + 12 * n * c)
        nbytes += tokens * c * e + 4 * (mats + vecs + 343 * heads)
    return flops, nbytes


def bound(flops, nbytes, dtype):
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def ptxas_summary():
    """One line per compiled kernel from the build's `-Xptxas -v` output:
    registers, shared memory, stack and spills, names demangled by the
    toolkit's cu++filt where it is found."""
    entry = re.compile(r"Compiling entry function '(\S+)'")
    spill = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
    used = re.compile(r"Used (\d+) registers")
    smem = re.compile(r"(\d+) bytes smem")
    rows = []
    for lib, text in sorted(kernels.BUILD_LOG.items()):
        name = stack = None
        for line in text.splitlines():
            if m := entry.search(line):
                name, stack = m.group(1), None
            elif (m := spill.search(line)) and name:
                stack = m.groups()
            elif (m := used.search(line)) and name:
                sm = smem.search(line)
                rows.append((lib, name, m.group(1), sm.group(1) if sm else "0",
                             stack or ("?",) * 3))
                name = None
    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    names = [r[1] for r in rows]
    if filt and names:
        out = subprocess.run([filt], input="\n".join(names), capture_output=True,
                             text=True, timeout=60).stdout.splitlines()
        if len(out) == len(names):
            names = out
    if not rows:
        log("  no ptxas report: the libraries were built without their nvcc log")
    for (lib, _, regs, smem, (stack, st, ld)), name in zip(rows, names):
        log(f"  {lib}: {name[:110]}: {regs} registers, {smem} B static smem, "
            f"{stack} B stack, spills {st}/{ld} B (stores/loads)")


def phase_kernels(dev):
    """Both kernels against their plain versions at every (stage, shift)
    of the swin_b 160^3 forward, at batch 1, 2 and 8. Returns, per batch and
    kernel, sums over the 22 launches of one forward of the measured
    per-shape medians (each case weighted by its launches per forward)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    summary = {batch: {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, flops=0.0,
                               bytes=0.0, max_abs_err=0.0)
                       for k in ("block", "attention")}
               for batch in KERNEL_BATCHES}
    for batch in KERNEL_BATCHES:
        for (stage, shifted), weight in LAUNCHES_PER_FORWARD.items():
            g, c, heads = STAGES[stage]
            shape = (batch, g, g, g, c)
            shift = (2, 2, 2) if shifted else (0, 0, 0)
            w = block_weights(c, heads, gen, dev, torch.bfloat16)
            x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
            keep = torch.ones((batch, 2), device=dev)
            tag = f"stage{stage} {list(shape)} shift {shift}"
            attn = (x, w["qkv_weight"], w["qkv_bias"], w["proj_weight"],
                    w["proj_bias"], w["bias_table"], (4, 4, 4), shift, heads)
            runs = {
                "block": (
                    lambda: fused_swin_block(x, *block_args(w), keep, (4, 4, 4), shift, heads, 1e-5),
                    lambda: fused_swin_block_plain(x, *block_args(w), keep, (4, 4, 4), shift, heads, 1e-5)),
                "attention": (
                    lambda: fused_window_attention(*attn),
                    lambda: fused_window_attention_plain(*attn)),
            }
            for kind, (kernel_fn, plain_fn) in runs.items():
                got = kernel_fn()
                torch.cuda.synchronize()
                err = check_close(f"{kind} {tag} bf16", got, plain_fn(), torch.bfloat16)
                ms, plain_ms = time_ms(kernel_fn), time_ms(plain_fn)
                flops, nbytes = work(kind, shape, heads, torch.bfloat16)
                b_ms, b_by = bound(flops, nbytes, torch.bfloat16)
                log(f"  {kind} {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"bound {b_ms:.4f} ms ({b_by}), {flops / ms / 1e9:.1f} TFLOP/s")
                s = summary[batch][kind]
                s["ms"] += weight * ms
                s["plain_ms"] += weight * plain_ms
                s["bound_ms"] += weight * b_ms
                s["flops"] += weight * flops
                s["bytes"] += weight * nbytes
                s["max_abs_err"] = max(s["max_abs_err"], err)
            del x, w, got, attn, runs
            torch.cuda.empty_cache()

    # one small float32 case of each kernel (padded, shifted)
    w = block_weights(32, 4, gen, dev, torch.float32)
    x = torch.randn((1, 6, 6, 6, 32), generator=gen, device=dev)
    keep = torch.tensor([[1.25, 0.75]], device=dev)
    check_close("block f32 [1, 6, 6, 6, 32] shift (2, 2, 2), keep (1.25, 0.75)",
                fused_swin_block(x, *block_args(w), keep, (4, 4, 4), (2, 2, 2), 4, 1e-5),
                fused_swin_block_plain(x, *block_args(w), keep, (4, 4, 4), (2, 2, 2), 4, 1e-5),
                torch.float32)
    attn = (x, w["qkv_weight"], w["qkv_bias"], w["proj_weight"], w["proj_bias"],
            w["bias_table"], (4, 4, 4), (2, 2, 2), 4)
    check_close("attention f32 [1, 6, 6, 6, 32] shift (2, 2, 2)",
                fused_window_attention(*attn), fused_window_attention_plain(*attn),
                torch.float32)
    for batch, kinds in summary.items():
        for kind, s in kinds.items():
            s["bound_by"] = ("operations" if s["flops"] / PEAK_FLOPS[torch.bfloat16]
                             >= s["bytes"] / PEAK_BYTES else "bytes")
            log(f"  {kind} per batch-{batch} forward (sum of 22 measured medians): "
                f"kernel {s['ms']:.4f} ms, plain {s['plain_ms']:.4f} ms, bound "
                f"{s['bound_ms']:.4f} ms ({s['bound_by']}), "
                f"{100 * s['bound_ms'] / s['ms']:.2f}% of bound")
    return summary


def write_scenes(root: str, seed: int):
    """A synthetic scene of odd sizes 49-79 a side, from a numpy seed: rgb
    in [0, 1] and raw density (alpha after density_to_alpha ~half
    occupied)."""
    rs = np.random.RandomState(seed)
    os.makedirs(root)
    size = tuple(int(s) for s in rs.randint(24, 40, size=3) * 2 + 1)
    grid = np.empty(size + (4,), np.float32)
    grid[..., :3] = rs.rand(*size, 3)
    grid[..., 3] = rs.randn(*size) * 3
    np.savez(os.path.join(root, "scene0.npz"), rgbsigma=grid,
             bbox_min=np.zeros(3, np.float32), resolution=np.array(size))
    return root


def swin_b_cfg(**swin_kw):
    return MAEConfig(swin=dataclasses.replace(SWIN_PRESETS["swin_b"], **swin_kw),
                     resolution=RES, compute_dtype="bfloat16")


def synthetic_batch(dev, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    grids = torch.rand((1, RES, RES, RES, 4), generator=gen, device=dev)
    grids[..., 3] = (grids[..., 3] > 0.6).float() * grids[..., 3]
    return grids, gen


def forward_breakdown(model, grids, token_mask):
    """CUDA-event times (ms) of the parts of one forward, in order."""
    parts = {}

    def timed(name, fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        parts[name] = start.elapsed_time(end)
        return out

    x = timed("embed+mask", lambda: torch.where(
        token_mask[..., None], model.mask_token.to(model.cfg.dtype), model.embed(grids)))
    feats = []
    for s, stage in enumerate(model.stages):
        def run_stage(x=x, stage=stage):
            for layer in stage:
                x = layer(x)
            return x
        x = timed(f"stage{s}", run_stage)
        feats.append(x)
    d = timed("decoder4", lambda: model.decoder4(feats[3], feats[2]))
    d = timed("decoder3", lambda: model.decoder3(d, feats[1]))
    d = timed("decoder2", lambda: model.decoder2(d, feats[0]))
    timed("subpixel_head", lambda: model.subpixel_head(d))
    return parts


def phase_main_path(dev, tmp):
    """SERVE_REQUESTS requests through inference.main at swin_b 160^3, the
    first with --save_features."""
    per_scene = 22  # fused blocks per forward and per encode
    fused_swin_block.launches = 0
    fused_window_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    request_ms = []
    for r in range(SERVE_REQUESTS):
        scene_dir = write_scenes(os.path.join(tmp, f"request{r}"), seed=100 + r)
        save_features = r == 0
        before = fused_swin_block.launches
        t0 = time.perf_counter()
        results = inference.main([
            "--scene_dir", scene_dir, "--init_seed", "0", "--backbone_type", "swin_b",
            "--resolution", str(RES), "--out_dir", os.path.join(tmp, f"out{r}"),
            "--device", "cuda", "--seed", str(r),
            *(["--save_features"] if save_features else []),
        ])
        torch.cuda.synchronize()
        request_ms.append((time.perf_counter() - t0) * 1e3)
        launched = fused_swin_block.launches - before
        want = per_scene * len(results) * (2 if save_features else 1)
        log(f"  request {r}: {len(results)} scenes, {request_ms[-1]:.1f} ms "
            f"(scene ms {[round(x['ms'], 1) for x in results]}, of which forward + "
            f"loss + copy {[round(x['forward_ms'], 1) for x in results]}), losses "
            f"{[round(x['loss'], 5) for x in results]}, fused-block launches {launched}")
        if launched != want:
            raise AssertionError(f"fused-block launches {launched}, expected {want}")
        for res in results:
            finite = res["pred_finite"] and math.isfinite(res["loss"])
            if not finite or (save_features and not res["features_finite"]):
                raise AssertionError(f"non-finite output in request {r}: {res}")
    launches = {"block": fused_swin_block.launches,
                "attention": fused_window_attention.launches}
    if launches["block"] == 0:
        raise AssertionError("the main path never launched the fused-block kernel")
    log(f"  main path launches: {launches}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return launches, request_ms


@torch.no_grad()
def compare_with_plain(gelu: str, dev):
    """One batch-1 forward of swin_b 160^3 through the kernels and through
    the plain composition (same weights, same mask); returns the kernel
    launches of the kernel forward and the relative L2 error."""
    cfg = swin_b_cfg(gelu=gelu)
    model = init_weights(SwinMAE3D(cfg, device=dev), seed=1).eval()
    plain = SwinMAE3D(swin_b_cfg(gelu=gelu, attention_impl="plain"), device=dev).eval()
    plain.load_state_dict(model.state_dict())
    grids, gen = synthetic_batch(dev, seed=2)
    fused_swin_block.launches = 0
    fused_window_attention.launches = 0
    pred, token_mask = model(grids, generator=gen)
    torch.cuda.synchronize()
    launches = {"block": fused_swin_block.launches,
                "attention": fused_window_attention.launches}
    want, _ = plain(grids, token_mask=token_mask)
    _, rel_l2, _ = errors(pred, want)
    if not torch.isfinite(pred).all():
        raise AssertionError(f"non-finite prediction on the {gelu} path")
    return model, grids, token_mask, launches, rel_l2


GRAD_NAMES = {
    "block_bwd": ("dx", "dln1_scale", "dln1_bias", "dqkv_weight", "dqkv_bias",
                  "dproj_weight", "dproj_bias", "dln2_scale", "dln2_bias",
                  "dfc1_weight", "dfc1_bias", "dfc2_weight", "dfc2_bias",
                  "dbias_table"),
    "attention_bwd": ("dx", "dqkv_weight", "dqkv_bias", "dproj_weight",
                      "dproj_bias", "dbias_table"),
}


def check_grads(name, kind, got, want, dtype):
    """Every output of a backward kernel against its plain backward. Both
    round at the same points; in bf16 a float32 summation-order difference
    can move a value across a bf16 rounding boundary before it feeds the
    next product, and such flips accumulate down the chain: relative L2 <=
    1e-2 per gradient. float32: summation order only, relative L2 <= 1e-5.
    Returns the largest max-abs error over the outputs."""
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    worst, worst_name, max_abs = 0.0, "", 0.0
    for gname, g, w in zip(GRAD_NAMES[kind], got, want):
        g, w = g.float(), w.float()
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{name}: {gname} has the wrong shape or is not finite")
        rel = ((g - w).norm() / w.norm().clamp_min(1e-30)).item()
        max_abs = max(max_abs, (g - w).abs().max().item())
        if rel >= worst:
            worst, worst_name = rel, gname
    ok = worst <= tol
    log(f"  {name}: worst rel_l2 {worst:.3e} ({worst_name}; tol {tol:.0e}), "
        f"max_abs {max_abs:.3e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: backward kernel disagrees with its plain version")
    return max_abs


def train_keep(batch, dev):
    """Droppath factors of a train step (rate 0.1) with one dropped branch
    of each kind."""
    keep = torch.full((batch, 2), 1.0 / 0.9, device=dev)
    keep[1, 0] = 0.0
    keep[2, 1] = 0.0
    return keep


def phase_backward(dev):
    """Both backward kernels against their plain backwards at every (stage,
    shift) of the swin_b 160^3 train step at batch 8, bf16, with the
    weights as the model hands them over (float32 to the block, bf16 casts
    to the attention). Returns per kernel the sums over the 22 launches of
    one train step of the measured medians."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    summary = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, flops=0.0, bytes=0.0,
                       max_abs_err=0.0) for k in GRAD_NAMES}
    bf16 = torch.bfloat16
    for (stage, shifted), weight in LAUNCHES_PER_FORWARD.items():
        g, c, heads = STAGES[stage]
        shape = (TRAIN_BATCH, g, g, g, c)
        shift = (2, 2, 2) if shifted else (0, 0, 0)
        w = block_weights(c, heads, gen, dev, torch.float32)
        x = torch.randn(shape, generator=gen, device=dev).to(bf16)
        dy = torch.randn(shape, generator=gen, device=dev).to(bf16)
        keep = train_keep(TRAIN_BATCH, dev)
        tag = f"stage{stage} {list(shape)} shift {shift}"
        block = (x, *block_args(w), keep, dy, (4, 4, 4), shift, heads, 1e-5)
        attn = (x, w["qkv_weight"].to(bf16), w["qkv_bias"], w["proj_weight"].to(bf16),
                w["bias_table"], dy, (4, 4, 4), shift, heads)
        runs = {
            "block_bwd": (lambda: fused_swin_block_bwd(*block),
                          lambda: fused_swin_block_bwd_plain(*block)),
            "attention_bwd": (lambda: fused_window_attention_bwd(*attn),
                              lambda: fused_window_attention_bwd_plain(*attn)),
        }
        for kind, (kernel_fn, plain_fn) in runs.items():
            got = kernel_fn()
            torch.cuda.synchronize()
            err = check_grads(f"{kind} {tag} bf16", kind, got, plain_fn(), bf16)
            del got
            ms = time_ms(kernel_fn, reps=5, warmup=1)
            plain_ms = time_ms(plain_fn, reps=5, warmup=1)
            flops, nbytes = work(kind, shape, heads, bf16)
            b_ms, b_by = bound(flops, nbytes, bf16)
            log(f"  {kind} {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {b_ms:.4f} ms ({b_by}), {flops / ms / 1e9:.1f} TFLOP/s")
            s = summary[kind]
            s["ms"] += weight * ms
            s["plain_ms"] += weight * plain_ms
            s["bound_ms"] += weight * b_ms
            s["flops"] += weight * flops
            s["bytes"] += weight * nbytes
            s["max_abs_err"] = max(s["max_abs_err"], err)
        del x, dy, w, block, attn, runs
        torch.cuda.empty_cache()

    # one small float32 case of each (padded, shifted, a dropped branch)
    w = block_weights(32, 4, gen, dev, torch.float32)
    x = torch.randn((2, 6, 6, 6, 32), generator=gen, device=dev)
    dy = torch.randn((2, 6, 6, 6, 32), generator=gen, device=dev)
    keep = torch.tensor([[1.25, 0.0], [0.0, 1.25]], device=dev)
    block = (x, *block_args(w), keep, dy, (4, 4, 4), (2, 2, 2), 4, 1e-5)
    check_grads("block_bwd f32 [2, 6, 6, 6, 32] shift (2, 2, 2)", "block_bwd",
                fused_swin_block_bwd(*block), fused_swin_block_bwd_plain(*block),
                torch.float32)
    attn = (x, w["qkv_weight"], w["qkv_bias"], w["proj_weight"], w["bias_table"], dy,
            (4, 4, 4), (2, 2, 2), 4)
    check_grads("attention_bwd f32 [2, 6, 6, 6, 32] shift (2, 2, 2)", "attention_bwd",
                fused_window_attention_bwd(*attn),
                fused_window_attention_bwd_plain(*attn), torch.float32)
    phase_other_shapes(dev, gen)
    for kind, s in summary.items():
        s["bound_by"] = ("operations" if s["flops"] / PEAK_FLOPS[bf16]
                         >= s["bytes"] / PEAK_BYTES else "bytes")
        log(f"  {kind} per batch-{TRAIN_BATCH} train step (sum of 22 measured "
            f"medians): kernel {s['ms']:.4f} ms, plain {s['plain_ms']:.4f} ms, "
            f"bound {s['bound_ms']:.4f} ms ({s['bound_by']}), "
            f"{100 * s['bound_ms'] / s['ms']:.2f}% of bound")
    return summary


# bf16 shapes off the swin_b path (shape, heads, window, shift): 128-token
# windows and 128-wide heads run the general tensor-core attention, 64-wide
# heads the 64-token kernels at their widest, hd 12 the element-wise staging
OTHER_SHAPES = (
    ((2, 8, 8, 12, 64), 2, (4, 4, 8), (2, 2, 4)),
    ((2, 8, 8, 8, 256), 4, (4, 4, 8), (0, 0, 0)),
    ((2, 8, 8, 8, 256), 4, (4, 4, 4), (2, 2, 2)),
    ((2, 8, 8, 8, 512), 4, (4, 4, 4), (2, 2, 2)),
    ((2, 6, 6, 10, 48), 4, (4, 4, 8), (2, 2, 4)),
)


def phase_other_shapes(dev, gen):
    """Each kernel forward and backward against its plain version at
    OTHER_SHAPES (bf16, phase 3 and 6 tolerances), each backward called
    twice with bitwise equal results, and the CUDA-event medians of kernel
    and plain version."""
    bf16 = torch.bfloat16
    for shape, heads, window, shift in OTHER_SHAPES:
        c = shape[-1]
        w = block_weights(c, heads, gen, dev, torch.float32, window)
        x = torch.randn(shape, generator=gen, device=dev).to(bf16)
        dy = torch.randn(shape, generator=gen, device=dev).to(bf16)
        keep = torch.tensor([[1.25, 0.0], [0.0, 1.25]], device=dev)
        tag = f"{list(shape)} heads {heads} window {window} shift {shift} bf16"
        block = (x, *block_args(w), keep, window, shift, heads, 1e-5)
        attn = (x, w["qkv_weight"].to(bf16), w["qkv_bias"], w["proj_weight"].to(bf16),
                w["proj_bias"], w["bias_table"], window, shift, heads)
        block_b = (x, *block_args(w), keep, dy, window, shift, heads, 1e-5)
        attn_b = (*attn[:4], w["bias_table"], dy, window, shift, heads)
        for kind, fn, plain_fn, args in (
                ("block", fused_swin_block, fused_swin_block_plain, block),
                ("attention", fused_window_attention, fused_window_attention_plain, attn),
                ("block_bwd", fused_swin_block_bwd, fused_swin_block_bwd_plain, block_b),
                ("attention_bwd", fused_window_attention_bwd,
                 fused_window_attention_bwd_plain, attn_b)):
            first = fn(*args)
            if kind.endswith("bwd"):
                check_grads(f"{kind} {tag}", kind, first, plain_fn(*args), bf16)
                second = fn(*args)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(first, second)):
                    raise AssertionError(f"{kind} {tag}: two calls differ")
                del second
            else:
                check_close(f"{kind} {tag}", first, plain_fn(*args), bf16)
            del first
            ms = time_ms(lambda: fn(*args), reps=5, warmup=1)
            plain_ms = time_ms(lambda: plain_fn(*args), reps=5, warmup=1)
            log(f"  {kind} {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
                + (", two calls bitwise equal" if kind.endswith("bwd") else ""))
        del x, dy, w, block, attn, block_b, attn_b
        torch.cuda.empty_cache()


def reset_launches():
    for fn in (fused_swin_block, fused_swin_block_bwd, fused_window_attention,
               fused_window_attention_bwd):
        fn.launches = 0


def read_launches():
    return {"block": fused_swin_block.launches,
            "block_bwd": fused_swin_block_bwd.launches,
            "attention": fused_window_attention.launches,
            "attention_bwd": fused_window_attention_bwd.launches}


def phase_train(dev, tmp, smi):
    """The train main path through run_mae_pretrain.main: train, eval from
    the checkpoint, benchmark."""
    common = ["--dataset", "synthetic", "--backbone_type", "swin_b",
              "--resolution", str(RES), "--batch_size", str(TRAIN_BATCH),
              "--device", "cuda", "--n_synthetic", str(TRAIN_BATCH), "--seed", "0"]
    ckpt = os.path.join(tmp, "mae_ckpt")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = run_mae_pretrain.main([
        "--mode", "train", *common, "--steps", str(TRAIN_STEPS),
        "--checkpoint_dir", ckpt, "--log_interval", "1",
        "--eval_interval", "1000000", "--ckpt_interval", "1000000"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = read_launches()
    want = 22 * TRAIN_STEPS
    history = out["history"]
    log(f"  train: {TRAIN_STEPS} steps in {train_s:.1f} s (data included), losses "
        f"{[round(h['loss'], 5) for h in history]}, grad norms "
        f"{[round(h['grad_norm'], 4) for h in history]}, launches {launches}, peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if launches["block"] != want or launches["block_bwd"] != want:
        raise AssertionError(f"train launches {launches}, expected {want} fused-block "
                             "forward and backward")
    if len(history) != TRAIN_STEPS or not all(
            math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in history):
        raise AssertionError(f"train history not finite: {history}")
    agg = run_mae_pretrain.main(["--mode", "eval", *common, "--checkpoint", ckpt])
    log(f"  eval from the checkpoint: {agg}")
    if not agg or not all(math.isfinite(v) for v in agg.values()):
        raise AssertionError(f"eval from the checkpoint failed: {agg}")
    bench = run_mae_pretrain.main(["--mode", "benchmark", *common])
    log(f"  benchmark: {bench['step_ms']:.3f} ms/step (std {bench['step_ms_std']:.3f}), "
        f"{bench['value']:.4f} grids/s, MFU {bench['mfu']:.5f} (989 TFLOP/s bf16 "
        f"dense), peak memory {bench['peak_mem_gib']:.3f} GiB | {smi}")
    if not math.isfinite(bench["loss"]):
        raise AssertionError("benchmark loss not finite")
    return launches, bench


def step_breakdown(dev):
    """CUDA-event times (ms) of the parts of one swin_b 160^3 batch-8 train
    step on the device's timeline, medians of 5 steps after a warm-up:
    forward with the loss, backward, clip + AdamW; and the peak of allocated
    device memory within each part (GiB, last step), which says which part
    sets the step's peak."""
    cfg = swin_b_cfg()
    model = init_weights(SwinMAE3D(cfg, device=dev), seed=0)
    opt = optim.make_optimizer(model.parameters(), TrainConfig())
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    t = RES // 4
    grids = torch.rand((TRAIN_BATCH, t, t, t, 64, 4), generator=gen, device=dev)
    sizes = torch.full((TRAIN_BATCH, 3), RES, device=dev)
    parts = {"forward+loss": [], "backward": [], "clip+adamw": []}
    peaks = {}

    def part_peak(k):  # allocation is on the host, so no sync is needed
        peaks[k] = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()

    for rep in range(6):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.reset_peak_memory_stats()
        ev[0].record()
        pred, mask = model(grids, False, generator=gen, patched_pred=True,
                           droppath_generator=gen)
        loss, _ = mae_loss(pred, grids, mask, sizes, cfg)
        ev[1].record()
        part_peak("forward+loss")
        opt.zero_grad(set_to_none=True)
        loss.backward()
        ev[2].record()
        part_peak("backward")
        optim.clip_with_nonfinite_guard([p.grad for p in model.parameters()], 0.1)
        opt.step()
        ev[3].record()
        part_peak("clip+adamw")
        ev[3].synchronize()
        if rep:
            for i, k in enumerate(parts):
                parts[k].append(ev[i].elapsed_time(ev[i + 1]))
    del model, opt
    torch.cuda.empty_cache()
    return {k: statistics.median(v) for k, v in parts.items()}, peaks


def param_group(name: str) -> str:
    """patch_partition, mask_token, stages.{s}.merge / .blocks, decoder4,
    ..., subpixel_head."""
    parts = name.split(".")
    if parts[0] != "stages":
        return parts[0]
    return f"stages.{parts[1]}.{'merge' if parts[1] != '0' and parts[2] == '0' else 'blocks'}"


# Gradients of one train step (swin_b 160^3, batch 2) through the kernels
# and through the plain composition, from the same weights, mask and keep
# factors. float32: the two differ in summation order only; the loss agrees
# to ~1e-7 and the stage features to ~2e-6, but the backward through the
# random-weight decoder amplifies such differences, so the deepest groups
# (stage 3, decoder4, run by identical code on both paths) agree to ~4e-3
# on an H100: float32 is held to 1e-2 per group and 1e-4 on the loss. bf16:
# the kernels and the plain composition round at different points in each
# of the 24 blocks (q before or after its scale, GELU in float32 or bf16),
# so neither is the other's reference; both are held against the float32
# plain step, and the kernels' bf16 gradients may be no further from it
# than BF16_RATIO times the plain bf16 composition's, group by group.
F32_GRAD_TOL, F32_LOSS_TOL = 1e-2, 1e-4
BF16_RATIO, BF16_LOSS_TOL = 1.5, 1e-2


def train_step_grads(cfg, state, grids, sizes, token_mask):
    """One training forward and backward of a model built from `cfg` with
    the weights `state`; droppath from a fixed seed. Returns (loss, the
    kernels' launches, {name: gradient}, stage features)."""
    dev = grids.device
    model = SwinMAE3D(cfg, device=dev)
    model.load_state_dict(state)
    feats = []
    hook = model.stages.register_forward_hook(
        lambda mod, inp, out: feats.extend(o.detach().float() for o in out))
    dp = torch.Generator(device=dev)
    dp.manual_seed(7)
    reset_launches()
    pred, _ = model(grids, deterministic=False, token_mask=token_mask,
                    patched_pred=True, droppath_generator=dp)
    hook.remove()
    loss, _ = mae_loss(pred, grids, token_mask, sizes, cfg)
    loss.backward()
    torch.cuda.synchronize()
    launches = read_launches()
    grads = {}
    for name, prm in model.named_parameters():
        if prm.grad is None or not torch.isfinite(prm.grad).all():
            raise AssertionError(f"parameter {name} got no finite gradient")
        grads[name] = prm.grad.float()
    return loss.item(), launches, grads, feats


def group_rel(got, want):
    """Per-group relative L2 of two {name: gradient} dicts."""
    num, den = {}, {}
    for name, w in want.items():
        grp = param_group(name)
        num[grp] = num.get(grp, 0.0) + (got[name] - w).norm().item() ** 2
        den[grp] = den.get(grp, 0.0) + w.norm().item() ** 2
    return {g: math.sqrt(num[g] / max(den[g], 1e-30)) for g in num}


def phase_grads(dev, gelu):
    """The kernels' and the plain composition's gradients of one step, in
    float32 and in bf16. Returns the kernel steps' launches."""
    remat = {} if gelu == "tanh" else {"remat": False, "remat_stages": None}
    swin = dataclasses.replace(SWIN_PRESETS["swin_b"], gelu=gelu)
    cfgs = {(impl, dtype): MAEConfig(
                swin=dataclasses.replace(swin, attention_impl=impl), resolution=RES,
                compute_dtype=dtype, **remat)
            for impl in ("auto", "plain") for dtype in ("float32", "bfloat16")}
    state = init_weights(SwinMAE3D(cfgs["auto", "float32"], device=dev), seed=1).state_dict()
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    grids = torch.rand((2, RES, RES, RES, 4), generator=gen, device=dev)
    grids[..., 3] = (grids[..., 3] > 0.6).float() * grids[..., 3]
    sizes = torch.full((2, 3), RES, device=dev)
    cfg = cfgs["auto", "float32"]
    token_mask = block_mask_3d(gen, 2, cfg.token_grid, block=cfg.mask_block,
                               p_remove=cfg.masking_prob)
    runs = {key: train_step_grads(c, state, grids, sizes, token_mask)
            for key, c in cfgs.items()}
    want = "block" if gelu == "tanh" else "attention"
    for impl, dtype in runs:
        launches = runs[impl, dtype][1]
        if impl == "auto" and (launches[want], launches[want + "_bwd"]) != (22, 22):
            raise AssertionError(f"{gelu} {dtype} launches {launches}, expected 22 and 22")
    ref_loss, _, ref, ref_feats = runs["plain", "float32"]
    fmt = lambda d: ", ".join(f"{k} {v:.2e}" for k, v in d.items())
    failed = []

    loss, _, grads, feats = runs["auto", "float32"]
    rels = group_rel(grads, ref)
    loss_rel = abs(loss - ref_loss) / abs(ref_loss)
    log(f"  {gelu} float32, kernels vs plain: loss {loss:.6f} vs {ref_loss:.6f} (rel "
        f"{loss_rel:.2e}, tol {F32_LOSS_TOL:.0e}); stage features rel L2 "
        f"{[float(f'{(a - b).norm() / b.norm():.2e}') for a, b in zip(feats, ref_feats)]}; "
        f"gradients by group (tol {F32_GRAD_TOL:.0e}): {fmt(rels)}")
    if loss_rel > F32_LOSS_TOL or max(rels.values()) > F32_GRAD_TOL:
        failed.append("float32")

    loss_k, _, grads_k, feats_k = runs["auto", "bfloat16"]
    loss_p, _, grads_p, feats_p = runs["plain", "bfloat16"]
    rel_k, rel_p = group_rel(grads_k, ref), group_rel(grads_p, ref)
    ratio = {g: rel_k[g] / max(rel_p[g], 1e-30) for g in rel_k}
    loss_rel = abs(loss_k - ref_loss) / abs(ref_loss)
    log(f"  {gelu} bf16 vs the float32 plain step: loss kernels {loss_k:.6f} plain "
        f"{loss_p:.6f} (kernels rel {loss_rel:.2e}, tol {BF16_LOSS_TOL:.0e}); stage "
        f"features kernels vs plain rel L2 "
        f"{[float(f'{(a - b).norm() / b.norm():.2e}') for a, b in zip(feats_k, feats_p)]}; "
        f"gradients by group, kernels: {fmt(rel_k)}; plain: {fmt(rel_p)}; ratio (tol "
        f"{BF16_RATIO}): {fmt(ratio)}")
    if loss_rel > BF16_LOSS_TOL or max(ratio.values()) > BF16_RATIO:
        failed.append("bf16")
    launches = runs["auto", "bfloat16"][1]
    del runs, state
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"{gelu}: kernel gradients disagree ({failed})")
    return launches


def profile_device(fn):
    """torch.profiler (CPU and CUDA activities) around one fn() and a
    synchronize. Returns (rows, busy_ms, span_ms): rows of (device ms,
    launches, kernel name), sorted by time; the union of the device
    activities' intervals and the span from the first one's start to the
    last one's end (both 0 when the profiler recorded no device time)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return profile_summary(prof)


def profile_summary(prof):
    """profile_device's (rows, busy_ms, span_ms) of a finished profiler."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue  # CPU ops (aten::*) repeat their kernels' device time
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for start, stop in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return rows, busy / 1e3, (end - spans[0][0]) / 1e3 if spans else 0.0


def phase_profile(dev):
    """torch.profiler over one block forward and one block backward call at
    stage 0 and at stage 2, batch 8, unshifted (phase 6's shapes): device
    time per kernel name, sorted, with launch counts and the sum, as the
    sub-launch breakdown of each call."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    for stage in (0, 2):
        g, c, heads = STAGES[stage]
        shape = (TRAIN_BATCH, g, g, g, c)
        w = block_weights(c, heads, gen, dev, torch.float32)
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        dy = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        keep = train_keep(TRAIN_BATCH, dev)
        block = (x, *block_args(w), keep)
        calls = {
            "forward": lambda: fused_swin_block(*block, (4, 4, 4), (0, 0, 0), heads, 1e-5),
            "backward": lambda: fused_swin_block_bwd(*block, dy, (4, 4, 4), (0, 0, 0),
                                                     heads, 1e-5),
        }
        for what, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            rows, _, _ = profile_device(fn)
            extra_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
            total = sum(r[0] for r in rows)
            log(f"  block {what} stage{stage} {list(shape)}: {len(rows)} kernel names, "
                f"{sum(r[1] for r in rows)} launches, device time {total:.4f} ms, "
                f"memory allocated during the call {extra_gib:.4f} GiB (outputs and "
                "scratch)")
            if not rows:
                log("  torch.profiler recorded no device time for these kernels")
            for ms, count, key in rows:
                log(f"    {ms:9.4f} ms  {100 * ms / max(total, 1e-9):5.1f}%  x{count:<3d} {key[:120]}")
        del x, dy, w, block, calls
        torch.cuda.empty_cache()


def phase_swin_s_kernels(dev):
    """The fused block forward and backward against their plain versions at
    every (stage, shift) of the swin_s 160^3 forward and train step at batch
    8, bf16: the forward with the bf16 weight casts and the backward with
    the float32 parameters (as the model hands them over in training),
    droppath factors of a train step. Returns per kernel the sums over the
    22 launches of one step of the measured medians."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    bf16 = torch.bfloat16
    summary = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, flops=0.0, bytes=0.0,
                       max_abs_err=0.0) for k in ("block", "block_bwd")}
    for (stage, shifted), weight in LAUNCHES_PER_FORWARD.items():
        g, c, heads_ = SWIN_S_STAGES[stage]
        shape = (HEAD_BATCH, g, g, g, c)
        shift = (2, 2, 2) if shifted else (0, 0, 0)
        w = block_weights(c, heads_, gen, dev, torch.float32)
        wf = {k: v.to(bf16) if k in ("qkv_weight", "proj_weight", "fc1_weight",
                                     "fc2_weight") else v for k, v in w.items()}
        x = torch.randn(shape, generator=gen, device=dev).to(bf16)
        dy = torch.randn(shape, generator=gen, device=dev).to(bf16)
        keep = train_keep(HEAD_BATCH, dev)
        tag = f"swin_s stage{stage} {list(shape)} shift {shift} bf16"
        for kind, fn, plain_fn, args in (
                ("block", fused_swin_block, fused_swin_block_plain,
                 (x, *block_args(wf), keep, (4, 4, 4), shift, heads_, 1e-5)),
                ("block_bwd", fused_swin_block_bwd, fused_swin_block_bwd_plain,
                 (x, *block_args(w), keep, dy, (4, 4, 4), shift, heads_, 1e-5))):
            got = fn(*args)
            torch.cuda.synchronize()
            if kind == "block":
                err = check_close(f"{kind} {tag}", got, plain_fn(*args), bf16)
            else:
                err = check_grads(f"{kind} {tag}", kind, got, plain_fn(*args), bf16)
            del got
            ms = time_ms(lambda: fn(*args), reps=10, warmup=2)
            plain_ms = time_ms(lambda: plain_fn(*args), reps=5, warmup=1)
            flops, nbytes = work(kind, shape, heads_, bf16)
            b_ms, b_by = bound(flops, nbytes, bf16)
            log(f"  {kind} {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.2f}% of bound, "
                f"{flops / ms / 1e9:.1f} TFLOP/s")
            s = summary[kind]
            s["ms"] += weight * ms
            s["plain_ms"] += weight * plain_ms
            s["bound_ms"] += weight * b_ms
            s["flops"] += weight * flops
            s["bytes"] += weight * nbytes
            s["max_abs_err"] = max(s["max_abs_err"], err)
        del x, dy, w, wf
        torch.cuda.empty_cache()
    for kind, s in summary.items():
        log(f"  {kind} per swin_s batch-{HEAD_BATCH} step (sum of 22 measured medians): "
            f"kernel {s['ms']:.4f} ms, plain {s['plain_ms']:.4f} ms, bound "
            f"{s['bound_ms']:.4f} ms, {100 * s['bound_ms'] / s['ms']:.2f}% of bound")
    return summary


def swin_s_cfg(dtype="bfloat16", **swin_kw):
    return MAEConfig(swin=dataclasses.replace(SWIN_PRESETS["swin_s"], **swin_kw),
                     resolution=RES, compute_dtype=dtype)


def head_trainer(kind, cfg, dev, weights=None):
    if kind == "sr":
        return VoxelSRTrainer(cfg, TrainConfig(), 100, dev, out_resolution=SR_OUT[0])
    return VoxelSemanticsTrainer(cfg, TrainConfig(), 100, dev, num_classes=NUM_CLASSES,
                                 class_weights=weights)


def head_batch(kind, batch, dev, seed):
    """Random grids at 160^3 (about 40% occupied) with an SR target at
    256^3 or labels in [0, 19), on the card."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    grids = torch.rand((batch, RES, RES, RES, 4), generator=gen, device=dev)
    grids[..., 3] = (grids[..., 3] > 0.6).float() * grids[..., 3]
    if kind == "sr":
        r = SR_OUT[0]
        out = torch.rand((batch, r, r, r, 4), generator=gen, device=dev)
        out[..., 3] = (out[..., 3] > 0.6).float() * out[..., 3]
        return {"grids": grids, "out_grids": out}
    return {"grids": grids, "semantics": torch.randint(
        0, NUM_CLASSES, (batch, RES, RES, RES), generator=gen, device=dev)}


def timed_parts(names):
    """A recorder of the parts of a step on the device timeline. Returns
    (start, mark, finish, parts, peaks): start() opens a rep, mark(i)
    records event i and, past the first, the peak allocated memory since
    the previous mark (GiB, into peaks), finish(rep) waits for the last
    event and, from the second rep on, appends each part's time (ms) to
    parts."""
    parts = {k: [] for k in names}
    peaks = {}
    ev = []

    def start():
        ev[:] = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    def mark(i):
        ev[i].record()
        if i:
            peaks[names[i - 1]] = torch.cuda.max_memory_allocated() / 2**30
            torch.cuda.reset_peak_memory_stats()

    def finish(rep):
        ev[-1].synchronize()
        if rep:
            for i, k in enumerate(names):
                parts[k].append(ev[i].elapsed_time(ev[i + 1]))

    return start, mark, finish, parts, peaks


def head_step_breakdown(kind, trainer, state, batch):
    """CUDA-event times (ms) of the parts of one train step on the device
    timeline, medians of 3 steps after a warm-up: encoder1, the trunk with
    decoder4/3/2 (`base`), decoder1, the 1x1 head (with the SR resize), the
    loss, backward, clip + AdamW; and the peak of allocated device memory
    within each part (GiB, last step)."""
    model, cfg = state.model, trainer.mae_cfg
    model.train()
    start, mark, finish, parts, peaks = timed_parts(
        ("encoder1", "base", "decoder1", "head", "loss", "backward", "clip+adamw"))
    gen = torch.Generator(device=trainer.device)
    gen.manual_seed(21)
    for rep in range(4):
        start()
        mark(0)
        enc1 = heads.maybe_remat(cfg, model.encoder1, batch["grids"].to(cfg.dtype))
        mark(1)
        d = model.base(batch["grids"], False, gen)
        mark(2)
        d = heads.maybe_remat(cfg, model.decoder1, d, enc1)
        mark(3)
        out = model.head(d)
        mark(4)
        loss, _ = trainer._loss(out, batch)
        mark(5)
        del enc1, d, out
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        mark(6)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in model.parameters()]
        optim.clip_with_nonfinite_guard(grads, 0.1)
        state.optimizer.step()
        mark(7)
        finish(rep)
    return {k: statistics.median(v) for k, v in parts.items()}, peaks


def head_param_group(name: str) -> str:
    """base.<param_group of the MAE name>, encoder1, decoder1, voxel_out /
    sem_out."""
    if name.startswith("base."):
        return "base." + param_group(name[len("base."):])
    return name.split(".")[0]


def head_compare_with_plain(kind, dev, weights):
    """One batch-1 bf16 forward through the kernels against the plain
    composition (same weights; rel L2 <= 5e-2), and one batch-1 float32
    train step's gradients by group, kernels against plain (<= 1e-2), with
    22 fused-block forward and backward launches. Returns the float32
    kernel step's launches."""
    batch = head_batch(kind, 1, dev, seed=31)
    models = {}
    for dtype in ("bfloat16", "float32"):
        for impl in ("auto", "plain"):
            trainer = head_trainer(kind, swin_s_cfg(dtype, attention_impl=impl), dev, weights)
            models[dtype, impl] = trainer
    state = init_weights(models["float32", "auto"]._build_model(), seed=1).state_dict()

    def model_of(key):
        m = models[key]._build_model()
        m.load_state_dict(state)
        return m

    with torch.no_grad():
        reset_launches()
        got = model_of(("bfloat16", "auto")).eval()(batch["grids"])
        torch.cuda.synchronize()
        launches = read_launches()
        want = model_of(("bfloat16", "plain")).eval()(batch["grids"])
    _, rel, _ = errors(got, want)
    log(f"  {kind} batch-1 bf16 forward, kernels vs plain composition: rel_l2 {rel:.3e} "
        f"(tol 5e-2), output {list(got.shape)}, launches {launches}")
    if not torch.isfinite(got).all() or rel > 5e-2 or launches["block"] != 22:
        raise AssertionError(f"{kind}: the forward disagrees with the plain composition")
    del got, want

    grads, losses, f32_launches = {}, {}, None
    for impl in ("auto", "plain"):
        trainer = models["float32", impl]
        model = model_of(("float32", impl)).train()
        dp = torch.Generator(device=dev)
        dp.manual_seed(7)
        reset_launches()
        loss, _ = trainer._loss(model(batch["grids"], False, droppath_generator=dp), batch)
        loss.backward()
        torch.cuda.synchronize()
        if impl == "auto":
            f32_launches = read_launches()
        losses[impl] = loss.item()
        grads[impl] = {}
        for name, prm in model.named_parameters():
            if prm.grad is None or not torch.isfinite(prm.grad).all():
                raise AssertionError(f"{kind}: parameter {name} got no finite gradient")
            grads[impl][name] = prm.grad.float()
        del model, loss
    num, den = {}, {}
    for name, w in grads["plain"].items():
        grp = head_param_group(name)
        num[grp] = num.get(grp, 0.0) + (grads["auto"][name] - w).norm().item() ** 2
        den[grp] = den.get(grp, 0.0) + w.norm().item() ** 2
    rels = {g: math.sqrt(num[g] / max(den[g], 1e-30)) for g in num}
    loss_rel = abs(losses["auto"] - losses["plain"]) / abs(losses["plain"])
    log(f"  {kind} batch-1 float32 train step, kernels vs plain: loss {losses['auto']:.6f} "
        f"vs {losses['plain']:.6f} (rel {loss_rel:.2e}, tol {F32_LOSS_TOL:.0e}); launches "
        f"{f32_launches}; gradients by group (tol {F32_GRAD_TOL:.0e}): "
        + ", ".join(f"{k} {v:.2e}" for k, v in rels.items()))
    if (f32_launches["block"], f32_launches["block_bwd"]) != (22, 22):
        raise AssertionError(f"{kind} float32 launches {f32_launches}, expected 22 and 22")
    if loss_rel > F32_LOSS_TOL or max(rels.values()) > F32_GRAD_TOL:
        raise AssertionError(f"{kind}: float32 kernel gradients disagree with plain")
    del grads, state
    torch.cuda.empty_cache()
    return f32_launches


def write_mae_checkpoint(tmp):
    """run_mae_pretrain: swin_s 160^3, batch 8, 2 steps; the checkpoint dir."""
    ckpt = os.path.join(tmp, "mae_swin_s")
    reset_launches()
    out = run_mae_pretrain.main([
        "--mode", "train", "--dataset", "synthetic", "--backbone_type", "swin_s",
        "--resolution", str(RES), "--batch_size", str(HEAD_BATCH), "--device", "cuda",
        "--n_synthetic", str(HEAD_BATCH), "--steps", "2", "--checkpoint_dir", ckpt,
        "--log_interval", "1", "--eval_interval", "1000000", "--ckpt_interval", "1000000"])
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"  run_mae_pretrain swin_s: losses {[round(h['loss'], 5) for h in out['history']]}, "
        f"launches {launches}")
    if (launches["block"], launches["block_bwd"]) != (44, 44):
        raise AssertionError(f"swin_s pretraining launches {launches}, expected 44 and 44")
    return ckpt


def phase_head(kind, dev, tmp, smi, mae_ckpt):
    """The downstream main path through run_voxel_sr / run_voxel_semantics:
    train from the MAE checkpoint, eval from the head's checkpoint,
    benchmark; then the graft check, the step's parts with their peak
    memory and the comparisons with the plain composition. Returns
    (the train run's launches, the benchmarks, the breakdown)."""
    module = run_voxel_sr if kind == "sr" else run_voxel_semantics
    common = ["--dataset", "synthetic", "--backbone_type", "swin_s", "--resolution",
              str(RES), "--batch_size", str(HEAD_BATCH), "--device", "cuda",
              "--n_synthetic", str(HEAD_BATCH), "--seed", "0"]
    weights = None
    if kind == "sr":
        common += ["--out_resolution", str(SR_OUT[0])]
    else:
        labels = [s["semantics"] for s in run_voxel_semantics.synthetic_semantic_scenes(
            HEAD_BATCH, RES, NUM_CLASSES, 0)]
        weights = heads.calculate_class_weights(labels, NUM_CLASSES)
        path = os.path.join(tmp, "class_weights.npy")
        np.save(path, weights)
        log(f"  class weights from the synthetic labels: {np.round(weights, 4).tolist()}")
        common += ["--num_classes", str(NUM_CLASSES), "--class_weights", path]
    ckpt = os.path.join(tmp, f"{kind}_ckpt")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = module.main(["--mode", "train", *common, "--steps", str(HEAD_STEPS),
                       "--mae_checkpoint", mae_ckpt, "--checkpoint_dir", ckpt,
                       "--log_interval", "1", "--eval_interval", "1000000",
                       "--ckpt_interval", "1000000"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = read_launches()
    history = out["history"]
    log(f"  train: {HEAD_STEPS} steps in {train_s:.1f} s (data included), losses "
        f"{[round(h['loss'], 5) for h in history]}, grad norms "
        f"{[round(h['grad_norm'], 4) for h in history]}, grids/s with the host's batch "
        f"{[round(h['grids_per_sec'], 3) for h in history]}, launches {launches}, peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    want = 22 * HEAD_STEPS
    if (launches["block"], launches["block_bwd"]) != (want, want):
        raise AssertionError(f"{kind} train launches {launches}, expected {want} fused-block "
                             "forward and backward")
    if len(history) != HEAD_STEPS or not all(
            math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in history):
        raise AssertionError(f"{kind} train history not finite: {history}")
    agg = module.main(["--mode", "eval", *common, "--checkpoint", ckpt])
    log(f"  eval from the checkpoint: {agg}")
    if not agg or not all(math.isfinite(v) for v in agg.values()):
        raise AssertionError(f"{kind} eval from the checkpoint failed: {agg}")
    benches = []
    outs = SR_OUT if kind == "sr" else (RES,)
    for r in outs:
        extra = ["--out_resolution", str(r)] if kind == "sr" else []
        torch.cuda.empty_cache()
        bench = module.main(["--mode", "benchmark", *common, *extra])
        log(f"  benchmark {RES}^3 -> {r}^3: eval step {bench['ms']:.3f} ms (std "
            f"{bench['ms_std']:.3f}), {bench['grids_per_sec']:.4f} grids/s, peak memory "
            f"{bench['peak_mem_gib']:.3f} GiB | {smi}")
        if not math.isfinite(bench["loss"]):
            raise AssertionError(f"{kind} benchmark loss not finite")
        benches.append(bench)
    torch.cuda.empty_cache()

    cfg = swin_s_cfg()
    trainer = head_trainer(kind, cfg, dev, weights)
    mae_sd = load_mae_params(mae_ckpt, cfg)
    state = trainer.graft_mae(trainer.init(0), mae_sd)
    base = {k[len("base."):]: v for k, v in state.model.state_dict().items()
            if k.startswith("base.")}
    if set(base) != {k for k in mae_sd if k.split(".")[0] in heads.SR_TRUNK_KEYS} or not all(
            torch.equal(v, mae_sd[k].to(v.device)) for k, v in base.items()):
        raise AssertionError(f"{kind}: the grafted base differs from the MAE checkpoint")
    log(f"  graft: all {len(base)} base tensors equal the MAE checkpoint's")
    batch = head_batch(kind, HEAD_BATCH, dev, seed=23)
    parts, peaks = head_step_breakdown(kind, trainer, state, batch)
    step_ms = sum(parts.values())
    log(f"  train step at batch {HEAD_BATCH} (ms, device timeline): "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f"; total {step_ms:.3f} ({HEAD_BATCH / step_ms * 1e3:.3f} grids/s); peak memory "
        "per part (GiB): " + ", ".join(f"{k} {v:.4f}" for k, v in peaks.items()) + f" | {smi}")
    rows, busy_ms, span_ms = profile_device(lambda: trainer.train_step(state, batch))
    if not rows:
        log("  torch.profiler recorded no device time for the train step")
    else:
        total = sum(r[0] for r in rows)
        log(f"  one train step under torch.profiler: device busy {busy_ms:.3f} ms of the "
            f"{span_ms:.3f} ms from its first to its last device activity (idle share "
            f"{1 - busy_ms / span_ms:.4f}, profiler overhead included); device time by "
            f"kernel name, top 12 of {len(rows)}:")
        for ms, count, key in rows[:12]:
            log(f"    {ms:9.3f} ms  {100 * ms / total:5.1f}%  x{count:<4d} {key[:120]}")
    del trainer, state, batch, mae_sd, base
    torch.cuda.empty_cache()
    head_compare_with_plain(kind, dev, weights)
    return launches, benches, (parts, peaks)


# FCOS detection (phase 14): launch/train_fcos_pretrained.sh's flags
FCOS_STEPS = 4
FCOS_FLAGS = ("--rotated_bbox", "--iou_loss_type", "iou", "--center_sampling_radius", "1.5",
              "--lr", "1e-4", "--weight_decay", "1e-3", "--flip_prob", "0.5",
              "--rotate_prob", "0.5", "--rot_scale_prob", "0.5")
NMS_FLIP_TOL = 1e-5  # a suppress entry may flip between devices this close to the threshold
NMS_CPU_CLUSTER = 1500  # clustered candidates of the card-vs-CPU NMS case (seconds on the CPU)


def fcos_config(**kw) -> FCOSConfig:
    """The FCOSConfig run_fcos builds from FCOS_FLAGS (OBB, IoU loss, centre
    sampling 1.5, run_fcos's NMS defaults) at RES."""
    return FCOSConfig(**{**dict(resolution=RES, use_obb=True, iou_loss_type="iou",
                                center_sampling_radius=1.5), **kw})


def fcos_tower_flops(resolution, batch, width=256, num_convs=4, strides=(4, 8, 16, 32)):
    """FLOPs of one forward of the FCOS towers: 2 x num_convs 3^3 convs of
    width -> width over every level's grid (2 * 27 * width^2 per voxel), and
    the three output convs (1 + 8 + 1 channels)."""
    voxels = sum(math.ceil(resolution / s) ** 3 for s in strides) * batch
    return voxels * 2 * 27 * width * (2 * num_convs * width + 10)


def nms_flips(sup_a, sup_b, iou_of_pair, threshold):
    """Entries above the diagonal (all that the greedy scan reads) where two
    suppress matrices (the same boxes in the same order, built on two
    devices) disagree: (count, the largest |IoU - threshold| among them,
    from iou_of_pair(j, i), and the first candidate in visiting order whose
    keep such an entry can decide: the smallest i, or N without one). A flip
    is a rounding difference only when that distance is below NMS_FLIP_TOL."""
    sup_a = np.asarray(sup_a)
    j, i = np.nonzero(np.triu(sup_a != np.asarray(sup_b), k=1))
    worst = max((abs(float(iou_of_pair(a, b)) - threshold) for a, b in zip(j, i)), default=0.0)
    return len(j), worst, int(i.min()) if len(i) else sup_a.shape[0]


def clustered_candidates(gt_boxes, gt_valid, n, seed, jitter=0.25):
    """NMS candidates as a trained detector leaves them, clustered on the
    objects: n per scene, each a valid GT OBB of its scene jittered (centre
    by jitter x size per axis, sizes by exp(jitter x N(0, 1)), heading by
    jitter rad), scored higher the smaller its jitter. numpy gt_boxes [B, G,
    7], gt_valid [B, G] -> boxes [B, n, 7], scores [B, n] (float32)."""
    rs = np.random.RandomState(seed)
    boxes = np.zeros((gt_boxes.shape[0], n, 7), np.float32)
    scores = np.zeros((gt_boxes.shape[0], n), np.float32)
    for s, (gt, ok) in enumerate(zip(gt_boxes, gt_valid)):
        pick = gt[ok][rs.randint(0, int(ok.sum()), n)]
        z = rs.normal(0.0, 1.0, (n, 7))
        boxes[s, :, :3] = pick[:, :3] + jitter * z[:, :3] * pick[:, 3:6]
        boxes[s, :, 3:6] = pick[:, 3:6] * np.exp(jitter * z[:, 3:6])
        boxes[s, :, 6] = pick[:, 6] + jitter * z[:, 6]
        scores[s] = np.exp(-0.5 * (z ** 2).mean(1))
    return boxes, scores


def scan_rounds(suppress, valid):
    """The rounds nms.greedy_keep's fixed-point iteration takes on these
    inputs (the longest suppression chain plus one), counted by repeating
    it one round at a time."""
    s = torch.triu(suppress, diagonal=1).float()
    keep, rounds = valid, 0
    while True:
        rounds += 1
        prev, keep = keep, valid & ~((keep.float() @ s) > 0)
        if torch.equal(keep, prev):
            return rounds


def host_scan(suppress, valid):
    """The greedy scan on the host over the copied suppress matrix: the rows
    of kept boxes that suppress anything, in visiting order. Returns keep
    [N] bool (numpy)."""
    sup = suppress.cpu().numpy()
    keep = valid.cpu().numpy().copy()
    for j in np.flatnonzero(sup.any(1)):
        if keep[j]:
            keep &= ~sup[j]
    return keep


@torch.no_grad()
def nms_study(boxes, scores, valid, threshold):
    """The NMS of a batch of candidate sets (OBBs on the card), scene by
    scene, in its parts, each timed on the wall clock with a synchronize
    after it and summed over the scenes (ms, the second of two passes): the
    suppress matrix (nms.suppress_matrix), the greedy scan as nms.greedy_keep
    runs it on the device, and the same scan on the host over the copied
    matrix (host_scan). Also the share of candidate pairs whose extents
    overlap (the pairs whose rotated IoU is computed), the suppressing
    pairs, the fixed-point rounds per scene and the boxes kept (before
    post_nms_top_n). The two scans must agree."""
    out = {}
    for rep in range(2):
        t = {"matrix": 0.0, "device scan": 0.0, "host scan": 0.0}
        out = {"overlapping": 0, "pairs": 0, "suppressing": 0, "kept": 0, "rounds": []}
        for i in range(boxes.shape[0]):
            order = nms.sort_desc(torch.where(valid[i], scores[i],
                                              torch.full_like(scores[i], -math.inf)))
            bx, vd = boxes[i][order], valid[i][order]

            def timed(name, fn):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = fn()
                torch.cuda.synchronize()
                t[name] += (time.perf_counter() - t0) * 1e3
                return res

            sup = timed("matrix", lambda: nms.suppress_matrix(bx, threshold))
            keep = timed("device scan", lambda: nms.greedy_keep(sup, vd))
            want = timed("host scan", lambda: host_scan(sup, vd))
            if not np.array_equal(keep.cpu().numpy(), want):
                raise AssertionError("the device's greedy scan disagrees with the host's")
            if rep:
                n = bx.shape[0]
                rows = max(1, nms.PAIRS_PER_CHUNK // n)
                col = torch.arange(n, device=bx.device)
                out["overlapping"] += sum(
                    int((nms.extents_overlap(bx, slice(s, s + rows))
                         & (col[None] > col[s: s + rows, None])).sum())
                    for s in range(0, n, rows))
                out["pairs"] += n * (n - 1) // 2
                out["suppressing"] += int(sup.sum())
                out["kept"] += int(want.sum())
                out["rounds"].append(scan_rounds(sup, vd))
    return {**out, **t}


def pair_iou(boxes, j, i):
    """The IoU of boxes j and i of [N, 6] AABBs or [N, 7] OBBs."""
    if boxes.shape[-1] == 6:
        return box_iou_aabb(boxes[j: j + 1], boxes[i: i + 1])[0, 0]
    return iou_3d(boxes[j], boxes[i])


def nms_against_cpu(boxes, scores, valid, threshold, cap):
    """One scene's NMS (AABB or OBB candidates on the card) against the same
    function on the CPU from the same candidates: the suppress matrices may
    differ only where |IoU - threshold| < NMS_FLIP_TOL; each device's keep
    mask (nms.nms_mask) must be host_scan of its own matrix, capped at
    `cap`; and the kept sets must agree in visiting order up to the first
    candidate a differing entry can decide, so that every difference traces
    back to a flip. Returns the flips, the largest |IoU - threshold| among
    them, the suppressing pairs, the boxes kept on the card and on the CPU,
    the boxes kept by one only, and the CPU's seconds for its matrix."""
    order = nms.sort_desc(torch.where(valid, scores, torch.full_like(scores, -math.inf)))
    bx, vd = boxes[order], valid[order]
    bx_cpu = bx.cpu()
    t0 = time.perf_counter()
    sup_cpu = nms.suppress_matrix(bx_cpu, threshold)
    cpu_s = time.perf_counter() - t0
    sup_card = nms.suppress_matrix(bx, threshold)
    flips, worst, first = nms_flips(sup_card.cpu().numpy(), sup_cpu.numpy(),
                                    lambda j, i: pair_iou(bx_cpu, j, i), threshold)
    if worst >= NMS_FLIP_TOL:
        raise AssertionError(f"suppress matrices differ away from the threshold ({worst:.2e})")
    keep_card = nms.nms_mask(boxes, scores, threshold, valid, cap)[order].cpu().numpy()
    keep_cpu = nms.nms_mask(boxes.cpu(), scores.cpu(), threshold, valid.cpu(),
                            cap)[order.cpu()].numpy()
    for keep, sup in ((keep_card, sup_card), (keep_cpu, sup_cpu)):
        want = host_scan(sup, vd)
        if not np.array_equal(keep, want & (np.cumsum(want) <= cap)):
            raise AssertionError("an NMS keep mask is not the greedy scan of its suppress matrix")
    if not np.array_equal(keep_card[:first], keep_cpu[:first]):
        raise AssertionError("the kept sets differ before the first flipped suppress entry")
    return (flips, worst, int(sup_card.sum()), int(keep_card.sum()), int(keep_cpu.sum()),
            int((keep_card != keep_cpu).sum()), cpu_s)


def det_param_group(name: str) -> str:
    """body.<param_group of the trunk name>, body.fpn, and the head's
    modules without their index (head.cls_tower, head.box_gn, ...)."""
    parts = name.split(".")
    if parts[0] == "body" and parts[1] != "fpn":
        return "body." + param_group(".".join(parts[1:]))
    return f"{parts[0]}.{parts[1].rstrip('0123456789')}"


def det_batch(batch, dev, seed, obb=True):
    """A detection batch of synthetic scenes at RES (run_fcos's draw), as
    tensors on the card."""
    scenes = synthetic_detection_scenes(batch, RES, seed, obb=obb)
    host = next(detection_batch_iterator(scenes, batch, RES, shuffle=False))
    return {k: torch.from_numpy(v).to(dev) for k, v in host.items()}


def fcos_step_breakdown(trainer, state, batch):
    """CUDA-event times (ms) of the parts of one detection train step on the
    device timeline, medians of 3 steps after a warm-up: body (trunk + FPN),
    head (towers and output convs), targets + loss, backward, clip + AdamW;
    and the peak allocated memory within each part (GiB, last step)."""
    model, cfg = state.model, trainer.fcos
    model.train()
    start, mark, finish, parts, peaks = timed_parts(
        ("body", "head", "targets+loss", "backward", "clip+adamw"))
    gen = torch.Generator(device=trainer.device)
    gen.manual_seed(41)
    for rep in range(4):
        start()
        mark(0)
        feats = model.body(batch["grids"], False, gen)
        mark(1)
        outs = model.head(feats)
        mark(2)
        loss, _ = fcos_loss(cfg, *outs, batch["gt_boxes"], batch["gt_valid"], batch["sizes"])
        mark(3)
        del feats, outs
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        mark(4)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in model.parameters()]
        optim.clip_with_nonfinite_guard(grads, 0.1)
        state.optimizer.step()
        mark(5)
        finish(rep)
    return {k: statistics.median(v) for k, v in parts.items()}, peaks


@torch.no_grad()
def fcos_predict_breakdown(trainer, state, batch):
    """Wall-clock times (ms, each part closed by a synchronize; medians of 2
    after a warm-up) of one prediction step: body, head, the per-level top-k
    and decode (fcos_candidates), NMS and the final top-k (fcos_select); the
    peak memory per part (GiB); the last step's candidates (nms_study splits
    their NMS into its parts) and the detections kept."""
    model, cfg = state.model, trainer.fcos
    model.eval()
    names = ("body", "head", "top-k+decode", "nms+final top-k")
    parts = {k: [] for k in names}
    peaks = {}
    for rep in range(3):
        def timed(name, fn):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            if rep:
                parts[name].append((time.perf_counter() - t0) * 1e3)
            peaks[name] = max(peaks.get(name, 0.0), torch.cuda.max_memory_allocated() / 2**30)
            return out

        feats = timed("body", lambda: model.body(batch["grids"]))
        outs = timed("head", lambda: model.head(feats))
        cand = timed("top-k+decode", lambda: fcos_candidates(cfg, *outs, batch["sizes"]))
        det = timed("nms+final top-k", lambda: fcos_select(cfg, cand))
    return ({k: statistics.median(v) for k, v in parts.items()}, peaks, cand,
            int(det["valid"].sum()))


def fcos_compare_with_plain(dev, mae_sd):
    """Batch 1 (swin_s, 160^3, OBB, the MAE trunk grafted): the detector's
    bf16 outputs (every level's logits, regression and centerness) through
    the kernels against the plain composition (rel L2 <= 5e-2, 22 fused-block
    launches); one float32 train step's gradients by group, kernels against
    plain (<= 1e-2, loss 1e-4, 22 + 22 launches); and the post-processing of
    the kernel run's head outputs on the card against the same function on
    the CPU: candidate scores to rtol 1e-5, then the same candidates' NMS
    (nms_against_cpu), then the final detections (equal, scores to rtol
    1e-5, where the keep masks agree); and nms_against_cpu again on
    NMS_CPU_CLUSTER candidates clustered on the scene's boxes, where
    suppression decides what is kept."""
    swin = SWIN_PRESETS["swin_s"]
    cfg = fcos_config()
    batch = det_batch(1, dev, seed=43)
    state = None
    outs = {}
    for dtype in ("bfloat16", "float32"):
        for impl in ("auto", "plain"):
            model = FCOSDetector(dataclasses.replace(swin, attention_impl=impl), cfg,
                                 "swin_s", dtype=getattr(torch, dtype), device=dev)
            if state is None:
                model.init_weights(1)
                sd = model.state_dict()
                sd.update({f"body.{k}": v.to(dev) for k, v in extract_trunk(mae_sd).items()})
                state = sd
            model.load_state_dict(state)
            reset_launches()
            if dtype == "bfloat16":
                with torch.no_grad():
                    outs[impl] = model.eval().head(model.body(batch["grids"]))
                torch.cuda.synchronize()
                launches = read_launches()
                if impl == "auto" and launches["block"] != 22:
                    raise AssertionError(f"FCOS batch-1 forward launches {launches}")
                continue
            dp = torch.Generator(device=dev)
            dp.manual_seed(7)
            model.train()
            loss, _ = model(batch["grids"], batch["sizes"], batch["gt_boxes"], batch["gt_valid"],
                            deterministic=False, training=True, droppath_generator=dp)
            loss.backward()
            torch.cuda.synchronize()
            launches = read_launches()
            if impl == "auto" and (launches["block"], launches["block_bwd"]) != (22, 22):
                raise AssertionError(f"FCOS float32 step launches {launches}, expected 22 + 22")
            outs["f32", impl] = (loss.item(), {
                n: p.grad.float() for n, p in model.named_parameters()
                if p.grad is not None and torch.isfinite(p.grad).all()})
            if len(outs["f32", impl][1]) != len(list(model.parameters())):
                raise AssertionError(f"FCOS {impl}: a parameter got no finite gradient")
            del model, loss
    rels = []
    for name, got_l, want_l in zip(("logits", "bbox", "centerness"), outs["auto"], outs["plain"]):
        for lvl, (g, w) in enumerate(zip(got_l, want_l)):
            _, rel, _ = errors(g, w)
            if not torch.isfinite(g).all() or rel > 5e-2:
                raise AssertionError(f"FCOS {name} level {lvl}: rel L2 {rel:.3e} against plain")
            rels.append(f"{name}{lvl} {rel:.2e}")
    log("  FCOS batch-1 bf16 outputs, kernels vs plain composition (rel L2, tol 5e-2): "
        + ", ".join(rels))
    (loss_k, grads_k), (loss_p, grads_p) = outs["f32", "auto"], outs["f32", "plain"]
    num, den = {}, {}
    for name, w in grads_p.items():
        grp = det_param_group(name)
        num[grp] = num.get(grp, 0.0) + (grads_k[name] - w).norm().item() ** 2
        den[grp] = den.get(grp, 0.0) + w.norm().item() ** 2
    grel = {g: math.sqrt(num[g] / max(den[g], 1e-30)) for g in num}
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    log(f"  FCOS batch-1 float32 train step, kernels vs plain: loss {loss_k:.6f} vs "
        f"{loss_p:.6f} (rel {loss_rel:.2e}, tol {F32_LOSS_TOL:.0e}); gradients by group (tol "
        f"{F32_GRAD_TOL:.0e}): " + ", ".join(f"{k} {v:.2e}" for k, v in grel.items()))
    if loss_rel > F32_LOSS_TOL or max(grel.values()) > F32_GRAD_TOL:
        raise AssertionError("FCOS float32 kernel gradients disagree with plain")
    del outs["f32", "auto"], outs["f32", "plain"], grads_k, grads_p

    # the post-processing on the card against the same function on the CPU
    heads_card = outs["auto"]
    heads_cpu = [[x.cpu() for x in xs] for xs in heads_card]
    cand = fcos_candidates(cfg, *heads_card, batch["sizes"])
    cand_cpu = fcos_candidates(cfg, *heads_cpu, batch["sizes"].cpu())
    sc, sc_cpu = (c["scores"][c["valid"]].sort(descending=True).values.cpu()
                  for c in (cand, cand_cpu))
    if sc.shape != sc_cpu.shape or not torch.allclose(sc, sc_cpu, rtol=1e-5, atol=0):
        raise AssertionError("FCOS candidate scores differ between the card and the CPU")
    same = {k: v.cpu() for k, v in cand.items()}  # the card's candidates, on the CPU
    gt, gv = batch["gt_boxes"].cpu().numpy(), batch["gt_valid"].cpu().numpy()
    cb, cs = clustered_candidates(gt, gv, NMS_CPU_CLUSTER, seed=48)
    cases = {
        "random-weight head outputs": (cand["boxes"][0], cand["scores"][0], cand["valid"][0]),
        f"{NMS_CPU_CLUSTER} candidates clustered on the boxes": (
            torch.from_numpy(cb[0]).to(dev), torch.from_numpy(cs[0]).to(dev),
            torch.from_numpy(np.arange(NMS_CPU_CLUSTER) % 7 != 3).to(dev)),
    }
    diffs = []
    for name, (bx, sc_, vd) in cases.items():
        flips, worst, supp, n_card, n_cpu, diff, cpu_s = nms_against_cpu(
            bx, sc_, vd, cfg.nms_thresh, cfg.post_nms_top_n)
        diffs.append(diff)
        log(f"  FCOS NMS, card vs CPU, {name}: {int(vd.sum())} candidates, {supp} suppressing "
            f"pairs; suppress entries that differ {flips} (largest |IoU - {cfg.nms_thresh}| "
            f"{worst:.2e}, tol {NMS_FLIP_TOL:.0e}); kept {n_card} on the card, {n_cpu} on the "
            f"CPU (cap {cfg.post_nms_top_n}), {diff} kept by one only, each the greedy scan of "
            f"its own matrix (the CPU's matrix took {cpu_s:.1f} s)")
    if not 0 < n_card < int(vd.sum()) // 4:
        raise AssertionError(f"clustered NMS case: {n_card} kept; suppression decided nothing")
    keep_card, keep_cpu = fcos_select(cfg, cand), fcos_select(cfg, same)
    if diffs[0] == 0 and not (torch.equal(keep_card["valid"].cpu(), keep_cpu["valid"])
                              and torch.allclose(keep_card["scores"].cpu(), keep_cpu["scores"],
                                                 rtol=1e-5, atol=0)):
        raise AssertionError("FCOS detections differ between the card and the CPU")
    del heads_card, heads_cpu, outs, state
    torch.cuda.empty_cache()


def check_graft(trainer, mae_sd, what):
    """trainer.graft_mae on a fresh state: every trunk tensor of the body
    equals the MAE's, everything else is untouched. Returns the state."""
    state = trainer.init(0)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    trunk = {f"body.{k}": v for k, v in extract_trunk(mae_sd).items()}
    state = trainer.graft_mae(state, mae_sd)
    sd = state.model.state_dict()
    if not trunk or not all(torch.equal(sd[k], v.to(sd[k].device)) for k, v in trunk.items()) \
            or not all(torch.equal(v, before[k]) for k, v in sd.items() if k not in trunk):
        raise AssertionError(f"{what}: the grafted body differs from the MAE checkpoint's "
                             "trunk, or the graft touched the FPN or the head")
    log(f"  graft: all {len(trunk)} trunk tensors equal the MAE checkpoint's; the other "
        f"{len(sd) - len(trunk)} (FPN, head) are untouched")
    return state


def phase_fcos(dev, tmp, smi, mae_ckpt):
    """FCOS detection through run_fcos (OBB, swin_s 160^3, batch 8, the
    flags of launch/train_fcos_pretrained.sh): train from the MAE
    checkpoint, eval from the detector's checkpoint, benchmark (OBB and
    AABB); the graft check, the parts of a train step and of a prediction
    step with their peak memory, one step under torch.profiler, and the
    comparisons with the plain composition and the CPU."""
    common = ["--dataset", "synthetic", "--backbone_type", "swin_s", "--resolution", str(RES),
              "--batch_size", str(HEAD_BATCH), "--device", "cuda", "--n_synthetic",
              str(HEAD_BATCH), "--seed", "0"]
    ckpt = os.path.join(tmp, "fcos_ckpt")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = run_fcos.main(["--mode", "train", *common, *FCOS_FLAGS, "--steps", str(FCOS_STEPS),
                         "--mae_checkpoint", mae_ckpt, "--checkpoint_dir", ckpt,
                         "--log_interval", "1", "--eval_interval", "1000000",
                         "--ckpt_interval", "1000000"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = read_launches()
    history = out["history"]
    log(f"  train: {FCOS_STEPS} steps in {train_s:.1f} s (data included), losses "
        f"{[round(h['loss'], 5) for h in history]} (cls "
        f"{[round(h['loss_cls'], 4) for h in history]}, reg "
        f"{[round(h['loss_reg'], 4) for h in history]}, ctr "
        f"{[round(h['loss_centerness'], 4) for h in history]}), num_pos "
        f"{[int(h['num_pos']) for h in history]}, grad norms "
        f"{[round(h['grad_norm'], 4) for h in history]}, grids/s with the host's batch "
        f"{[round(h['grids_per_sec'], 3) for h in history]}, launches {launches}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    want = 22 * FCOS_STEPS
    if (launches["block"], launches["block_bwd"]) != (want, want):
        raise AssertionError(f"FCOS train launches {launches}, expected {want} fused-block "
                             "forward and backward")
    if len(history) != FCOS_STEPS or not all(
            math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) and h["num_pos"] > 0
            for h in history):
        raise AssertionError(f"FCOS train history not finite or without positives: {history}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    agg = run_fcos.main(["--mode", "eval", *common, *FCOS_FLAGS, "--checkpoint", ckpt])
    eval_ms = (time.perf_counter() - t0) * 1e3
    log(f"  eval from the checkpoint ({eval_ms:.1f} ms for the run_fcos call, model set-up "
        f"and data included): AP25 {agg.get('ap25')}, AP50 {agg.get('ap50')}, AP75 "
        f"{agg.get('ap75')}; " + ", ".join(f"{k} {v:.4f}" for k, v in agg.items()
                                            if k.startswith(("recall", "ar_"))))
    if not agg or not all(math.isfinite(v) and 0 <= v <= 1 for v in agg.values()):
        raise AssertionError(f"FCOS eval from the checkpoint failed: {agg}")
    benches = {}
    for kind, flags in (("obb", FCOS_FLAGS), ("aabb", FCOS_FLAGS[1:])):
        torch.cuda.empty_cache()
        bench = run_fcos.main(["--mode", "benchmark", *common, *flags])
        log(f"  benchmark {kind}: predict step {bench['ms']:.3f} ms (std {bench['ms_std']:.3f}), "
            f"{bench['grids_per_sec']:.4f} grids/s, peak memory {bench['peak_mem_gib']:.3f} GiB, "
            f"{bench['detections_per_scene']:.1f} detections per scene | {smi}")
        benches[kind] = bench
    torch.cuda.empty_cache()

    cfg = fcos_config()
    trainer = DetectionTrainer(SWIN_PRESETS["swin_s"], cfg, TrainConfig(), 100, dev)
    mae_sd = load_mae_params(mae_ckpt, swin_s_cfg())
    state = check_graft(trainer, mae_sd, "FCOS")
    batch = det_batch(HEAD_BATCH, dev, seed=45)
    parts, peaks = fcos_step_breakdown(trainer, state, batch)
    step_ms = sum(parts.values())
    tower = fcos_tower_flops(RES, HEAD_BATCH)
    log(f"  train step at batch {HEAD_BATCH} (ms, device timeline): "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f"; total {step_ms:.3f} ({HEAD_BATCH / step_ms * 1e3:.3f} grids/s); head towers "
        f"{tower / 1e12:.2f} TFLOP forward, {tower / parts['head'] / 1e9:.1f} TFLOP/s; peak "
        "memory per part (GiB): " + ", ".join(f"{k} {v:.4f}" for k, v in peaks.items())
        + f" | {smi}")
    rows, busy_ms, span_ms = profile_device(lambda: trainer.train_step(state, batch))
    if not rows:
        log("  torch.profiler recorded no device time for the train step")
    else:
        total = sum(r[0] for r in rows)
        log(f"  one train step under torch.profiler: device busy {busy_ms:.3f} ms of the "
            f"{span_ms:.3f} ms from its first to its last device activity (idle share "
            f"{1 - busy_ms / span_ms:.4f}, profiler overhead included); device time by "
            f"kernel name, top 12 of {len(rows)}:")
        for ms, count, key in rows[:12]:
            log(f"    {ms:9.3f} ms  {100 * ms / total:5.1f}%  x{count:<4d} {key[:120]}")
    pparts, ppeaks, cand, kept = fcos_predict_breakdown(trainer, state, batch)
    log(f"  prediction step at batch {HEAD_BATCH} (ms, wall clock with a synchronize per "
        "part): " + ", ".join(f"{k} {v:.3f}" for k, v in pparts.items())
        + f"; total {sum(pparts.values()):.3f}; {kept} detections; peak memory per part "
        "(GiB): " + ", ".join(f"{k} {v:.4f}" for k, v in ppeaks.items()) + f" | {smi}")
    gt, gv = batch["gt_boxes"].cpu().numpy(), batch["gt_valid"].cpu().numpy()
    cb, cs = clustered_candidates(gt, gv, cand["boxes"].shape[1], seed=46)
    for name, args in (("the random-weight prediction's candidates",
                        (cand["boxes"], cand["scores"], cand["valid"])),
                       ("as many candidates clustered on the scenes' boxes",
                        (torch.from_numpy(cb).to(dev), torch.from_numpy(cs).to(dev),
                         torch.ones(cs.shape, dtype=torch.bool, device=dev)))):
        st = nms_study(*args, cfg.nms_thresh)
        log(f"  NMS at batch {HEAD_BATCH}, {name}: {st['pairs'] // HEAD_BATCH} pairs a scene; "
            f"in the batch, extents overlap in {st['overlapping']} (share "
            f"{st['overlapping'] / st['pairs']:.6f}), {st['suppressing']} suppress, "
            f"{st['kept']} boxes kept (before the cap of {cfg.post_nms_top_n} a scene); "
            f"fixed-point rounds per scene {st['rounds']}; ms "
            f"per batch: suppress matrix {st['matrix']:.3f}, greedy scan on the device "
            f"{st['device scan']:.3f}, on the host over the copied matrix "
            f"{st['host scan']:.3f} | {smi}")
    del trainer, state, batch
    torch.cuda.empty_cache()
    fcos_compare_with_plain(dev, mae_sd)
    return launches, benches, parts


# The anchor RPN and the RCNN (phase 15): launch/train_rpn.sh's flags with
# run_rpn's defaults (AABB, head depth 2, smooth-L1, 2500 proposals, NMS
# 0.3, 64 GT), then run_rpn_detect's defaults (256 proposals a scene, 128
# RoIs, 5^3 RoI features) over that RPN. The RPN trains 40 steps: after 4,
# none of its 256 proposals a scene reached the RCNN's foreground IoU of 0.5
# on an H100, so the RCNN saw no positive; after 40, 2-6 a scene did.
RPN_STEPS = 40
RPN_FLAGS = ("--lr", "3e-4", "--weight_decay", "1e-3")
RCNN_STEPS = 4


def rpn_config(**kw) -> RPNConfig:
    """The RPNConfig run_rpn builds from RPN_FLAGS at RES."""
    return RPNConfig(**{**dict(resolution=RES, conv_depth=2), **kw})


def rpn_head_flops(resolution, batch, width=256, depth=2, anchors=13, delta_dim=6,
                   strides=(4, 8, 16, 32)):
    """FLOPs of one forward of the RPN head: `depth` 3^3 convs of width ->
    width and the 1^3 objectness and delta convs over every level's grid."""
    voxels = sum(math.ceil(resolution / s) ** 3 for s in strides) * batch
    return voxels * 2 * width * (depth * 27 * width + anchors * (1 + delta_dim))


def rcnn_head_flops(rois, size=5, width=256, depth=2, outputs=6 + 2):
    """FLOPs of one forward of the RCNN head over `rois` pooled RoIs:
    `depth` 3^3 convs of width -> width over size^3 and the dense layers."""
    return rois * size ** 3 * 2 * width * (depth * 27 * width + outputs)


def rpn_step_breakdown(trainer, state, batch):
    """CUDA-event times (ms) of the parts of one RPN train step on the
    device timeline, medians of 3 steps after a warm-up: body (trunk +
    FPN), head, assign + sample + loss, backward, clip + AdamW; and the
    peak allocated memory within each part (GiB, last step)."""
    model, cfg = state.model, trainer.rpn
    model.train()
    start, mark, finish, parts, peaks = timed_parts(
        ("body", "head", "assign+sample+loss", "backward", "clip+adamw"))
    gen = torch.Generator(device=trainer.device)
    gen.manual_seed(51)
    for rep in range(4):
        start()
        mark(0)
        feats = model.body(batch["grids"], False, gen)
        mark(1)
        obj, deltas = model.head_outputs(feats)
        mark(2)
        anchors, valid = model.anchors(batch["sizes"])
        obj_loss, reg_loss, _ = rpn_loss(cfg, obj, deltas, anchors, valid, batch["gt_boxes"],
                                         batch["gt_valid"], generator=gen)
        loss = obj_loss + cfg.reg_loss_weight * reg_loss
        mark(3)
        del feats, obj, deltas
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        mark(4)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in model.parameters()]
        optim.clip_with_nonfinite_guard(grads, 0.1)
        state.optimizer.step()
        mark(5)
        finish(rep)
    return {k: statistics.median(v) for k, v in parts.items()}, peaks


@torch.no_grad()
def rpn_predict_breakdown(trainer, state, batch):
    """Wall-clock times (ms, each part closed by a synchronize; medians of 2
    after a warm-up) of one RPN prediction step: body, head, the per-level
    top-k and decode (rpn_candidates), the NMS of every level and scene
    (rpn_level_nms), the final top-k (rpn_select); the peak memory per part
    (GiB) and the proposals kept."""
    model, cfg = state.model, trainer.rpn
    model.eval()
    names = ("body", "head", "top-k+decode", "per-level nms", "final top-k")
    parts = {k: [] for k in names}
    peaks = {}
    for rep in range(3):
        def timed(name, fn):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            if rep:
                parts[name].append((time.perf_counter() - t0) * 1e3)
            peaks[name] = max(peaks.get(name, 0.0), torch.cuda.max_memory_allocated() / 2**30)
            return out

        feats = timed("body", lambda: model.body(batch["grids"]))
        outs = timed("head", lambda: model.head_outputs(feats))
        anchors, valid = model.anchors(batch["sizes"])
        cands = timed("top-k+decode",
                      lambda: rpn_candidates(cfg, *outs, anchors, valid, batch["sizes"]))
        keeps = timed("per-level nms", lambda: rpn_level_nms(cfg, cands))
        det = timed("final top-k", lambda: rpn_select(cfg, cands, keeps))
    return ({k: statistics.median(v) for k, v in parts.items()}, peaks,
            int(det["valid"].sum()))


def rpn_compare_with_plain(dev, mae_sd):
    """Batch 1 (swin_s, 160^3, AABB, the MAE trunk grafted): the RPN's bf16
    head outputs (objectness, deltas) through the kernels against the plain
    composition (rel L2 <= 5e-2, 22 fused-block launches); one float32
    train step's gradients by group, kernels against plain (<= 1e-2, loss
    1e-4, 22 + 22 launches), the sampler's draws passed in; and the
    post-processing of the kernel run's head outputs on the card against
    the same function on the CPU: the candidates (scores to rtol 1e-5),
    each level's NMS (nms_against_cpu), then the proposals (equal, scores
    to rtol 1e-5, where no suppress entry flipped)."""
    swin, cfg = SWIN_PRESETS["swin_s"], rpn_config()
    batch = det_batch(1, dev, seed=53, obb=False)
    anchors, centers, _ = anchors_on(dev, *cfg.anchor_key())
    valid = anchor_padding_mask(centers, batch["sizes"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(54)
    draws = torch.rand((1, anchors.shape[0]), generator=gen, device=dev)
    state, outs = None, {}
    for dtype in ("bfloat16", "float32"):
        for impl in ("auto", "plain"):
            model = NeRFRPN(dataclasses.replace(swin, attention_impl=impl), cfg, "swin_s",
                            dtype=getattr(torch, dtype), device=dev)
            if state is None:
                model.init_weights(1)
                state = model.state_dict()
                state.update({f"body.{k}": v.to(dev) for k, v in extract_trunk(mae_sd).items()})
            model.load_state_dict(state)
            reset_launches()
            if dtype == "bfloat16":
                with torch.no_grad():
                    outs[impl] = model.eval().head_outputs(model.body(batch["grids"]))
                torch.cuda.synchronize()
                launches = read_launches()
                if impl == "auto" and launches["block"] != 22:
                    raise AssertionError(f"RPN batch-1 forward launches {launches}")
                continue
            dp = torch.Generator(device=dev)
            dp.manual_seed(7)
            model.train()
            loss, aux = model(batch["grids"], batch["sizes"], batch["gt_boxes"],
                              batch["gt_valid"], deterministic=False, training=True,
                              droppath_generator=dp, sample_draws=draws)
            loss.backward()
            torch.cuda.synchronize()
            launches = read_launches()
            if impl == "auto" and (launches["block"], launches["block_bwd"]) != (22, 22):
                raise AssertionError(f"RPN float32 step launches {launches}, expected 22 + 22")
            outs["f32", impl] = (loss.item(), int(aux["num_pos"]), {
                n: p.grad.float() for n, p in model.named_parameters()
                if p.grad is not None and torch.isfinite(p.grad).all()})
            if len(outs["f32", impl][2]) != len(list(model.parameters())):
                raise AssertionError(f"RPN {impl}: a parameter got no finite gradient")
            del model, loss
    rels = []
    for name, g, w in zip(("objectness", "deltas"), outs["auto"], outs["plain"]):
        _, rel, _ = errors(g, w)
        if not torch.isfinite(g).all() or rel > 5e-2:
            raise AssertionError(f"RPN {name}: rel L2 {rel:.3e} against plain")
        rels.append(f"{name} {rel:.2e}")
    log("  RPN batch-1 bf16 head outputs, kernels vs plain composition (rel L2, tol 5e-2): "
        + ", ".join(rels))
    (loss_k, pos_k, grads_k), (loss_p, pos_p, grads_p) = outs["f32", "auto"], outs["f32", "plain"]
    num, den = {}, {}
    for name, w in grads_p.items():
        grp = det_param_group(name)
        num[grp] = num.get(grp, 0.0) + (grads_k[name] - w).norm().item() ** 2
        den[grp] = den.get(grp, 0.0) + w.norm().item() ** 2
    grel = {g: math.sqrt(num[g] / max(den[g], 1e-30)) for g in num}
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    log(f"  RPN batch-1 float32 train step, kernels vs plain: loss {loss_k:.6f} vs {loss_p:.6f} "
        f"(rel {loss_rel:.2e}, tol {F32_LOSS_TOL:.0e}), positives {pos_k} and {pos_p}; "
        f"gradients by group (tol {F32_GRAD_TOL:.0e}): "
        + ", ".join(f"{k} {v:.2e}" for k, v in grel.items()))
    if loss_rel > F32_LOSS_TOL or max(grel.values()) > F32_GRAD_TOL or pos_k != pos_p:
        raise AssertionError("RPN float32 kernel gradients disagree with plain")
    del outs["f32", "auto"], outs["f32", "plain"], grads_k, grads_p

    # the post-processing on the card against the same function on the CPU
    obj, deltas = outs["auto"]
    args_cpu = (obj.cpu(), deltas.cpu(), anchors.cpu(), valid.cpu(), batch["sizes"].cpu())
    cands = rpn_candidates(cfg, obj, deltas, anchors, valid, batch["sizes"])
    cands_cpu = rpn_candidates(cfg, *args_cpu)
    for lvl, (c, cc) in enumerate(zip(cands, cands_cpu)):
        if not (torch.equal(c["valid"].cpu(), cc["valid"])
                and torch.allclose(c["scores"].cpu(), cc["scores"], rtol=1e-5, atol=0)
                and torch.allclose(c["boxes"].cpu(), cc["boxes"], rtol=1e-5, atol=1e-4)):
            raise AssertionError(f"RPN level {lvl} candidates differ between the card and the CPU")
    total_flips = 0
    for lvl, c in enumerate(cands):
        bx, sc, vd = c["boxes"][0], c["scores"][0], c["valid"][0]
        flips, worst, supp, n_card, n_cpu, diff, cpu_s = nms_against_cpu(
            bx, sc, vd, cfg.nms_thresh, bx.shape[0])
        total_flips += flips
        log(f"  RPN level {lvl} NMS, card vs CPU: {int(vd.sum())} candidates, {supp} "
            f"suppressing pairs; suppress entries that differ {flips} (largest |IoU - "
            f"{cfg.nms_thresh}| {worst:.2e}, tol {NMS_FLIP_TOL:.0e}); kept {n_card} on the card, "
            f"{n_cpu} on the CPU, {diff} kept by one only")
    det = rpn_filter_proposals(cfg, obj, deltas, anchors, valid, batch["sizes"])
    det_cpu = rpn_filter_proposals(cfg, *args_cpu)
    same = (torch.equal(det["valid"].cpu(), det_cpu["valid"])
            and torch.equal(det["levels"].cpu(), det_cpu["levels"])
            and torch.allclose(det["scores"].cpu(), det_cpu["scores"], rtol=1e-5, atol=0)
            and torch.allclose(det["boxes"].cpu(), det_cpu["boxes"], rtol=1e-5, atol=1e-4))
    log(f"  RPN proposals, card vs CPU: {int(det['valid'].sum())} on the card, "
        f"{int(det_cpu['valid'].sum())} on the CPU, "
        + ("equal" if same else "different (traced to the flips above)"))
    if total_flips == 0 and not same:
        raise AssertionError("RPN proposals differ between the card and the CPU")
    del outs, state
    torch.cuda.empty_cache()


def phase_rpn(dev, tmp, smi, mae_ckpt):
    """The anchor RPN through run_rpn (AABB, swin_s 160^3, batch 8,
    launch/train_rpn.sh's flags): train from the MAE checkpoint, eval from
    the RPN's checkpoint, benchmark prediction (AABB, and OBB with random
    weights); the graft check, the parts of a train step and of a
    prediction step with their peak memory, one step under torch.profiler,
    and the comparisons with the plain composition and the CPU. Returns
    the RPN's checkpoint dir."""
    common = ["--dataset", "synthetic", "--backbone_type", "swin_s", "--resolution", str(RES),
              "--batch_size", str(HEAD_BATCH), "--device", "cuda", "--n_synthetic",
              str(HEAD_BATCH), "--seed", "0"]
    ckpt = os.path.join(tmp, "rpn_ckpt")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = run_rpn.main(["--mode", "train", *common, *RPN_FLAGS, "--steps", str(RPN_STEPS),
                        "--mae_checkpoint", mae_ckpt, "--checkpoint_dir", ckpt,
                        "--log_interval", "1", "--eval_interval", "1000000",
                        "--ckpt_interval", "1000000"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = read_launches()
    history = out["history"]
    log(f"  train: {RPN_STEPS} steps in {train_s:.1f} s (data included), losses "
        f"{[round(h['loss'], 5) for h in history]} (objectness "
        f"{[round(h['loss_objectness'], 4) for h in history]}, reg "
        f"{[round(h['loss_reg'], 4) for h in history]}), num_pos "
        f"{[int(h['num_pos']) for h in history]}, grad norms "
        f"{[round(h['grad_norm'], 4) for h in history]}, grids/s with the host's batch "
        f"{[round(h['grids_per_sec'], 3) for h in history]}, launches {launches}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    want = 22 * RPN_STEPS
    if (launches["block"], launches["block_bwd"]) != (want, want):
        raise AssertionError(f"RPN train launches {launches}, expected {want} fused-block "
                             "forward and backward")
    if len(history) != RPN_STEPS or not all(
            math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) and h["num_pos"] > 0
            for h in history):
        raise AssertionError(f"RPN train history not finite or without positives: {history}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    agg = run_rpn.main(["--mode", "eval", *common, *RPN_FLAGS, "--checkpoint", ckpt])
    eval_ms = (time.perf_counter() - t0) * 1e3
    log(f"  eval from the checkpoint ({eval_ms:.1f} ms for the run_rpn call, model set-up and "
        f"data included): AP25 {agg.get('ap25')}, AP50 {agg.get('ap50')}, AP75 "
        f"{agg.get('ap75')}; " + ", ".join(f"{k} {v:.4f}" for k, v in agg.items()
                                            if k.startswith(("recall", "ar_"))))
    if not agg or not all(math.isfinite(v) and 0 <= v <= 1 for v in agg.values()):
        raise AssertionError(f"RPN eval from the checkpoint failed: {agg}")
    for kind, flags in (("aabb", RPN_FLAGS), ("obb", (*RPN_FLAGS, "--rotated_bbox"))):
        torch.cuda.empty_cache()
        bench = run_rpn.main(["--mode", "benchmark", *common, *flags])
        log(f"  benchmark {kind}: predict step {bench['ms']:.3f} ms (std {bench['ms_std']:.3f}), "
            f"{bench['grids_per_sec']:.4f} grids/s, peak memory {bench['peak_mem_gib']:.3f} GiB, "
            f"{bench['proposals_per_scene']:.1f} proposals per scene | {smi}")
    torch.cuda.empty_cache()

    trainer = RPNTrainer(SWIN_PRESETS["swin_s"], rpn_config(), TrainConfig(), 100, dev)
    mae_sd = load_mae_params(mae_ckpt, swin_s_cfg())
    state = check_graft(trainer, mae_sd, "RPN")
    batch = det_batch(HEAD_BATCH, dev, seed=55, obb=False)
    parts, peaks = rpn_step_breakdown(trainer, state, batch)
    step_ms = sum(parts.values())
    head = rpn_head_flops(RES, HEAD_BATCH)
    log(f"  train step at batch {HEAD_BATCH} (ms, device timeline): "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f"; total {step_ms:.3f} ({HEAD_BATCH / step_ms * 1e3:.3f} grids/s); head "
        f"{head / 1e12:.2f} TFLOP forward, {head / parts['head'] / 1e9:.1f} TFLOP/s; peak "
        "memory per part (GiB): " + ", ".join(f"{k} {v:.4f}" for k, v in peaks.items())
        + f" | {smi}")
    rows, busy_ms, span_ms = profile_device(lambda: trainer.train_step(state, batch))
    if not rows:
        log("  torch.profiler recorded no device time for the train step")
    else:
        total = sum(r[0] for r in rows)
        log(f"  one train step under torch.profiler: device busy {busy_ms:.3f} ms of the "
            f"{span_ms:.3f} ms from its first to its last device activity (idle share "
            f"{1 - busy_ms / span_ms:.4f}, profiler overhead included); device time by "
            f"kernel name, top 12 of {len(rows)}:")
        for ms, count, key in rows[:12]:
            log(f"    {ms:9.3f} ms  {100 * ms / total:5.1f}%  x{count:<4d} {key[:120]}")
    pparts, ppeaks, kept = rpn_predict_breakdown(trainer, state, batch)
    log(f"  prediction step at batch {HEAD_BATCH} (ms, wall clock with a synchronize per "
        "part): " + ", ".join(f"{k} {v:.3f}" for k, v in pparts.items())
        + f"; total {sum(pparts.values()):.3f}; {kept} proposals; peak memory per part "
        "(GiB): " + ", ".join(f"{k} {v:.4f}" for k, v in ppeaks.items()) + f" | {smi}")
    rows, busy_ms, span_ms = profile_device(lambda: trainer.predict_step(state, batch))
    if rows:
        log(f"  one prediction step under torch.profiler: device busy {busy_ms:.3f} ms of "
            f"{span_ms:.3f} ms (idle share {1 - busy_ms / span_ms:.4f}); top 6 of {len(rows)}: "
            + "; ".join(f"{ms:.3f} ms x{count} {key[:60]}" for ms, count, key in rows[:6]))
    del trainer, state, batch
    torch.cuda.empty_cache()
    rpn_compare_with_plain(dev, mae_sd)
    return ckpt


@torch.no_grad()
def foreground_proposals(det, batch, threshold):
    """Per scene, the valid AABB proposals whose best IoU with a valid GT
    box reaches `threshold`: the RoIs the RCNN can sample as foreground."""
    counts = []
    for bx, ok, gt, gv in zip(det["boxes"], det["valid"], batch["gt_boxes"], batch["gt_valid"]):
        iou = box_iou_aabb(bx[ok], gt[gv])
        counts.append(int((iou.amax(1) >= threshold).sum()) if iou.numel() else 0)
    return counts


def rcnn_step_breakdown(rpn_state, trainer, state, batch):
    """CUDA-event times (ms) of the parts of one RCNN train step on the
    device timeline, medians of 3 steps after a warm-up: the frozen body and
    the proposals, RoI sampling and align, the head's forward, the loss and
    backward, clip + AdamW; and the peak allocated memory within each part
    (GiB, last step)."""
    model, cfg = state.model, trainer.rcnn
    model.train()
    start, mark, finish, parts, peaks = timed_parts(
        ("body+proposals", "sampling+roi align", "head forward", "loss+backward", "clip+adamw"))
    gen = torch.Generator(device=trainer.device)
    gen.manual_seed(57)
    for rep in range(4):
        start()
        mark(0)
        feats, det = run_rpn_detect.features_and_proposals(rpn_state, batch)
        mark(1)
        rois, labels, matched, sel_valid = model.sample(det["boxes"], det["valid"],
                                                        batch["gt_boxes"], batch["gt_valid"],
                                                        generator=gen)
        pooled = model.pool(feats, rois)
        mark(2)
        deltas, scores = model.scores(pooled)
        mark(3)
        loss, _ = rcnn_loss(cfg, deltas, scores, rois, labels, matched, sel_valid)
        del feats, det, pooled
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        mark(4)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in model.parameters()]
        optim.clip_with_nonfinite_guard(grads, 0.1)
        state.optimizer.step()
        mark(5)
        finish(rep)
    return {k: statistics.median(v) for k, v in parts.items()}, peaks


def phase_rcnn(dev, tmp, smi, rpn_ckpt):
    """The RCNN second stage through run_rpn_detect over the phase's RPN
    (restored whole, head depth 2): train, eval from its checkpoint (AP at
    300), and the parts of a step with their peak memory."""
    common = ["--dataset", "synthetic", "--backbone_type", "swin_s", "--resolution", str(RES),
              "--batch_size", str(HEAD_BATCH), "--device", "cuda", "--n_synthetic",
              str(HEAD_BATCH), "--seed", "0", "--rpn_checkpoint", rpn_ckpt]
    ckpt = os.path.join(tmp, "rcnn_ckpt")
    args = run_rpn_detect.parse_args(common)
    rpn_state = run_rpn_detect.frozen_rpn(args, dev)
    batch = det_batch(HEAD_BATCH, dev, seed=0, obb=False)  # the training scenes
    _, det = run_rpn_detect.features_and_proposals(rpn_state, batch)
    log(f"  the frozen RPN's {args.proposals_per_scene} proposals a scene on the training "
        f"scenes: foreground (IoU >= {args.fg_threshold}) per scene "
        f"{foreground_proposals(det, batch, args.fg_threshold)}")
    del rpn_state, det
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = run_rpn_detect.main(["--mode", "train", *common, "--steps", str(RCNN_STEPS),
                               "--checkpoint_dir", ckpt, "--log_interval", "1",
                               "--ckpt_interval", "1000000"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = read_launches()
    history = out["history"]
    log(f"  train: {RCNN_STEPS} steps in {train_s:.1f} s (data included), losses "
        f"{[round(h['loss'], 5) for h in history]} (cls "
        f"{[round(h['loss_cls'], 4) for h in history]}, reg "
        f"{[round(h['loss_reg'], 4) for h in history]}), num_pos "
        f"{[int(h['num_pos']) for h in history]}, grad norms "
        f"{[round(h['grad_norm'], 4) for h in history]}, grids/s with the host's batch "
        f"{[round(h['grids_per_sec'], 3) for h in history]}, launches {launches}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if (launches["block"], launches["block_bwd"]) != (22 * RCNN_STEPS, 0):
        raise AssertionError(f"RCNN train launches {launches}, expected {22 * RCNN_STEPS} "
                             "fused-block forward and no backward (the body is frozen)")
    if len(history) != RCNN_STEPS or not all(
            math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in history) \
            or not any(h["num_pos"] > 0 for h in history):
        raise AssertionError(f"RCNN train history not finite or without positives: {history}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    agg = run_rpn_detect.main(["--mode", "eval", *common, "--checkpoint", ckpt])
    eval_ms = (time.perf_counter() - t0) * 1e3
    log(f"  eval from the checkpoint ({eval_ms:.1f} ms for the run_rpn_detect call, model "
        f"set-up and data included): " + ", ".join(f"{k} {v:.4f}" for k, v in agg.items()))
    if not agg or not all(math.isfinite(v) and 0 <= v <= 1 for v in agg.values()):
        raise AssertionError(f"RCNN eval from the checkpoint failed: {agg}")
    torch.cuda.empty_cache()

    rpn_state = run_rpn_detect.frozen_rpn(args, dev)
    trainer = RCNNTrainer(run_rpn_detect.rcnn_config(args), TrainConfig(), 100, dev)
    state = trainer.init(0)
    parts, peaks = rcnn_step_breakdown(rpn_state, trainer, state, batch)
    step_ms = sum(parts.values())
    rois = HEAD_BATCH * trainer.rcnn.rois_per_scene
    head = rcnn_head_flops(rois)
    log(f"  train step at batch {HEAD_BATCH}, {rois} RoIs (ms, device timeline): "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f"; total {step_ms:.3f} ({HEAD_BATCH / step_ms * 1e3:.3f} grids/s); head "
        f"{head / 1e12:.3f} TFLOP forward (float32), "
        f"{head / parts['head forward'] / 1e9:.1f} TFLOP/s; peak memory per part (GiB): "
        + ", ".join(f"{k} {v:.4f}" for k, v in peaks.items()) + f" | {smi}")
    del rpn_state, trainer, state, batch
    torch.cuda.empty_cache()


# The training feed (phase 16): run_mae_pretrain at swin_b 160^3, batch 8,
# fed from scenes on disk through four feeds
FEED_SCENES = 16
FEED_WARM = 2  # steps before the timed window (steps 3-8 are timed)
FEED_STEPS = 8  # steps whose losses are compared across the feeds
FEED_PROFILE = 3  # steps after those, under torch.profiler (idle share)
FEEDS = (
    ("inline", ("--prefetch", "0", "--workers", "0")),
    ("pipeline", ("--prefetch", "2", "--workers", "8")),
    ("device f32", ("--device_data",)),
    ("device bf16", ("--device_data", "--transfer_dtype", "bfloat16")),
)
BF16_FEED_REL = 2e-2  # bf16 targets and inputs: each loss within 2e-2 of inline's
ROTATE_SCALE_ATOL = 1.5e-4  # float32 (C++) against float64 (numpy) sample
# positions: ten float32 ulps at index 160 (the JAX test's 1e-5 is at 9^3)
HOST_WORKERS = (0, 4, 8)
# the e2e AP recipe (launch/e2e_synthetic_ap_torch.sh), cut for liveness
E2E = dict(res=96, backbone="swin_s", scenes=32, ft_scenes=12, val_scenes=8, mae_steps=60,
           det_steps=40)


def write_feed_scenes(root: str, seed: int, n: int = FEED_SCENES, lo: int = 64):
    """n synthetic scenes of odd sizes (2 * [lo, 80] - 1, up to 159 a side)
    as uncompressed npz, rgb in [0, 1] and raw density, from a numpy
    seed."""
    rs = np.random.RandomState(seed)
    os.makedirs(root)
    for i in range(n):
        size = tuple(int(s) for s in rs.randint(lo, 81, size=3) * 2 - 1)
        grid = np.empty(size + (4,), np.float32)
        grid[..., :3] = rs.rand(*size, 3)
        grid[..., 3] = rs.randn(*size) * 3
        np.savez(os.path.join(root, f"scene{i:02d}.npz"), rgbsigma=grid)
    return root


def feed_bytes_per_step(feed: str, batch: int, resolution: int) -> int:
    """Host-to-device bytes of one step's batch: the float32 (or bf16)
    grids and the int32 sizes of a host feed, the int64 index vector of a
    device feed (its corpus is uploaded once, before the first step)."""
    if feed.startswith("device"):
        return batch * 8
    itemsize = 2 if feed.endswith("bf16") else 4
    return batch * resolution ** 3 * 4 * itemsize + batch * 3 * 4


def feed_losses_agree(histories, rel=BF16_FEED_REL):
    """The feeds' per-step losses: the inline, pipeline and device f32
    lists bitwise equal, the device bf16 list finite and each loss within
    `rel` of inline's. Returns a list of the failures (empty: agreed)."""
    base = histories["inline"]
    failed = [f"{name} differs from inline" for name in ("pipeline", "device f32")
              if histories[name] != base]
    bf16 = histories["device bf16"]
    if len(bf16) != len(base) or not all(math.isfinite(x) for x in bf16):
        failed.append(f"device bf16 losses not finite: {bf16}")
    else:
        worst = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(bf16, base))
        if worst > rel:
            failed.append(f"device bf16 differs from inline by {worst:.3e} > {rel}")
    return failed


class FeedRecorder:
    """Stands in for run_mae_pretrain's MAETrainer during one feed's run:
    records every step's loss (a device tensor, read after the run), the
    host clock from a synchronize before step FEED_WARM + 1 to one after
    step FEED_STEPS, and torch.profiler over the FEED_PROFILE steps after
    those."""

    def __init__(self, base):
        self.base = base
        self.losses, self.t0, self.t1, self.prof = [], None, None, None

    def trainer(self, *args, **kw):
        rec = self
        from torch.profiler import ProfilerActivity, profile

        class Recorded(self.base):
            def train_step(self, state, batch, token_mask=None):
                step = state.step + 1
                if step == FEED_WARM + 1:
                    torch.cuda.synchronize()
                    rec.t0 = time.perf_counter()
                if step == FEED_STEPS + 1:
                    torch.cuda.synchronize()
                    rec.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                    rec.prof.start()
                state, m = super().train_step(state, batch, token_mask)
                rec.losses.append(m["loss"])
                if step == FEED_STEPS:
                    torch.cuda.synchronize()
                    rec.t1 = time.perf_counter()
                if step == FEED_STEPS + FEED_PROFILE:
                    torch.cuda.synchronize()
                    rec.prof.stop()
                return state, m

        return Recorded(*args, **kw)


def run_feed(name, flags, features, tmp):
    """run_mae_pretrain.main through one feed; its numbers and launches."""
    original = run_mae_pretrain.MAETrainer
    rec = FeedRecorder(original)
    steps = FEED_STEPS + FEED_PROFILE
    ckpt = os.path.join(tmp, "ckpt_" + name.replace(" ", "_"))
    run_mae_pretrain.MAETrainer = rec.trainer
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    try:
        run_mae_pretrain.main([
            "--mode", "train", "--dataset", "front3d", "--features_path", features,
            "--backbone_type", "swin_b", "--resolution", str(RES), "--batch_size",
            str(TRAIN_BATCH), "--steps", str(steps), "--device", "cuda", "--seed", "0",
            "--checkpoint_dir", ckpt, "--log_interval", str(steps),
            "--eval_interval", "1000000", "--ckpt_interval", "1000000", *flags])
    finally:
        run_mae_pretrain.MAETrainer = original
        shutil.rmtree(ckpt, ignore_errors=True)
    launches = read_launches()
    _, busy_ms, span_ms = profile_summary(rec.prof)
    timed = FEED_STEPS - FEED_WARM
    ms = (rec.t1 - rec.t0) * 1e3 / timed
    return {
        "losses": [float(x) for x in rec.losses],
        "ms": ms, "grids_per_sec": TRAIN_BATCH / (ms / 1e3),
        "idle_share": 1 - busy_ms / span_ms if span_ms else float("nan"),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "h2d_bytes": feed_bytes_per_step(name, TRAIN_BATCH, RES),
        "launches": launches, "steps": steps,
    }


def time_host_feed(features, workers, batches=1):
    """Seconds a batch of the host iterator alone takes (disk scenes,
    patch-major, batch 8) with `workers` threads."""
    ds = SceneDataset(features)
    it = mae_batch_iterator(ds, TRAIN_BATCH, RES, seed=0, workers=workers, patch_major=4)
    next(it)  # the library built, the page cache warm
    t0 = time.perf_counter()
    for _ in range(batches):
        next(it)
    it.close()
    return (time.perf_counter() - t0) / batches


def time_host_parts(features, scenes=3):
    """Median host ms a scene of the disk loader's parts, on `scenes`
    scenes: reading the npz (np.load, the copies to float32), density to
    alpha, and the native pad + patchify."""
    from nerf_mae_torch.data.datasets import density_to_alpha
    parts = {"read": [], "alpha": [], "pad_to_patches": []}
    for name in sorted(os.listdir(features))[:scenes]:
        t0 = time.perf_counter()
        with np.load(os.path.join(features, name)) as f:
            g = np.array(f["rgbsigma"]).astype(np.float32)
        t1 = time.perf_counter()
        g[..., -1] = density_to_alpha(g[..., -1])
        t2 = time.perf_counter()
        native.pad_to_patches(g, RES, 4)
        t3 = time.perf_counter()
        for key, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[key].append(dt * 1e3)
    return {k: statistics.median(v) for k, v in parts.items()}


def phase_feed(dev, smi, bench):
    """(a) the swin_b MAE main path fed from disk through four feeds,
    (b) the native collate against numpy at 160^3, (c) the e2e AP recipe
    cut for liveness."""
    if not native.available():
        raise AssertionError("the native collate did not build")
    with tempfile.TemporaryDirectory() as tmp:
        features = write_feed_scenes(os.path.join(tmp, "features"), seed=160)
        log(f"  {FEED_SCENES} scenes on disk (odd sizes up to 159^3, uncompressed npz); "
            f"host os.cpu_count() {os.cpu_count()}")
        host = {w: time_host_feed(features, w) for w in HOST_WORKERS}
        log("  host iterator alone (load + alpha + native pad + patchify of 8 scenes): "
            + ", ".join(f"workers {w}: {t * 1e3:.1f} ms/batch" for w, t in host.items())
            + "; one scene's parts (median ms): " + ", ".join(
                f"{k} {v:.1f}" for k, v in time_host_parts(features).items()))
        results = {}
        for name, flags in FEEDS:
            r = results[name] = run_feed(name, flags, features, tmp)
            want = 22 * r["steps"]
            log(f"  feed {name} ({' '.join(flags)}): {r['ms']:.3f} ms/step over steps "
                f"{FEED_WARM + 1}-{FEED_STEPS} ({r['grids_per_sec']:.3f} grids/s), idle share "
                f"{r['idle_share']:.4f} over steps {FEED_STEPS + 1}-{r['steps']}, peak "
                f"{r['peak_gib']:.3f} GiB, H->D {r['h2d_bytes']} bytes/step, launches "
                f"{r['launches']['block']} + {r['launches']['block_bwd']} "
                f"({r['launches']['block'] / r['steps']:.0f} + "
                f"{r['launches']['block_bwd'] / r['steps']:.0f} a step) | {smi}")
            if (r["launches"]["block"], r["launches"]["block_bwd"]) != (want, want):
                raise AssertionError(f"feed {name}: launches {r['launches']}, expected {want}")
        grids = FEED_SCENES * RES ** 3 * 4  # voxels x channels of the corpus
        log(f"  device corpus: {grids * 4 + FEED_SCENES * 12} bytes in float32, "
            f"{grids * 2 + FEED_SCENES * 12} with bf16 grids, uploaded once; resident-batch "
            f"benchmark (phase 7): {bench['step_ms']:.3f} ms/step, {bench['value']:.3f} "
            f"grids/s, peak {bench['peak_mem_gib']:.3f} GiB")
        histories = {name: r["losses"] for name, r in results.items()}
        log("  losses: " + "; ".join(f"{k} {[round(x, 6) for x in v[:FEED_STEPS]]}"
                                     for k, v in histories.items()))
        failed = feed_losses_agree(histories)
        if failed:
            raise AssertionError("feed losses disagree: " + "; ".join(failed))
        log(f"  losses of inline, pipeline and device f32 bitwise equal over "
            f"{len(histories['inline'])} steps; device bf16 within {BF16_FEED_REL}")
    phase_native()
    phase_e2e(dev)
    return results, host


def phase_native():
    """(b) every native function against its numpy version at 160^3."""
    rs = np.random.RandomState(7)
    g = rs.rand(RES - 3, RES - 17, RES - 9, 4).astype(np.float32)  # odd sizes below RES
    cases = {
        "pad_to_cube": (native.pad_to_cube(g, RES), np.pad(
            g, [(0, RES - s) for s in g.shape[:3]] + [(0, 0)])),
        "pad_to_patches": (native.pad_to_patches(g, RES, 4), patchify_np(
            native.pad_to_cube(g, RES)[None], 4)[0]),
        "flip_axis 0": (native.flip_axis(g, 0), np.flip(g, 0)),
        "flip_axis 1": (native.flip_axis(g, 1), np.flip(g, 1)),
        "rot90_wl": (native.rot90_wl(g), np.flip(np.swapaxes(g, 0, 1), 0)),
    }
    for name, (got, want) in cases.items():
        if not np.array_equal(got, want):
            raise AssertionError(f"native {name} differs from numpy")
    t0 = time.perf_counter()
    got = native.rotate_scale(g, 0.15, 1.05)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = rotate_and_scale_scene(g, None, 0.15, 1.05)[0]
    numpy_s = time.perf_counter() - t0
    err = float(np.abs(got - want).max())
    log(f"  native vs numpy at {list(g.shape)} -> {RES}^3: pad_to_cube, pad_to_patches, "
        f"flip_axis 0/1, rot90_wl equal; rotate_scale max abs {err:.3e} (tol "
        f"{ROTATE_SCALE_ATOL}: float32 against float64 positions), {native_s * 1e3:.1f} ms "
        f"native, {numpy_s * 1e3:.1f} ms numpy")
    if err > ROTATE_SCALE_ATOL:
        raise AssertionError(f"native rotate_scale differs from numpy by {err}")


def phase_e2e(dev):
    """(c) launch/e2e_synthetic_ap_torch.sh's stages in process, cut:
    --synthetic_hard --device_data --transfer_dtype bfloat16, the MAE traced
    to --profile_dir; both eval dicts finite, the trace written."""
    e = E2E
    with tempfile.TemporaryDirectory() as tmp:
        prof_dir = os.path.join(tmp, "profile")
        feed = ["--dataset", "synthetic", "--synthetic_hard", "--device_data",
                "--transfer_dtype", "bfloat16", "--backbone_type", e["backbone"],
                "--resolution", str(e["res"]), "--batch_size", "8", "--device", "cuda",
                "--eval_interval", "100000", "--ckpt_interval", "100000"]
        t0 = time.perf_counter()
        mae = run_mae_pretrain.main([
            "--mode", "train", *feed, "--n_synthetic", str(e["scenes"]), "--steps",
            str(e["mae_steps"]), "--lr", "1e-4", "--checkpoint_dir", os.path.join(tmp, "mae"),
            "--log_interval", "2", "--profile_dir", prof_dir])
        det = ["--n_synthetic", str(e["ft_scenes"]), "--seed", "77", "--steps",
               str(e["det_steps"]), "--lr", "3e-4", "--log_interval", "10"]
        run_fcos.main(["--mode", "train", *feed, *det, "--mae_checkpoint",
                       os.path.join(tmp, "mae"), "--checkpoint_dir", os.path.join(tmp, "fcos_mae")])
        run_fcos.main(["--mode", "train", *feed, *det,
                       "--checkpoint_dir", os.path.join(tmp, "fcos_scratch")])
        evals = {}
        for kind in ("mae", "scratch"):
            evals[kind] = run_fcos.main([
                "--mode", "eval", "--dataset", "synthetic", "--synthetic_hard",
                "--n_synthetic", str(e["ft_scenes"]), "--n_synthetic_val", str(e["val_scenes"]),
                "--seed", "77", "--backbone_type", e["backbone"], "--resolution",
                str(e["res"]), "--batch_size", "8", "--device", "cuda", "--checkpoint",
                os.path.join(tmp, f"fcos_{kind}")])
        traces = [os.path.join(prof_dir, f) for f in os.listdir(prof_dir)] if os.path.isdir(
            prof_dir) else []
        trace_mb = sum(os.path.getsize(f) for f in traces) / 2**20
        log(f"  e2e ({e}) in {time.perf_counter() - t0:.1f} s: MAE losses "
            f"{[round(h['loss'], 4) for h in mae['history'][::5]]}; trace {len(traces)} "
            f"file(s), {trace_mb:.1f} MiB; eval grafted {evals['mae']}; eval scratch "
            f"{evals['scratch']}")
        for kind, out in evals.items():
            if not out or not all(math.isfinite(v) for v in out.values()):
                raise AssertionError(f"e2e eval {kind} not finite: {out}")
        if not traces or trace_mb == 0:
            raise AssertionError("--profile_dir wrote no trace")


# L0 data production (phase 17): a NeRF trained per scene through run_nerf at
# the JAX defaults (8x256 MLP, 4096 rays, 64 + 64 samples, lr 5e-4, max_res
# 160), only --steps cut, on 96 views of 640x480 of a room of 4 boxes; the
# extracted grid handed to a swin_s FCOS step
L0_VIEWS = 96
L0_HW = (480, 640)
L0_RAYS, L0_SAMPLES, L0_IMPORTANCE, L0_RES = 4096, 64, 64, 160  # the JAX defaults
L0_FOV = 70.0
L0_STEPS = 400  # JAX's default is 20,000
L0_WARM = 20  # steps before the timed window
L0_TIMED = 360  # steps L0_WARM + 1 .. L0_WARM + L0_TIMED are timed
L0_PROFILE = 3  # steps after those, under torch.profiler (idle share)
L0_DG_STEPS = 60  # the depth-guided run (--task train)
L0_DG_WARM, L0_DG_TIMED = 10, 40
L0_CAM_DIM = 16
L0_CPU_RAYS = 256  # the card-vs-CPU step's rays (the CPU runs the same 8x256 step)
L0_CPU_VIEWS = 8  # views of the card-vs-CPU extraction
L0_CPU_RES = 16  # its max_res
L0_F32_FACTOR = 2.0  # the card's loss and gradients no further from float64 than 2x the CPU's
L0_EXTRACT_TOL = dict(rtol=1e-4, atol=1e-4)
L0_OBJECTS = (  # (position, extents) in raw world coordinates, z up
    ((9.0, -3.8, 0.8), (1.6, 1.6, 1.4)),
    ((12.0, -2.2, 0.7), (1.4, 1.4, 1.2)),
    ((10.0, -1.2, 0.6), (1.2, 1.0, 1.0)),
    ((11.6, -4.8, 0.9), (1.0, 1.3, 1.6)),
)
L0_COLORS = ((4.0, -4.0, -4.0), (-4.0, -4.0, 4.0), (-4.0, 4.0, -4.0), (4.0, 4.0, -4.0))


def nerf_point_macs(depth=8, width=256, skip_at=4, pos_freqs=10, dir_freqs=4, cam_dim=0):
    """Multiply-accumulates of one NeRFMLP forward at one point (591,488 at
    the defaults): the trunk, the density and feature heads, the colour
    head."""
    enc = 6 * pos_freqs
    d_in, macs = enc, 0
    for i in range(depth):
        macs += d_in * width
        d_in = width + enc if i == skip_at else width
    macs += d_in * (1 + width)
    return macs + (width + 6 * dir_freqs + cam_dim) * (width // 2) + (width // 2) * 3


def nerf_step_flops(rays, samples_per_ray, cam_dim=0):
    """A train step's FLOPs: every sample's forward (2 per MAC) and backward
    (twice the forward)."""
    return 3 * 2 * rays * samples_per_ray * nerf_point_macs(cam_dim=cam_dim)


def nerf_extract_flops(points, views, width=256):
    """The port's extraction: the trunk and color_fc's feature columns once a
    point, the per-view bias add, ReLU, rgb layer and sigmoid once a (point,
    view)."""
    trunk = nerf_point_macs() - (width + 24) * (width // 2) - (width // 2) * 3
    per_point = 2 * (trunk + width * (width // 2))
    per_view = 2 * (width // 2) * 3 + 2 * (width // 2) + 3 * 4
    return points * (per_point + views * per_view)


def look_at(eye, target, up=(0, 0, 1)):
    eye = np.asarray(eye, np.float64)
    f = eye - np.asarray(target, np.float64)
    f /= np.linalg.norm(f)
    r = np.cross(np.asarray(up, np.float64), f)
    r /= np.linalg.norm(r)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = r, np.cross(f, r), f, eye
    return c2w


def write_l0_scene(root, seed, views=L0_VIEWS, hw=L0_HW, dev="cuda"):
    """A scene as L0 users hold it: raw poses on two orbits around the
    objects and an HM3D box json, made into transforms.json by
    scripts/save_transforms.py (a subprocess: numpy only), then views
    rendered with the port's render_rays on `dev` from an analytic stand-in
    field (a solid coloured sphere in each carried box), written as 8-bit
    RGB PNGs with 16-bit millimetre depth maps (0 where the ray hits
    nothing). Returns (transforms dict, near, far)."""
    from nerf_mae_torch.nerf.images import write_png
    from nerf_mae_torch.nerf.render import get_rays, render_rays

    rs = np.random.RandomState(seed)
    pos = np.array([p for p, _ in L0_OBJECTS])
    mid = pos.mean(0)
    ang = np.linspace(0, 2 * np.pi, views, endpoint=False)
    height = np.where(np.arange(views) % 2, 1.5, 2.6) + 0.1 * rs.randn(views)
    eyes = np.stack([mid[0] + 4.4 * np.cos(ang), mid[1] + 4.4 * np.sin(ang), height], 1)
    os.makedirs(os.path.join(root, "poses"))
    for i, e in enumerate(eyes):
        with open(os.path.join(root, "poses", f"{i:03d}.json"), "w") as f:
            json.dump({"pose": look_at(e, mid).tolist()}, f)
    items = []
    for p, ext in L0_OBJECTS:  # the HM3D json is y-up
        lo, hi = np.asarray(p) - np.asarray(ext) / 2, np.asarray(p) + np.asarray(ext) / 2
        items.append({"class_name": "chair", "bbox": [lo[[0, 2, 1]].tolist(),
                                                      hi[[0, 2, 1]].tolist()]})
    boxes_json = os.path.join(root, "boxes.json")
    with open(boxes_json, "w") as f:
        json.dump(items, f)
    h, w = hw
    tpath = os.path.join(root, "transforms.json")
    subprocess.run([sys.executable, os.path.join(REPO, "scripts", "save_transforms.py"),
                    "--input_dir", root, "--boxes_json", boxes_json, "--output", tpath,
                    "--swap_yz", "--width", str(w), "--height", str(h), "--fov_x", str(L0_FOV)],
                   check=True, capture_output=True, timeout=300)
    with open(tpath) as f:
        tj = json.load(f)
    if len(tj["bounding_boxes"]) != len(L0_OBJECTS) or "room_bbox" not in tj:
        raise AssertionError(f"save_transforms carried {len(tj['bounding_boxes'])} boxes")

    blobs = [(torch.tensor(b["position"], dtype=torch.float32, device=dev),
              0.75 * min(b["extents"])) for b in tj["bounding_boxes"]]
    colors = [torch.tensor(c, device=dev) for c in L0_COLORS]

    def field(_params, pts, _vd):
        sigma = torch.zeros(pts.shape[:-1], device=dev)
        rgb = torch.zeros(pts.shape[:-1] + (3,), device=dev)
        for (c, r), col in zip(blobs, colors):
            inside = torch.linalg.norm(pts - c, dim=-1) < r
            sigma = torch.where(inside, 60.0, sigma)
            rgb = torch.where(inside[..., None], col, rgb)
        return rgb, sigma

    focal = 0.5 * w / np.tan(0.5 * tj["camera_angle_x"])
    poses = np.asarray([fr["transform_matrix"] for fr in tj["frames"]], np.float32)
    cam_d = np.linalg.norm(poses[:, :3, 3] - np.asarray(tj["bounding_boxes"][0]["position"]), axis=1)
    # tight [near, far] (tests/test_l0_pipeline.py: a loose far thins the
    # samples on the objects until the NeRF collapses to the empty scene)
    near, far = 0.05, float(cam_d.max() * 1.8)
    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "depth"))
    spread = []
    for fr, p in zip(tj["frames"], poses):
        o, d = get_rays(torch.from_numpy(p).to(dev), h, w, focal)
        with torch.no_grad():
            out = render_rays(None, field, o.reshape(-1, 3), d.reshape(-1, 3), near, far, 64)
        img = out["rgb"].reshape(h, w, 3).cpu().numpy()
        spread.append(float(img.std()))
        name = os.path.basename(fr["file_path"])
        write_png(os.path.join(root, fr["file_path"]), (img * 255).astype(np.uint8))
        depth_mm = torch.where(out["acc"] > 0.5, out["depth"] * 1000.0, 0.0)
        write_png(os.path.join(root, "depth", name),
                  depth_mm.reshape(h, w).round().clamp(0, 65535).cpu().numpy().astype(np.uint16))
    if min(spread) < 0.05:
        raise AssertionError(f"objects not visible in some views (std {min(spread):.4f})")
    return tj, near, far


class NeRFRecorder:
    """Stands in for run_nerf's NeRFTrainer during one run: every step's
    loss (a device scalar, read after the run), CUDA events around every
    train step, the host clock from a synchronize before step warm + 1 to
    one after step warm + timed, torch.profiler over the L0_PROFILE steps
    after those, and the peak memory at the last step."""

    def __init__(self, base, warm, timed, steps):
        self.base, self.warm, self.timed, self.steps = base, warm, timed, steps
        self.losses, self.events, self.t0, self.t1, self.prof, self.peak = [], [], 0, 0, None, 0

    def trainer(self, *args, **kw):
        rec = self
        from torch.profiler import ProfilerActivity, profile

        class Recorded(self.base):
            def train_step(self, *a, **k):
                step = len(rec.losses) + 1
                if step in (rec.warm + 1, rec.warm + rec.timed + 1):
                    torch.cuda.synchronize()
                    if step == rec.warm + 1:
                        rec.t0 = time.perf_counter()
                    else:
                        rec.t1 = time.perf_counter()
                        rec.prof = profile(activities=[ProfilerActivity.CPU,
                                                       ProfilerActivity.CUDA])
                        rec.prof.start()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                out = super().train_step(*a, **k)
                end.record()
                rec.events.append((start, end))
                rec.losses.append(out[2])
                if step == rec.warm + rec.timed + L0_PROFILE:
                    torch.cuda.synchronize()
                    rec.prof.stop()
                if step == rec.steps:
                    torch.cuda.synchronize()
                    rec.peak = torch.cuda.max_memory_allocated() / 2**30
                return out

        return Recorded(*args, **kw)

    def summary(self, flops):
        """Median event ms of the timed steps, host ms/step over them, the
        idle share under the profiler, and the rates of `flops` a step."""
        ms = [s.elapsed_time(e) for s, e in self.events[self.warm:self.warm + self.timed]]
        med = statistics.median(ms)
        rows, busy_ms, span_ms = profile_summary(self.prof)
        top = ", ".join(f"{name[:48]} {t / L0_PROFILE:.2f} ms ({100 * t / busy_ms:.0f}%)"
                        for t, _, name in rows[:6]) if busy_ms else "no device time"
        return {"median_ms": med, "host_ms": (self.t1 - self.t0) * 1e3 / self.timed,
                "idle_share": 1 - busy_ms / span_ms if span_ms else float("nan"),
                "tflops": flops / med / 1e9, "peak_gib": self.peak,
                "losses": [float(x) for x in self.losses], "top": top,
                "launches": sum(c for _, c, _ in rows) / L0_PROFILE}


def run_nerf_recorded(argv, warm, timed, steps):
    """run_nerf.main(argv) with its trainer recorded and its extraction
    timed (a synchronize at each end)."""
    original, extract = run_nerf.NeRFTrainer, run_nerf.extract_rgbsigma_grid
    rec = NeRFRecorder(original, warm, timed, steps)
    timing = {}

    def timed_extract(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = extract(*a, **k)
        torch.cuda.synchronize()
        timing["extract_ms"] = (time.perf_counter() - t0) * 1e3
        return out

    run_nerf.NeRFTrainer, run_nerf.extract_rgbsigma_grid = rec.trainer, timed_extract
    torch.cuda.reset_peak_memory_stats()
    try:
        result = run_nerf.main(argv)
    finally:
        run_nerf.NeRFTrainer, run_nerf.extract_rgbsigma_grid = original, extract
    return result, rec, timing


def density_on_boxes(grid, vboxes, scale):
    """tests/test_l0_pipeline.py's centroid check with its voxel distances
    times `scale` (its grid is 16): per box, the occupied voxels (relu(sigma)
    above half its max) near the box have their centroid within 2.5 *
    scale voxels of the box centre on every axis. Returns each box's
    largest axis distance."""
    sig = np.maximum(grid[..., 3], 0.0)
    if sig.max() <= 0:
        raise AssertionError("the NeRF reconstructed no positive density")
    occ = np.stack(np.nonzero(sig > sig.max() * 0.5), axis=1) + 0.5
    dist = []
    for i, b in enumerate(vboxes):
        d = np.linalg.norm(occ - b[:3], axis=1)
        near = occ[d < max(3.0 * scale, 0.75 * b[3:6].max())]
        if not len(near):
            raise AssertionError(f"no density near voxel box {i}")
        dist.append(float(np.abs(near.mean(0) - b[:3]).max()))
    if max(dist) > 2.5 * scale:
        raise AssertionError(f"voxel boxes off the density centroids: {dist}")
    return dist


def nerf_step_against_cpu(dev, state, images, poses, focal, near, far, scene_scale):
    """One hierarchical train step (8x256, 64 + 64 samples) from the trained
    weights `state`, with the same rays and draws, on the card (float32) and
    on the CPU (float32, and float64 as the reference). The loss and the
    gradients (Adam's first moments, 0.1 x them) are sensitive to rounding:
    the 1e10 last-sample delta makes alpha steep in a density near 0, and
    the loss is a sum of small residuals, so float32 on the CPU is itself
    measurably off float64 (the run prints both distances). So the card's
    loss and moments must be no further from float64 than L0_F32_FACTOR x
    the CPU float32's (relative; floor 1e-6), and the updated parameters within 2
    lr of the CPU's (an Adam step moves an entry by at most lr, and a
    near-zero gradient may flip its sign). Returns {name: (card, CPU)}
    distances from float64, and the params' max abs difference."""
    from nerf_mae_torch.nerf.train import NeRFTrainer

    kw = dict(near=near, far=far, n_samples=L0_SAMPLES, n_importance=L0_IMPORTANCE, lr=5e-4,
              ray_batch=L0_CPU_RAYS, scene_scale=scene_scale)
    cpu = NeRFTrainer(**kw, device="cpu")
    rays = cpu.upload_rays(images[:2], poses[:2], focal)
    sel = np.random.RandomState(5).randint(0, 2 * images.shape[1] * images.shape[2], L0_CPU_RAYS)
    batch = cpu.batch(rays, sel, images.shape[1] * images.shape[2])
    gen = torch.Generator().manual_seed(6)
    u = (torch.rand(L0_CPU_RAYS, L0_SAMPLES, generator=gen),
         torch.rand(L0_CPU_RAYS, L0_IMPORTANCE, generator=gen))
    out = {}
    for name, d, dtype in (("f64", "cpu", torch.float64), ("cpu", "cpu", torch.float32),
                           ("card", dev, torch.float32)):
        tr = NeRFTrainer(**kw, device=d)
        params, _ = tr.init(0, n_views=2)
        params.load_state_dict(state)
        params = params.to(dtype)
        opt = torch.optim.Adam(params.parameters(), lr=tr.lr, betas=(0.9, 0.999), eps=1e-8)
        cast = lambda x: x.to(tr.device, dtype if x.is_floating_point() else x.dtype)
        params, opt, loss, _ = tr.train_step(params, opt, *map(cast, batch),
                                             u=tuple(map(cast, u)))
        out[name] = (float(loss), {n: p.detach().cpu().double() for n, p in params.named_parameters()},
                     {n: opt.state[p]["exp_avg"].cpu().double()
                      for n, p in params.named_parameters()})
    (l64, _, mr), (lc, pc, mc), (lg, pg, mg) = out["f64"], out["cpu"], out["card"]
    dist = lambda m: max(float((m[n] - mr[n]).norm() / mr[n].norm().clamp_min(1e-30)) for n in mr)
    d = {"loss": (abs(lg - l64) / abs(l64), abs(lc - l64) / abs(l64)),
         "moments": (dist(mg), dist(mc))}
    param_err = max(float((pg[n] - pc[n]).abs().max()) for n in pc)
    far = [k for k, (card, cpu_) in d.items() if card > L0_F32_FACTOR * cpu_ + 1e-6]
    if far or param_err > 2 * 5e-4:
        raise AssertionError(f"NeRF step card vs CPU: distances from float64 (card, CPU) {d}, "
                             f"params {param_err:.3e}")
    return d, param_err


def phase_l0(dev, smi):
    """L0 data production: scene -> run_nerf (train + extract at the JAX
    defaults) -> the grid on the boxes -> the depth-guided step -> card
    against CPU -> preprocess_boxes -> two swin_s FCOS steps on the grid."""
    from nerf_mae_torch.nerf.extract import extract_rgbsigma_grid

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        scene = os.path.join(tmp, "scene0")
        tj, near, far = write_l0_scene(scene, seed=17, dev=dev)
        log(f"  scene: {L0_VIEWS} views of {L0_HW[1]}x{L0_HW[0]} rendered on the card and "
            f"written as PNG with 16-bit depth in {time.perf_counter() - t0:.1f} s; "
            f"{len(L0_OBJECTS)} boxes, near {near} far {far:.4f}, room_bbox {tj['room_bbox']}")
        feat, boxes = os.path.join(tmp, "features"), os.path.join(tmp, "boxes")
        flags = ["--scene_dir", scene, "--near", str(near), "--far", str(far),
                 "--ray_batch", str(L0_RAYS), "--n_samples", str(L0_SAMPLES), "--n_importance",
                 str(L0_IMPORTANCE), "--max_res", str(L0_RES), "--device", "cuda", "--seed", "0"]
        t0 = time.perf_counter()
        result, rec, timing = run_nerf_recorded(
            ["--task", "train_extract", "--ngp_frame", "--scene_id", "scene0", "--extract_dir",
             feat, "--steps", str(L0_STEPS), *flags], L0_WARM, L0_TIMED, L0_STEPS)
        run_s = time.perf_counter() - t0
        samples = L0_RAYS * (L0_SAMPLES + L0_SAMPLES + L0_IMPORTANCE)
        flops = nerf_step_flops(L0_RAYS, L0_SAMPLES + L0_SAMPLES + L0_IMPORTANCE)
        bound_ms = flops / PEAK_FLOPS[torch.float32] * 1e3
        s = rec.summary(flops)
        losses = s["losses"]
        first, last = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
        log(f"  run_nerf --task train_extract ({L0_STEPS} steps, 8x256, {L0_RAYS} rays, "
            f"{L0_SAMPLES} + {L0_IMPORTANCE} samples) in {run_s:.1f} s: loss {first:.5f} (steps 1-10) -> {last:.5f} (steps "
            f"{L0_STEPS - 9}-{L0_STEPS}), final PSNR {result['psnr']:.2f}")
        log(f"  hierarchical step: median {s['median_ms']:.3f} ms (CUDA events, steps "
            f"{L0_WARM + 1}-{L0_WARM + L0_TIMED}), host {s['host_ms']:.3f} ms/step, "
            f"{L0_RAYS / s['median_ms'] * 1e3:.0f} rays/s, {samples / s['median_ms'] * 1e3:.4g} "
            f"samples/s, {s['tflops']:.2f} TFLOP/s float32 ({flops / 1e12:.3f} TFLOP a step); "
            f"bound {bound_ms:.3f} ms (operations, 67 TFLOP/s), {100 * bound_ms / s['median_ms']:.1f}% "
            f"of it; idle share {s['idle_share']:.4f} (steps {L0_WARM + L0_TIMED + 1}-"
            f"{L0_WARM + L0_TIMED + L0_PROFILE}); peak {s['peak_gib']:.3f} GiB | {smi}")
        log(f"  its device time by kernel a step ({s['launches']:.0f} launches): {s['top']}")
        if not all(math.isfinite(x) for x in losses) or not last < first:
            raise AssertionError(f"NeRF loss did not fall: {first} -> {last}")
        npz = np.load(result["npz"])
        grid = npz["rgbsigma"]
        res = [int(r) for r in npz["resolution"]]
        ext_points = int(np.prod(res))
        ext_flops = nerf_extract_flops(ext_points, L0_VIEWS)
        log(f"  extraction at max_res {L0_RES}: grid {list(grid.shape)}, {timing['extract_ms']:.1f} ms "
            f"over {L0_VIEWS} views ({ext_flops / timing['extract_ms'] / 1e9:.2f} TFLOP/s; bound "
            f"{ext_flops / PEAK_FLOPS[torch.float32] * 1e3:.3f} ms; evaluating the whole MLP at "
            f"every (point, view) would be "
            f"{ext_points * L0_VIEWS * 2 * nerf_point_macs() / 1e12:.2f} TFLOP) | {smi}")
        if list(grid.shape[:3]) != res or max(res) != L0_RES or not np.isfinite(grid).all():
            raise AssertionError(f"extracted grid {grid.shape}, resolution {res}")

        os.makedirs(boxes)
        subprocess.run([sys.executable, os.path.join(REPO, "scripts", "preprocess_boxes.py"),
                        "--annotations", os.path.join(scene, "transforms.json"), "--features_npz",
                        result["npz"], "--output", os.path.join(boxes, "scene0.npy"),
                        "--format", "obb"], check=True, capture_output=True, timeout=300)
        vboxes = np.load(os.path.join(boxes, "scene0.npy"))
        dist = density_on_boxes(grid, vboxes, scale=L0_RES / 16)
        log(f"  preprocess_boxes --format obb: {vboxes.shape[0]} voxel boxes; density centroid "
            f"to box centre, largest axis (voxels): {[round(x, 2) for x in dist]} (tol "
            f"{2.5 * L0_RES / 16})")

        images, poses, focal, depths, valid = run_nerf.load_scene(
            scene, "transforms.json", 1, depth_dir=os.path.join(scene, "depth"))
        scene_scale = float(np.abs(np.asarray(tj["room_bbox"], np.float32)).max())
        dg, dg_rec, _ = run_nerf_recorded(
            ["--task", "train", "--depth_guided", "--depth_loss_weight", "0.1",
             "--cam_embed_dim", str(L0_CAM_DIM), "--depth_dir", os.path.join(scene, "depth"),
             "--ngp_frame", "--steps", str(L0_DG_STEPS), *flags], L0_DG_WARM, L0_DG_TIMED,
            L0_DG_STEPS)
        dg_flops = nerf_step_flops(L0_RAYS, L0_SAMPLES, cam_dim=L0_CAM_DIM)
        d = dg_rec.summary(dg_flops)
        dg_bound = dg_flops / PEAK_FLOPS[torch.float32] * 1e3
        log(f"  depth-guided step (--depth_guided --depth_loss_weight 0.1 --cam_embed_dim "
            f"{L0_CAM_DIM}, {100 * valid.mean():.1f}% of the pixels with depth; {L0_RAYS} rays, "
            f"{L0_SAMPLES // 2} + {L0_SAMPLES // 2} samples): median {d['median_ms']:.3f} ms, host "
            f"{d['host_ms']:.3f} ms/step, {L0_RAYS / d['median_ms'] * 1e3:.0f} rays/s, "
            f"{L0_RAYS * L0_SAMPLES / d['median_ms'] * 1e3:.4g} "
            f"samples/s, {d['tflops']:.2f} TFLOP/s; bound {dg_bound:.3f} ms; idle share "
            f"{d['idle_share']:.4f}; peak {d['peak_gib']:.3f} GiB; loss {d['losses'][0]:.4f} -> "
            f"{d['losses'][-1]:.4f} | {smi}")
        log(f"  its device time by kernel a step ({d['launches']:.0f} launches): {d['top']}")
        if not all(math.isfinite(x) for x in d["losses"]):
            raise AssertionError("depth-guided losses not finite")
        del dg

        trained = {k: v.detach().cpu() for k, v in result["params"].state_dict().items()}
        dists, param_err = nerf_step_against_cpu(dev, trained, images, poses, focal, near,
                                                 far, scene_scale)
        fine = result["trainer"].fine_params(result["params"])
        bmin, bmax = (np.asarray(b, np.float32) for b in tj["room_bbox"])
        card = extract_rgbsigma_grid(fine, bmin, bmax, poses[:L0_CPU_VIEWS], L0_CPU_RES,
                                     scene_scale=scene_scale)
        cpu = extract_rgbsigma_grid(copy.deepcopy(fine).cpu(), bmin, bmax, poses[:L0_CPU_VIEWS],
                                    L0_CPU_RES, scene_scale=scene_scale)
        ext_err = float(np.abs(card["rgbsigma"] - cpu["rgbsigma"]).max())
        np.testing.assert_allclose(card["rgbsigma"], cpu["rgbsigma"], **L0_EXTRACT_TOL)
        log(f"  card vs CPU, float32: one hierarchical step from the trained weights "
            f"({L0_CPU_RAYS} rays, same rays and draws), distance from the CPU float64 step "
            f"(card, CPU float32): loss rel {dists['loss'][0]:.3e}, {dists['loss'][1]:.3e}; Adam "
            f"moments (relative L2, worst tensor) {dists['moments'][0]:.3e}, "
            f"{dists['moments'][1]:.3e} (tol: card <= {L0_F32_FACTOR} x CPU + 1e-6); updated "
            f"params max abs {param_err:.3e} (tol 2 lr = 1e-3); extraction at max_res {L0_CPU_RES} over "
            f"{L0_CPU_VIEWS} views max abs {ext_err:.3e} (tol {L0_EXTRACT_TOL})")
        del result, fine
        torch.cuda.empty_cache()

        reset_launches()
        out = run_fcos.main(["--mode", "train", "--dataset", "front3d", "--features_path", feat,
                             "--boxes_path", boxes, "--backbone_type", "swin_s", "--resolution",
                             str(RES), "--batch_size", "1", "--steps", "2", "--device", "cuda",
                             *FCOS_FLAGS, "--checkpoint_dir", os.path.join(tmp, "fcos"),
                             "--log_interval", "1", "--eval_interval", "1000000",
                             "--ckpt_interval", "1000000"])
        launches = read_launches()
        hist = out["history"]
        log(f"  run_fcos on the extracted grid (swin_s {RES}^3, batch 1, 2 steps): losses "
            f"{[round(h['loss'], 5) for h in hist]}, num_pos {[int(h['num_pos']) for h in hist]}, "
            f"launches {launches['block']} + {launches['block_bwd']}")
        if (launches["block"], launches["block_bwd"]) != (44, 44):
            raise AssertionError(f"FCOS on the extracted grid: launches {launches}")
        if len(hist) != 2 or not all(math.isfinite(h["loss"]) and h["num_pos"] > 0
                                     for h in hist):
            raise AssertionError(f"FCOS on the extracted grid: {hist}")
    return s


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    # float32 comparisons run in full float32 (TF32 keeps ~3 digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = nvidia_smi()
    log(f"[1] device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    build_s = kernels.build_all()
    log(f"[2] build: {build_s:.1f} s (nvcc, one process per source, sm_90a"
        + ("; every library was already built, its ptxas report read back)"
           if build_s == 0 else ")"))
    ptxas_summary()

    log("[3] kernels vs plain versions (swin_b 160^3 stage shapes, batch 1, 2 and 8)")
    by_batch = phase_kernels(dev)
    summary = by_batch[1]

    log(f"[4] main path: {SERVE_REQUESTS} inference requests at swin_b 160^3 (tanh GELU)")
    with tempfile.TemporaryDirectory() as tmp:
        launches, request_ms = phase_main_path(dev, tmp)
    model, grids, token_mask, tanh_launches, rel = compare_with_plain("tanh", dev)
    log(f"  tanh forward vs plain composition: rel_l2 {rel:.3e} (tol 5e-2: "
        f"bf16 rounding order over 24 blocks and the decoder), launches {tanh_launches}")
    if rel > 5e-2 or tanh_launches["block"] != 22:
        raise AssertionError("tanh path disagrees with the plain composition")
    with torch.inference_mode():
        forward_breakdown(model, grids, token_mask)  # warm-up
        parts = forward_breakdown(model, grids, token_mask)
    log("  forward breakdown at batch 1 (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items()) + f"; total {sum(parts.values()):.3f}")
    del model

    log("[5] erf path: fused window-attention kernel")
    _, _, _, erf_launches, rel = compare_with_plain("erf", dev)
    log(f"  erf forward vs plain composition: rel_l2 {rel:.3e} (tol 5e-2), "
        f"launches {erf_launches}")
    if erf_launches != {"block": 0, "attention": 22}:
        raise AssertionError(f"erf path launches {erf_launches}, expected 22 attention")
    if rel > 5e-2:
        raise AssertionError("erf path disagrees with the plain composition")

    log(f"[6] backward kernels vs plain backwards (swin_b 160^3 stage shapes, "
        f"batch {TRAIN_BATCH})")
    bwd_summary = phase_backward(dev)

    log(f"[7] train main path: run_mae_pretrain at swin_b 160^3, batch {TRAIN_BATCH}, "
        f"{TRAIN_STEPS} steps, then eval from the checkpoint and the benchmark")
    with tempfile.TemporaryDirectory() as tmp:
        train_launches, bench = phase_train(dev, tmp, smi)
    parts, peaks = step_breakdown(dev)
    log(f"  train step breakdown at batch {TRAIN_BATCH} (ms, device timeline): "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f"; total {sum(parts.values()):.3f}; peak memory per part (GiB): "
        + ", ".join(f"{k} {v:.4f}" for k, v in peaks.items()))

    log("[8] gradients vs the plain composition (tanh, batch 2, float32 and bf16)")
    phase_grads(dev, "tanh")

    log("[9] erf train step: fused window-attention forward and backward (batch 2, "
        "float32 and bf16)")
    erf_train_launches = phase_grads(dev, "erf")

    log(f"[10] profile: block forward and backward at stage 0 and 2, batch {TRAIN_BATCH}")
    phase_profile(dev)

    log(f"[11] swin_s kernel cases: fused block forward and backward vs plain (160^3, "
        f"batch {HEAD_BATCH})")
    phase_swin_s_kernels(dev)
    with tempfile.TemporaryDirectory() as tmp:
        log(f"[12] voxel super-resolution: swin_s {RES}^3 -> {SR_OUT[0]}^3, batch "
            f"{HEAD_BATCH}, {HEAD_STEPS} steps from a swin_s MAE checkpoint; benchmarks at "
            f"{SR_OUT}")
        mae_ckpt = write_mae_checkpoint(tmp)
        phase_head("sr", dev, tmp, smi, mae_ckpt)
        log(f"[13] voxel semantics: swin_s {RES}^3, {NUM_CLASSES} classes, batch "
            f"{HEAD_BATCH}, {HEAD_STEPS} steps from the same MAE checkpoint")
        phase_head("semantics", dev, tmp, smi, mae_ckpt)
        log(f"[14] FCOS detection: OBB, swin_s {RES}^3, batch {HEAD_BATCH}, {FCOS_STEPS} steps "
            "from the same MAE checkpoint (launch/train_fcos_pretrained.sh's flags), eval, "
            "benchmarks (OBB and AABB)")
        phase_fcos(dev, tmp, smi, mae_ckpt)
        log(f"[15] anchor RPN + RCNN: AABB, swin_s {RES}^3, batch {HEAD_BATCH}, {RPN_STEPS} RPN "
            "steps from the same MAE checkpoint (launch/train_rpn.sh's flags), eval, "
            f"benchmarks (AABB and OBB); then {RCNN_STEPS} RCNN steps over that RPN, eval")
        rpn_ckpt = phase_rpn(dev, tmp, smi, mae_ckpt)
        phase_rcnn(dev, tmp, smi, rpn_ckpt)

    log(f"[16] training feed: run_mae_pretrain at swin_b {RES}^3, batch {TRAIN_BATCH}, from "
        f"{FEED_SCENES} scenes on disk through four feeds ({', '.join(n for n, _ in FEEDS)}); "
        "the native collate against numpy; the e2e AP recipe cut for liveness")
    phase_feed(dev, smi, bench)

    log(f"[17] L0 data production: run_nerf train_extract at the JAX defaults ({L0_STEPS} "
        f"steps) on {L0_VIEWS} views of {L0_HW[1]}x{L0_HW[0]}, the grid on the boxes, the "
        "depth-guided step, card against CPU, 2 swin_s FCOS steps on the extracted grid")
    phase_l0(dev, smi)

    log(f"[18] total {time.perf_counter() - t0:.1f} s; request ms {request_ms}; "
        "kernels line: forward kernels' ms / plain_ms / bound_ms per batch-1 "
        "forward (phase 3), backward kernels' per batch-8 train step (phase 6), "
        "each a sum of measured medians over the 22 launches; launches from the "
        "train main path (phase 7) and the erf train step (phase 9)")
    entries = []
    for kind, name, source, replaces, count, s in (
        ("block", "fused_swin_block", "nerf_mae_torch/csrc/fused_block.cu",
         "nerf_mae_tpu/ops/pallas_block.py:247", train_launches["block"], summary["block"]),
        ("block_bwd", "fused_swin_block_bwd", "nerf_mae_torch/csrc/fused_block_bwd.cu",
         "nerf_mae_tpu/ops/pallas_block.py:338", train_launches["block_bwd"],
         bwd_summary["block_bwd"]),
        ("attention", "fused_window_attention", "nerf_mae_torch/csrc/fused_attention.cu",
         "nerf_mae_tpu/ops/pallas_attention.py:111", erf_train_launches["attention"],
         summary["attention"]),
        ("attention_bwd", "fused_window_attention_bwd",
         "nerf_mae_torch/csrc/fused_attention_bwd.cu",
         "nerf_mae_tpu/ops/pallas_attention.py:312", erf_train_launches["attention_bwd"],
         bwd_summary["attention_bwd"]),
    ):
        max_abs = (s["max_abs_err"] if kind.endswith("bwd")
                   else max(b[kind]["max_abs_err"] for b in by_batch.values()))
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": count, "max_abs_err": max_abs, "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": None,
        })
    print(json.dumps({"kernels": entries}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
