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
  4. the main path: three inference requests through
     nerf_mae_torch.inference.main at swin_b 160^3 (2 scenes each, random
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
 11. one JSON line of the four kernels, nvidia-smi's line, and the last line
     {"ok": true, "device": {...}}.
Without a CUDA card it exits with code 1 and prints no result.
"""

from __future__ import annotations

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

from nerf_mae_torch import inference, kernels, run_mae_pretrain
from nerf_mae_torch.config import SWIN_PRESETS, MAEConfig, TrainConfig
from nerf_mae_torch.models.mae import SwinMAE3D, init_weights, mae_loss
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
from nerf_mae_torch.ops.masking import block_mask_3d
from nerf_mae_torch.train import optim

# Published H100 SXM peaks (dense): bf16 tensor cores, float32 FMA units,
# HBM3 bandwidth. Bounds are stated against them, with the card's power
# limit printed beside every number.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
RES = 160
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


def log(msg: str) -> None:
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
    """2 synthetic scenes of odd sizes below 160, from a numpy seed: rgb in
    [0, 1] and raw density (alpha after density_to_alpha ~half occupied)."""
    rs = np.random.RandomState(seed)
    os.makedirs(root)
    for i in range(2):
        size = tuple(int(s) for s in rs.randint(48, 80, size=3) * 2 + 1)
        grid = np.empty(size + (4,), np.float32)
        grid[..., :3] = rs.rand(*size, 3)
        grid[..., 3] = rs.randn(*size) * 3
        np.savez(os.path.join(root, f"scene{i}.npz"), rgbsigma=grid,
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
    """Three requests through inference.main at swin_b 160^3."""
    per_scene = 22  # fused blocks per forward and per encode
    fused_swin_block.launches = 0
    fused_window_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    request_ms = []
    for r in range(3):
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


def phase_profile(dev):
    """torch.profiler (CPU and CUDA activities) over one block forward and
    one block backward call at stage 0 and at stage 2, batch 8, unshifted
    (phase 6's shapes): device time per kernel name, sorted, with launch
    counts and the sum, as the sub-launch breakdown of each call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
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
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            extra_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
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

    log("[4] main path: 3 inference requests at swin_b 160^3 (tanh GELU)")
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

    log(f"[11] total {time.perf_counter() - t0:.1f} s; request ms {request_ms}; "
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
