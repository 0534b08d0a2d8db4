#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (nerf_mae_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the exit code is not 0):
  1. device: the card's name and nvidia-smi's name / power limit;
  2. build: every kernel of csrc/ with nvcc (sm_90a), timed;
  3. kernels: each hand-written kernel against its plain PyTorch version at
     every (stage, shift) of the swin_b 160^3 forward (batch 1 and 2, bf16)
     and one float32 case, with errors, tolerances and CUDA-event times
     beside the bound;
  4. the main path: three inference requests through
     nerf_mae_torch.inference.main at swin_b 160^3 (2 scenes each, random
     weights from a seed), with the fused-block launches counted, then a
     per-part time breakdown of one forward and a comparison of the whole
     reconstruction with the plain composition;
  5. the erf path: the fused window-attention kernel through the same
     model with gelu="erf", compared with the plain composition;
  6. one JSON line of the kernels, nvidia-smi's line, and the last line
     {"ok": true, "device": {...}}.
Without a CUDA card it exits with code 1 and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from nerf_mae_torch import inference, kernels
from nerf_mae_torch.config import SWIN_PRESETS, MAEConfig
from nerf_mae_torch.models.mae import SwinMAE3D, init_weights
from nerf_mae_torch.ops.fused_attention import (
    fused_window_attention,
    fused_window_attention_plain,
)
from nerf_mae_torch.ops.fused_block import fused_swin_block, fused_swin_block_plain

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
# phase 3's batches: 1 is the main path's (one scene per forward)
KERNEL_BATCHES = (1, 2)
STAGES = {0: (40, 128, 4), 1: (20, 256, 8), 2: (10, 512, 16)}  # grid, C, heads


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn) -> float:
    """Median of 25 CUDA-event timings of fn() after 3 warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(25):
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


def block_weights(c: int, heads: int, gen: torch.Generator, dev, dtype):
    """Random block parameters (torch layout) from `gen`, scaled so that
    attention is peaked and every branch matters. The four weight matrices
    are in the compute dtype, as SwinBlock3D hands them to the kernels; the
    rest is float32."""
    r = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    f = 4 * c
    return dict(
        ln1_scale=1 + 0.1 * r(c), ln1_bias=0.1 * r(c),
        qkv_weight=(r(3 * c, c) / c ** 0.5).to(dtype), qkv_bias=0.1 * r(3 * c),
        proj_weight=(r(c, c) / c ** 0.5).to(dtype), proj_bias=0.1 * r(c),
        ln2_scale=1 + 0.1 * r(c), ln2_bias=0.1 * r(c),
        fc1_weight=(r(f, c) / c ** 0.5).to(dtype), fc1_bias=0.1 * r(f),
        fc2_weight=(r(c, f) / f ** 0.5).to(dtype), fc2_bias=0.1 * r(c),
        bias_table=r(343, heads),
    )


def block_args(w):
    return (w["ln1_scale"], w["ln1_bias"], w["qkv_weight"], w["qkv_bias"],
            w["proj_weight"], w["proj_bias"], w["ln2_scale"], w["ln2_bias"],
            w["fc1_weight"], w["fc1_bias"], w["fc2_weight"], w["fc2_bias"],
            w["bias_table"])


def work(kind, shape, heads, dtype):
    """(FLOPs, bytes) that one call needs. FLOPs per real token: 24 C^2 +
    4 N C for the block, 8 C^2 + 4 N C for the attention (N = 64 keys per
    window). Pad rows need no product: their LN output is zero, so their
    keys and values are qkv_bias, and their queries and outputs are cropped
    away. Bytes: x in and out in the compute dtype, the weight matrices in
    the compute dtype, the float32 LN parameters, biases and the
    [343, heads] rel-pos table, each once."""
    b, g0, g1, g2, c = shape
    tokens, n, e = b * g0 * g1 * g2, 64, torch.finfo(dtype).bits // 8
    if kind == "block":
        flops = tokens * (24 * c * c + 4 * n * c)
        weight_bytes = e * 12 * c * c + 4 * (13 * c + 343 * heads)
    else:
        flops = tokens * (8 * c * c + 4 * n * c)
        weight_bytes = e * 4 * c * c + 4 * (4 * c + 343 * heads)
    return flops, 2 * tokens * c * e + weight_bytes


def bound(flops, nbytes, dtype):
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_kernels(dev):
    """Both kernels against their plain versions at every (stage, shift)
    of the swin_b 160^3 forward, at batch 1 and 2. Returns, per batch and
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
    log(f"[2] build: {build_s:.1f} s (nvcc, one process per source, sm_90a)")

    log("[3] kernels vs plain versions (swin_b 160^3 stage shapes, batch 1 and 2)")
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

    log(f"[6] total {time.perf_counter() - t0:.1f} s; request ms {request_ms}; "
        "kernel ms / plain_ms / bound_ms below are per batch-1 forward: sums of "
        "phase 3's measured per-shape medians over the 22 launches")
    entries = []
    for kind, name, source, replaces, count in (
        ("block", "fused_swin_block", "nerf_mae_torch/csrc/fused_block.cu",
         "nerf_mae_tpu/ops/pallas_block.py:247", launches["block"]),
        ("attention", "fused_window_attention", "nerf_mae_torch/csrc/fused_attention.cu",
         "nerf_mae_tpu/ops/pallas_attention.py:111", erf_launches["attention"]),
    ):
        s = summary[kind]
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": count,
            "max_abs_err": max(b[kind]["max_abs_err"] for b in by_batch.values()),
            "ms": s["ms"],
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
