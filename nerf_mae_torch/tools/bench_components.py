"""Isolated-component timings of the MAE train step (the port's counterpart
of scripts/bench_components.py, with its row names, so that the two JSON
files line up row by row).

    python -m nerf_mae_torch.tools.bench_components [--preset swin_b] \
        [--resolution 160] [--batch 8] [--reps 20] [--only S] [--out FILE.json] \
        [--device cuda|cpu]

Each piece is the port's own module at its in-context shape with fresh
parameters (init_weights, seed 0) and an input drawn in the compute dtype:
the patch embed (models/mae.py, patch-major and channel-flat input), each
stage's pair of Swin blocks (unshifted then shifted, models/swin.py), the
patch mergings, the UNETR up blocks (models/unetr.py) and the subpixel
head. Forward is timed under torch.no_grad; forward+backward takes
torch.autograd.grad of sum(out.float()**2) with respect to the parameters
and the input (the parameters only for the embed rows: the real step never
needs the grids' gradient). Each time is the mean of --reps calls after two
warm calls, with a synchronize at each end. SwinBlock3D dispatches as in
the step: the fused-block kernels on stages 0-2 (C <= 512), the plain path
on stage 3; the res blocks of the up blocks and the head through the fused
norm kernels (ops/res_norm.py); each row records the kernel launches a
call makes.

Isolated numbers exclude what the step shares between pieces, so they rank
targets; they do not sum to the step (run_mae_pretrain --mode benchmark
and nerf_mae_torch.bench time the step). mae_loss and the optimizer are
left out, as in the JAX script: both belong to the whole step.

The JSON ({"meta", "rows"}) goes to --out, by default
runs/component_breakdown_<device>.json (h100 on an H100, cpu on the CPU):
never the JAX script's runs/component_breakdown.json. Runs on the CUDA card
unless --device cpu; asking for the card without one raises.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Sequence

import torch
from torch import nn

from nerf_mae_torch.config import SWIN_PRESETS, MAEConfig
from nerf_mae_torch.inference import resolve_device
from nerf_mae_torch.models.mae import init_weights, patch_embed
from nerf_mae_torch.models.swin import PatchMerging3D, SwinBlock3D
from nerf_mae_torch.models.unetr import Conv3d, SubpixelHead3D, UnetrUpBlock3D
from nerf_mae_torch.ops.fused_attention import (
    fused_window_attention,
    fused_window_attention_bwd,
)
from nerf_mae_torch.ops.fused_block import fused_swin_block, fused_swin_block_bwd
from nerf_mae_torch.ops import res_norm
from nerf_mae_torch.run_mae_pretrain import device_slug

KERNELS = (fused_swin_block, fused_swin_block_bwd, fused_window_attention,
           fused_window_attention_bwd, *res_norm.KERNELS)


def device_label(device: torch.device) -> str:
    """nvidia-smi's name and power limit of the card, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             f"--id={device.index or 0}"], check=True, capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"


def _launches() -> Dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}


def timeit(fn: Callable, reps: int, device: torch.device):
    """(mean ms of `reps` calls after two warm calls, kernel launches a
    call)."""
    before = _launches()
    fn()
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    ms = (time.perf_counter() - t0) / reps * 1e3
    calls = reps + 2
    per_call = {k: (v - before[k]) / calls for k, v in _launches().items()
                if v != before[k]}
    return ms, per_call


def _fresh(module: nn.Module) -> nn.Module:
    """`module` with init_weights' parameters (named under a prefix, as in
    the model, so that the initialisers find them)."""
    init_weights(nn.ModuleDict({"piece": module}), seed=0)
    return module


def _forward(apply: Callable, inputs: Sequence[torch.Tensor]) -> Callable:
    def run():
        with torch.no_grad():
            return apply(*inputs)
    return run


def _forward_backward(apply: Callable, params: List[torch.Tensor],
                      inputs: Sequence[torch.Tensor], input_grads: bool = True) -> Callable:
    inputs = [x.detach().requires_grad_(input_grads) for x in inputs]
    wrt = params + (inputs if input_grads else [])

    def run():
        out = apply(*inputs)
        return torch.autograd.grad((out.float() ** 2).sum(), wrt)
    return run


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description="Isolated component timings of the MAE step")
    p.add_argument("--preset", default="swin_b", choices=list(SWIN_PRESETS))
    p.add_argument("--resolution", type=int, default=160)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--only", default="", help="substring filter on the row names")
    p.add_argument("--out", default=None,
                   help="JSON path (default runs/component_breakdown_<device>.json)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    swin = SWIN_PRESETS[args.preset]
    cfg = MAEConfig(swin=swin, resolution=args.resolution)
    b, r = args.batch, args.resolution
    pt = swin.patch_size[0]
    t = r // pt
    e = swin.embed_dim
    dt = cfg.dtype
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev, dtype=dt)
    rows: Dict[str, Dict] = {}

    def record(name, apply, params, inputs, input_grads=True):
        fwd, fwd_launches = timeit(_forward(apply, inputs), args.reps, dev)
        bwd, bwd_launches = timeit(_forward_backward(apply, list(params), inputs, input_grads),
                                   args.reps, dev)
        rows[name] = {"fwd": fwd, "fwd_bwd": bwd,
                      "launches": {"fwd": fwd_launches, "fwd_bwd": bwd_launches}}
        print(f"# {name:<42} fwd {fwd:8.3f} ms   fwd+bwd {bwd:8.3f} ms   launches a call "
              f"{fwd_launches or '-'} / {bwd_launches or '-'}", file=sys.stderr, flush=True)

    # patch embed: the dense [.., p^3 * 4] @ [p^3 * 4, E] product (the
    # LayerNorm is left out, as in JAX), on the patch-major batch and on its
    # channel-flat form; gradients of the parameters only
    x6 = randn(b, t, t, t, pt**3, cfg.input_channels)
    for name, x in (("patch_embed_patched_k256", x6),
                    ("patch_embed_flat256_arg", x6.reshape(b, t, t, t, -1))):
        if args.only in name:
            conv = _fresh(Conv3d(cfg.input_channels, e, pt, device=dev))
            unflat = lambda xx: xx.reshape(*xx.shape[:4], pt**3, cfg.input_channels)
            record(name, lambda xx, c=conv: patch_embed(unflat(xx), c.weight, c.bias, dt),
                   conv.parameters(), [x], input_grads=False)
    del x6

    # each stage's pair of blocks (unshifted, shifted: the repeating unit)
    # and the merging after it
    shift = tuple(w // 2 for w in swin.window_size)
    for i, heads in enumerate(swin.num_heads):
        dim = swin.stage_dims[i]
        g = t // 2**i
        name = f"stage{i}_pair_[{b},{g}^3,{dim}]"
        if args.only in name:
            pair = _fresh(nn.Sequential(*(
                SwinBlock3D(dim, heads, tuple(swin.window_size), s, mlp_ratio=swin.mlp_ratio,
                            norm_eps=swin.norm_eps, dtype=dt,
                            attention_impl=swin.attention_impl, gelu=swin.gelu, device=dev)
                for s in ((0, 0, 0), shift))))
            record(name, pair, pair.parameters(), [randn(b, g, g, g, dim)])
        mname = f"merge{i}_[{b},{g}^3,{dim}]"
        if args.only in mname and i < len(swin.depths) - 1:
            merge = _fresh(PatchMerging3D(dim, expand_dim=swin.expand_dim,
                                          norm_eps=swin.norm_eps, dtype=dt, device=dev))
            record(mname, merge, merge.parameters(), [randn(b, g, g, g, dim)])

    # the UNETR up blocks (decoder4 / 3 / 2) and the subpixel head
    dims = swin.stage_dims
    for lvl, (ci, cs, gi) in enumerate([(dims[3], dims[2], t // 8),
                                        (dims[2], dims[1], t // 4),
                                        (dims[1], dims[0], t // 2)]):
        name = f"decoder{4 - lvl}_[{b},{gi}^3,{ci}]"
        if args.only in name:
            up = _fresh(UnetrUpBlock3D(ci, cs, dtype=dt, attention_impl=swin.attention_impl,
                                       device=dev))
            skip = randn(b, 2 * gi, 2 * gi, 2 * gi, cs)
            record(name, lambda xx, m=up, s=skip: m(xx, s), up.parameters(),
                   [randn(b, gi, gi, gi, ci)])
    name = "subpixel_head_patched"
    if args.only in name:
        head = _fresh(SubpixelHead3D(e, cfg.out_channels, patch=pt, dtype=dt,
                                     attention_impl=swin.attention_impl, device=dev))
        record(name, lambda xx: head(xx, patched=True), head.parameters(),
               [randn(b, t, t, t, e)])

    meta = {"preset": args.preset, "resolution": r, "batch": b, "reps": args.reps,
            "unit": "ms", "device": device_label(dev)}
    out = {"meta": meta, "rows": rows}
    path = args.out or os.path.join("runs", f"component_breakdown_{device_slug(dev)}.json")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"rows": len(rows), "out": path}))
    return out


if __name__ == "__main__":
    main()
