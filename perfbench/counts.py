"""The yardstick's arithmetic, frozen here so that no change to the system
under test can move it: peaks of the card, model FLOPs of a training step,
and the operations and bytes one fused Swin-block call needs.

Model FLOPs are 2*M*N*K per matrix product or convolution of one forward
per grid; a training step counts 3x the forward (forward plus a backward of
two products per forward product). Recompute (remat, a kernel's backward
recomputing its forward) is not counted, so utilization compares the same
work whatever implements it. Elementwise, norm and loss work is not counted.
"""

from __future__ import annotations

from typing import Dict, Tuple

# One NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at the full 700 W.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
BYTES = {"bfloat16": 2, "float32": 4}


def _stage_dims(cfg: dict):
    return [cfg["embed_dim"] * 2 ** s for s in range(len(cfg["depths"]))]


def trunk_flops(cfg: dict) -> Dict[str, float]:
    """Forward FLOPs of one grid through the patch embedding, the Swin
    stages (qkv 6NC^2, projection 2NC^2, MLP 4*ratio*NC^2, attention 4NwC
    with w tokens a window) and the mergings (8C -> 2C over N/8)."""
    t = cfg["resolution"] // cfg["patch_size"]
    w = cfg["window_size"][0] * cfg["window_size"][1] * cfg["window_size"][2]
    dims = _stage_dims(cfg)
    out = {"patch_embed": 2.0 * t ** 3 * cfg["patch_size"] ** 3 * cfg["input_channels"]
           * cfg["embed_dim"]}
    for s, depth in enumerate(cfg["depths"]):
        n, c = (t // 2 ** s) ** 3, dims[s]
        out[f"stage{s}"] = depth * ((8.0 + 4.0 * cfg["mlp_ratio"]) * n * c * c + 4.0 * n * w * c)
        if s > 0:
            out[f"merge{s - 1}"] = 2.0 * n * 8 * dims[s - 1] * c
    return out


def mae_flops_per_grid(cfg: dict) -> Dict[str, float]:
    """The MAE's forward FLOPs per grid by part (nerf_mae_torch/flops.py's
    counts for the subpixel decoder), with fwd_total and train_total."""
    out = trunk_flops(cfg)
    e, t = cfg["embed_dim"], cfg["resolution"] // cfg["patch_size"]
    for k, i in ((4, 2), (3, 1), (2, 0)):
        n, cin, cout = (t // 2 ** i) ** 3, e * 2 ** (i + 1), e * 2 ** i
        out[f"decoder{k}"] = 2.0 * n * (cin * cout + 27 * 2 * cout * cout
                                        + 27 * cout * cout + 2 * cout * cout)
    n = t ** 3
    out["head"] = 2.0 * n * 27 * e * e * 2 + 2.0 * n * 27 * e * cfg["out_channels"] * cfg[
        "patch_size"] ** 3
    fwd = sum(out.values())
    return {**out, "fwd_total": fwd, "train_total": 3.0 * fwd}


def fcos_flops_per_grid(cfg: dict) -> Dict[str, float]:
    """FCOS over a Swin-FPN: the trunk, the FPN (1x1 laterals, 3^3
    smoothing convs to `fpn_channels`), and per level two towers of
    `num_convs` 3^3 convs and the 3^3 classification (1), box (reg_dim)
    and centerness (1) convs, with fwd_total and train_total."""
    out = trunk_flops(cfg)
    t = cfg["resolution"] // cfg["patch_size"]
    f = cfg["fpn_channels"]
    heads = 1 + cfg["reg_dim"] + 1
    out["fpn"] = out["towers"] = out["predictors"] = 0.0
    for s, c in enumerate(_stage_dims(cfg)):
        n = (t // 2 ** s) ** 3
        out["fpn"] += 2.0 * n * (c * f + 27 * f * f)
        out["towers"] += 2.0 * n * 27 * f * f * 2 * cfg["num_convs"]
        out["predictors"] += 2.0 * n * 27 * f * heads
    fwd = sum(out.values())
    return {**out, "fwd_total": fwd, "train_total": 3.0 * fwd}


FLOPS_PER_GRID = {"mae": mae_flops_per_grid, "fcos": fcos_flops_per_grid}


def block_work(kind: str, shape: Tuple[int, int, int, int, int], heads: int,
               dtype: str) -> Tuple[float, float]:
    """(FLOPs, bytes) that one fused Swin-block call needs (chip_smoke.py's
    `work`). FLOPs per real token: 24 C^2 + 4 N C forward (N = 64 keys a
    window); the backward recomputes the forward and runs two products per
    forward product: 72 C^2 + 12 N C. Pad rows need no product. Bytes: x in
    and out (backward: x and dy in, dx out) in the compute dtype, the weight
    matrices in the compute dtype, the float32 LN parameters, biases and
    [343, heads] table, each once; a backward also writes the float32
    gradients of all of them once."""
    b, g0, g1, g2, c = shape
    tokens, n, e = b * g0 * g1 * g2, 64, BYTES[dtype]
    mats, vecs = 12 * c * c, 13 * c
    flops = tokens * (24 * c * c + 4 * n * c)
    nbytes = 2 * tokens * c * e + e * mats + 4 * (vecs + 343 * heads)
    if kind == "bwd":
        flops = tokens * (72 * c * c + 12 * n * c)
        nbytes += tokens * c * e + 4 * (mats + vecs + 343 * heads)
    return flops, nbytes


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """Least time the card could take: the larger of the operation and the
    byte bounds."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


def fused_block_calls(cfg: dict, batch: int):
    """[(shape, heads)] of the fused-block calls of one forward: every block
    of the stages whose width the kernel takes (C <= 512)."""
    t = cfg["resolution"] // cfg["patch_size"]
    calls = []
    for s, (depth, c) in enumerate(zip(cfg["depths"], _stage_dims(cfg))):
        if c <= 512:
            g = t // 2 ** s
            calls += [((batch, g, g, g, c), cfg["num_heads"][s])] * depth
    return calls


def fused_block_bound_s(cfg: dict, batch: int, kind: str, dtype: str) -> float:
    """The summed bound of one step's fused-block calls of `kind`."""
    return sum(bound_s(*block_work(kind, shape, heads, dtype), dtype)
               for shape, heads in fused_block_calls(cfg, batch))
