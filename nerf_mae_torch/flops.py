"""Analytic FLOPs of the MAE pretraining model (counterpart of
nerf_mae_tpu/flops.py, same counts) and of the dense downstream heads
(models/heads.py: VoxelSemantics3D, VoxelSR3D), which the JAX package does
not count.

Model matmul/conv FLOPs (2*M*N*K per product) of one forward per grid; the
train step counts 3x the forward (forward plus ~2x backward), the usual
model-FLOPs convention. Rematerialization and the backward kernels'
recompute are excluded, so MFU is model-FLOPs utilization, comparable
across remat settings. Elementwise, norm and loss FLOPs are not counted.
"""

from __future__ import annotations

import math
from typing import Dict

from nerf_mae_torch.config import MAEConfig

# Dense bf16 tensor-core peak of one NVIDIA H100 SXM (data sheet: 989 TFLOP/s).
H100_BF16_PEAK_FLOPS = 989e12


def _trunk_and_decoders(cfg: MAEConfig) -> Dict[str, float]:
    """Forward FLOPs per grid of the patch embed, the Swin stages, the
    merges and the UNETR decoders 4/3/2."""
    s = cfg.swin
    E = s.embed_dim
    R = cfg.resolution
    p = s.patch_size[0]
    T = R // p
    w_tokens = int(math.prod(s.window_size))
    comp: Dict[str, float] = {}

    # patch embed: conv k=p^3 stride p, Cin -> E over T^3 outputs
    comp["patch_embed"] = 2.0 * T**3 * (p**3 * cfg.input_channels) * E

    # encoder stages: per block qkv(6NC^2) + attn(4*N*w*C) + proj(2NC^2)
    # + mlp(2 * N * C * mlp_ratio*C * 2)
    dims = s.stage_dims  # honors expand_dim (PatchMerging3D)
    mlp_mult = 2.0 * 2.0 * s.mlp_ratio  # two GEMMs of C x (ratio*C)
    for i, depth in enumerate(s.depths):
        N = (T // 2**i) ** 3
        C = dims[i]
        per_block = (6.0 + 2.0 + mlp_mult) * N * C * C
        per_block += 4.0 * N * w_tokens * C
        comp[f"stage{i}"] = depth * per_block

    # patch merges between stages: N' voxels, 8C -> next-stage-C linear
    for i in range(len(s.depths) - 1):
        Np = (T // 2 ** (i + 1)) ** 3
        comp[f"merge{i}"] = 2.0 * Np * (8 * dims[i]) * dims[i + 1]

    # UNETR decoder: decoder4/3/2 each = ConvTranspose k=s=2 + res block
    # (conv3^3 x2 + 1x1 shortcut) after skip concat; channels from
    # models/mae.py (decoder_k out = E * 2^(k-2)).
    for k, i in ((4, 2), (3, 1), (2, 0)):  # decoder_k consumes skip f[i]
        Nout = (T // 2**i) ** 3
        Cin = E * 2 ** (i + 1)  # incoming feature channels
        Cout = E * 2**i
        f = 2.0 * Nout * Cin * Cout  # ConvTranspose k=s=2
        Ccat = Cout + Cout  # upsampled + skip
        f += 2.0 * Nout * 27 * Ccat * Cout  # res conv1
        f += 2.0 * Nout * 27 * Cout * Cout  # res conv2
        f += 2.0 * Nout * Ccat * Cout  # 1x1 shortcut (Ccat != Cout)
        comp[f"decoder{k}"] = f
    return comp


def mae_flops_per_grid(cfg: MAEConfig) -> Dict[str, float]:
    """Per-component forward FLOPs for one input grid (batch element).

    Returns a dict of component -> FLOPs plus:
      fwd_total:   forward FLOPs/grid
      train_total: 3 * fwd_total (fwd + bwd model FLOPs)
    """
    comp = _trunk_and_decoders(cfg)
    E = cfg.swin.embed_dim
    R = cfg.resolution
    p = cfg.swin.patch_size[0]
    N = (R // p) ** 3
    if cfg.decoder_type == "subpixel":
        f = 2.0 * N * 27 * E * E * 2  # head res block conv1+conv2
        f += 2.0 * N * 27 * E * (cfg.out_channels * p**3)  # subpixel proj
        comp["head"] = f
    else:  # reference-style decoder1 at full resolution + 1x1 out
        Cd1 = E // 2
        f = 2.0 * R**3 * E * Cd1  # ConvTranspose k=s=p (per-output cost)
        f += 2.0 * R**3 * 27 * Cd1 * Cd1 * 2  # res convs at R^3
        f += 2.0 * R**3 * Cd1 * cfg.out_channels  # 1x1 out
        comp["head"] = f

    fwd = sum(comp.values())
    comp["fwd_total"] = fwd
    comp["train_total"] = 3.0 * fwd
    return comp


def dense_head_flops_per_grid(cfg: MAEConfig, out_channels: int) -> Dict[str, float]:
    """Forward FLOPs for one input grid of a dense head (models/heads.py)
    with `out_channels` outputs a voxel at R^3 (num_classes for semantics,
    4 for SR before its resize): the trunk and decoders 4/3/2, then at full
    resolution encoder1 (res block Cin -> E/2 with its 1x1 shortcut),
    decoder1 (transposed conv k = s = p, E -> E/2, one input voxel per
    output voxel; skip concat; res block E -> E/2 with its 1x1 shortcut)
    and the 1x1 head; with fwd_total and train_total as mae_flops_per_grid."""
    comp = _trunk_and_decoders(cfg)
    E, R, cin = cfg.swin.embed_dim, cfg.resolution, cfg.input_channels
    Cd1 = E // 2
    n = float(R**3)
    comp["encoder1"] = 2.0 * n * (27 * cin * Cd1 + 27 * Cd1 * Cd1 + cin * Cd1)
    comp["decoder1"] = 2.0 * n * (E * Cd1 + 27 * 2 * Cd1 * Cd1 + 27 * Cd1 * Cd1
                                  + 2 * Cd1 * Cd1)
    comp["head"] = 2.0 * n * Cd1 * out_channels
    fwd = sum(comp.values())
    comp["fwd_total"] = fwd
    comp["train_total"] = 3.0 * fwd
    return comp


def train_mfu(
    grids_per_sec_per_device: float,
    cfg: MAEConfig,
    peak_flops: float = H100_BF16_PEAK_FLOPS,
) -> float:
    """Model-FLOPs utilization of the train step on one device."""
    per_grid = mae_flops_per_grid(cfg)["train_total"]
    return grids_per_sec_per_device * per_grid / peak_flops
