"""Downstream dense heads: voxel super-resolution and voxel semantics
(counterpart of nerf_mae_tpu/models/heads.py).

The reference's SwinTransformer_VoxelSR_* and SwinTransformer_VoxelSemantics_*
families (reference: nerf_rpn/model/feature_extractor.py:1310-3974). Both
reuse the pretrained MAE trunk AND its decoder4/3/2, under `base` with the
MAE's own names (`base.patch_partition`, `base.stages`, `base.decoder4..2`),
so a MAE state dict grafts by prefix (train/checkpoint.py:graft_mae); the
MAE's own builder and decoder pass make and run them (models/mae.py
build_trunk, decode). Then:

  * encoder1: a res block on the raw R^3 input, the skip of
  * decoder1: an up-4x block fusing the decoder output with encoder1
    -> [B, R, R, R, C/2];
  * VoxelSR3D: the 1x1 `voxel_out` conv to 4 channels and a nearest resize
    to out_resolution^3 (half-pixel centres, as jax.image.resize);
  * VoxelSemantics3D: the 1x1 `sem_out` conv to num_classes logits at R^3.

The SR head applies `voxel_out` before the resize, where the JAX head
applies it after: a 1x1 convolution maps each voxel on its own, so it
commutes with a nearest gather and the function is the same, while the
largest activation shrinks from [B, R_out^3, C/2] to [B, R_out^3, 4] (at
batch 8 and 256^3, 12.9 GB of bf16 to 2.1 GB of float32). The gradient is
the same up to summation order.

In training with `cfg.remat`, decoder4/3/2 and decoder1 run under
torch.utils.checkpoint as in the JAX heads, and so does encoder1 (the JAX
head keeps its activations): at 160^3 the full-resolution blocks hold the
largest activations of the step.

Spans (tracing.py), each outside its piece's checkpoint with a mark on the
piece's output, so that a recomputation falls in the piece's `.bwd`:
nerf_mae.embed, the encoder's stages, nerf_mae.decoder4/3/2,
nerf_mae.encoder1, nerf_mae.decoder1 and nerf_mae.head (`sem_out`, or SR's
`voxel_out` and resize). Counters: `dense_head.voxels` (the voxels a head
scores, B x its output grid) and `dense_head.remat` (pieces run under
checkpoint).

On a space axis (`spatial`, parallel.spatial.set_spatial) the heads take
and return this rank's slabs in the even layout: encoder1 and decoder1 run
at full resolution on slabs, the nearest resize maps this rank's output
planes to the input planes they read (relayouting where those lie on
another rank), and every sum of the losses is global.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from nerf_mae_torch import tracing
from nerf_mae_torch.config import MAEConfig
from nerf_mae_torch.metrics import CountSum, one_rank
from nerf_mae_torch.models.mae import build_trunk, decode, embed_tokens, traced_piece
from nerf_mae_torch.models.unetr import UnetOutBlock3D, UnetResBlock3D, UnetrUpBlock3D
from nerf_mae_torch.parallel import spatial as sp

# the parameters grafted from a pretrained MAE into `base`: the trunk and
# decoder4/3/2 (the reference re-initializes only decoder1, out and the mask
# token: feature_extractor.py:2008-2012)
SR_TRUNK_KEYS = ("patch_partition", "stages", "decoder4", "decoder3", "decoder2")


REMAT = "dense_head.remat"  # the counter of the pieces run under checkpoint


class MAETrunkWithDecoder(nn.Module):
    """Patch embed + Swin encoder + the MAE's decoder4/3/2 -> [B, T, T, T, C]."""

    spatial = None  # the mesh on a space axis

    def __init__(self, cfg: MAEConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        build_trunk(self, cfg, device)

    def forward(self, grids: torch.Tensor, deterministic: bool = True,
                droppath_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        with tracing.span("nerf_mae.embed"):
            x = tracing.mark(embed_tokens(self.patch_partition, grids, self.cfg, self.spatial),
                             "nerf_mae.embed")
        return decode(self, self.stages(x, deterministic, droppath_generator), self.cfg.remat,
                      counter=REMAT)


class _DenseHead(nn.Module):
    """base + encoder1 + decoder1, shared by both heads. Parameters are
    created on `device` uninitialised: load a state dict or call
    models.mae.init_weights."""

    spatial = None  # the mesh on a space axis

    def __init__(self, cfg: MAEConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        e, dt, impl = cfg.swin.embed_dim, cfg.dtype, cfg.swin.attention_impl
        self.base = MAETrunkWithDecoder(cfg, device)
        self.encoder1 = UnetResBlock3D(cfg.input_channels, e // 2, dtype=dt,
                                       attention_impl=impl, device=device)
        self.decoder1 = UnetrUpBlock3D(e, e // 2, upsample_factor=cfg.swin.patch_size[0],
                                       use_skip=True, dtype=dt, attention_impl=impl,
                                       device=device)

    def forward(self, grids: torch.Tensor, deterministic: bool = True,
                droppath_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """grids [B, R, R, R, 4] -> the head's float32 output. A training
        forward (deterministic=False) draws the stochastic-depth keep factors
        from `droppath_generator`."""
        remat = self.cfg.remat
        enc1 = traced_piece("nerf_mae.encoder1", self, remat, self.encoder1,
                            grids.to(self.cfg.dtype), counter=REMAT)
        d = self.base(grids, deterministic, droppath_generator)
        d = traced_piece("nerf_mae.decoder1", self, remat, self.decoder1, d, enc1, counter=REMAT)
        with tracing.span("nerf_mae.head"):
            out = tracing.mark(self.head(d), "nerf_mae.head")
        if tracing.on():
            tracing.count("dense_head.voxels", math.prod(out.shape[:4]))
        return out


@functools.lru_cache(maxsize=16)
def nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """Source index of every output position of a nearest resize with
    half-pixel centres, computed as jax.image.resize(..., "nearest") does:
    floor((i + 0.5) * in / out) in float32. (F.interpolate's "nearest"
    takes floor(i * in / out), another source for 64 of 256 outputs at
    160 -> 256.)"""
    offsets = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
               * np.float32(in_size) / np.float32(out_size))
    return np.floor(offsets).astype(np.int64)


def nearest_resize(x: torch.Tensor, out_size: int, mesh=None) -> torch.Tensor:
    """[B, R, R, R, C] -> [B, out, out, out, C] by nearest_indices on each
    spatial axis (index_select, so the backward sums into each source). On
    a space axis (mesh) x is this rank's even slab of R planes and so is the
    result of out: its planes read input planes [first, last], relayouted
    here where they lie on another rank."""
    if mesh is not None:
        src = nearest_indices(sp.grid_len(x), out_size)
        outs = sp.even_bounds(out_size, mesh.space)
        need = tuple((int(src[a]), int(src[b - 1]) + 1) if b > a else (0, 0)
                     for a, b in outs)
        first = need[mesh.space_rank][0]
        x = sp.exchange(x, sp.even_bounds(sp.grid_len(x), mesh.space), need,
                        sp.grid_len(x), mesh)
        a, b = outs[mesh.space_rank]
        idx = torch.from_numpy(src[a:b] - first).to(x.device)
        x = x.index_select(1, idx)
        axes = (2, 3)
    else:
        axes = (1, 2, 3)
    for axis in axes:
        idx = torch.from_numpy(nearest_indices(x.shape[axis], out_size)).to(x.device)
        x = x.index_select(axis, idx)
    return x


class VoxelSR3D(_DenseHead):
    """R^3 rgbsigma -> out_resolution^3 rgbsigma super-resolution
    (reference: feature_extractor.py:1898-2243); float32 output."""

    def __init__(self, cfg: MAEConfig, out_resolution: int = 256, device="cuda"):
        super().__init__(cfg, device)
        self.out_resolution = out_resolution
        self.voxel_out = UnetOutBlock3D(cfg.swin.embed_dim // 2, 4, dtype=cfg.dtype,
                                        device=device)

    def head(self, d: torch.Tensor) -> torch.Tensor:
        """decoder1's output -> [B, R_out, R_out, R_out, 4] float32."""
        return nearest_resize(self.voxel_out(d).float(), self.out_resolution, self.spatial)


class VoxelSemantics3D(_DenseHead):
    """R^3 rgbsigma -> per-voxel class logits [B, R, R, R, num_classes]
    float32 (reference: feature_extractor.py:2521-2847)."""

    def __init__(self, cfg: MAEConfig, num_classes: int = 19, device="cuda"):
        super().__init__(cfg, device)
        self.num_classes = num_classes
        self.sem_out = UnetOutBlock3D(cfg.swin.embed_dim // 2, num_classes,
                                      dtype=cfg.dtype, device=device)

    def head(self, d: torch.Tensor) -> torch.Tensor:
        return self.sem_out(d).float()


def voxel_sr_loss(pred: torch.Tensor, target_hi: torch.Tensor,
                  count_sum: CountSum = one_rank):
    """Alpha-masked RGB MSE against the padded high-res target
    (reference: feature_extractor.py:2134-2161). Returns (loss, aux) with
    aux = {mse, psnr}: the numerator sums 3 channels and the loss divides by
    the voxel count, mse by the element count (kept as the JAX head has it).
    `count_sum` makes the voxel count global (the loss is then a rank's
    share) and the metrics' sums global (mse and psnr are the batch's)."""
    target_hi = target_hi.float()
    mask = (target_hi[..., 3:] > 0.01).float()
    se = ((pred[..., :3] - target_hi[..., :3]) ** 2 * mask).sum()
    se_all, n = count_sum(torch.stack([se.detach(), mask.sum()]))
    loss = se / torch.clamp(n, min=1.0)
    mse = se_all / torch.clamp(3 * n, min=1.0)
    return loss, {"mse": mse.detach(),
                  "psnr": -10.0 * torch.log10(torch.clamp(mse.detach(), min=1e-12))}


def voxel_semantics_loss(logits: torch.Tensor, target: torch.Tensor,
                         class_weights: Optional[torch.Tensor] = None,
                         count_sum: CountSum = one_rank):
    """Weighted masked cross-entropy + the soft-mIoU metric (reference:
    feature_extractor.py:2694-2746; metrics.py:540-553 masked_cross_entropy),
    as the JAX head computes them:

      * the logits are zeroed at void voxels (target 0), which stay in the
        mean: each adds log(num_classes) to the unweighted CE;
      * with class weights, nll is weighted by w[target], w[0] counting as
        given (0 from calculate_class_weights), over the sum of the weights;
      * soft mIoU (no gradient) from the softmax of the unmasked logits over
        the valid voxels, averaged over the classes present.

    logits [B, R, R, R, C] float32, target [B, R, R, R] int. `count_sum`
    makes the weight sum (or voxel count) and soft mIoU's per-class sums
    global: ce is then a rank's share, soft_miou the batch's. Returns (ce,
    {"ce", "soft_miou"})."""
    c = logits.shape[-1]
    valid = target > 0
    t = torch.where(valid, target, torch.zeros_like(target)).long()
    lg = logits * valid[..., None].to(logits.dtype)
    nll = -torch.log_softmax(lg, dim=-1).gather(-1, t[..., None])[..., 0]
    if class_weights is not None:
        w = class_weights.to(nll.device, torch.float32)[t]
        ce = (nll * w).sum() / torch.clamp(count_sum(w.sum()), min=1e-9)
    else:
        n = torch.tensor(float(nll.numel()), device=nll.device)
        ce = nll.sum() / count_sum(n)

    with torch.no_grad():
        m = valid.reshape(-1).float()
        flat_t = t.reshape(-1)
        probs = torch.softmax(logits.detach().reshape(-1, c).float(), dim=-1)
        p_sum = (probs * m[:, None]).sum(0)
        p_true = probs.gather(1, flat_t[:, None])[:, 0] * m
        inter = torch.zeros(c, device=logits.device).index_add_(0, flat_t, p_true)
        count = torch.zeros(c, device=logits.device).index_add_(0, flat_t, m)
        p_sum, inter, count = count_sum(torch.stack([p_sum, inter, count]))
        union = p_sum + count - inter
        present = count > 0
        iou = torch.where(present, inter / torch.clamp(union, min=1e-9),
                          torch.zeros_like(inter))
        miou = iou.sum() / torch.clamp(present.sum().float(), min=1.0)
    return ce, {"ce": ce.detach(), "soft_miou": miou}


def calculate_class_weights(label_grids, num_classes: int, c: float = 1.02) -> np.ndarray:
    """Log-propensity class weights from training label grids
    (reference: metrics.py:383-427): w_k = 1 / log(c + freq_k), void class
    zeroed."""
    counts = np.zeros(num_classes, np.float64)
    total = 0
    for grid in label_grids:
        flat = np.asarray(grid).reshape(-1)
        flat = flat[flat != 0]
        counts += np.bincount(flat, minlength=num_classes)[:num_classes]
        total += flat.size
    counts[0] = 0
    weights = 1.0 / np.log(c + counts / max(total, 1))
    weights[0] = 0.0
    return weights.astype(np.float32)


def intersection_and_union(pred_labels, target, num_classes: int,
                           ignore_zero: bool = True):
    """Hard confusion counts for mIoU/mAcc/allAcc eval
    (reference: metrics.py:491-538 intersectionAndUnionGPU), numpy on the
    host. Voxels with target 0 are excluded (void). The histograms span
    range=(0, num_classes - 1), as the reference's do."""
    pred_labels = np.asarray(pred_labels).reshape(-1)
    target = np.asarray(target).reshape(-1)
    if ignore_zero:
        keep = target > 0
        pred_labels, target = pred_labels[keep], target[keep]
    inter = pred_labels[pred_labels == target]
    area_inter = np.histogram(inter, bins=num_classes, range=(0, num_classes - 1))[0]
    area_pred = np.histogram(pred_labels, bins=num_classes, range=(0, num_classes - 1))[0]
    area_tgt = np.histogram(target, bins=num_classes, range=(0, num_classes - 1))[0]
    return area_inter, area_pred + area_tgt - area_inter, area_tgt
