"""Downstream dense heads: voxel super-resolution and voxel semantics
(counterpart of nerf_mae_tpu/models/heads.py).

The reference's SwinTransformer_VoxelSR_* and SwinTransformer_VoxelSemantics_*
families (reference: nerf_rpn/model/feature_extractor.py:1310-3974). Both
reuse the pretrained MAE trunk AND its decoder4/3/2, under `base` with the
MAE's own names (`base.patch_partition`, `base.stages`, `base.decoder4..2`),
so a MAE state dict grafts by prefix (train/checkpoint.py:graft_mae). Then:

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
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch import nn

from nerf_mae_torch.config import MAEConfig
from nerf_mae_torch.models.mae import embed_tokens, make_patch_partition
from nerf_mae_torch.models.swin import SwinEncoder3D, remat_call
from nerf_mae_torch.models.unetr import UnetOutBlock3D, UnetResBlock3D, UnetrUpBlock3D

# the parameters grafted from a pretrained MAE into `base`: the trunk and
# decoder4/3/2 (the reference re-initializes only decoder1, out and the mask
# token: feature_extractor.py:2008-2012)
SR_TRUNK_KEYS = ("patch_partition", "stages", "decoder4", "decoder3", "decoder2")


def maybe_remat(cfg: MAEConfig, module, *args):
    """module(*args), under torch.utils.checkpoint in training with cfg.remat."""
    if cfg.remat and torch.is_grad_enabled():
        return remat_call(module, cfg.remat_policy, *args)
    return module(*args)


class MAETrunkWithDecoder(nn.Module):
    """Patch embed + Swin encoder + the MAE's decoder4/3/2 -> [B, T, T, T, C]."""

    def __init__(self, cfg: MAEConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        e, dt = cfg.swin.embed_dim, cfg.dtype
        self.patch_partition = make_patch_partition(cfg, device)
        remat_stages = cfg.remat_stages
        if remat_stages is None:
            remat_stages = (cfg.remat,) * len(cfg.swin.depths)
        self.stages = SwinEncoder3D(cfg.swin, dtype=dt, device=device,
                                    remat_stages=remat_stages,
                                    remat_policy=cfg.remat_policy)
        self.decoder4 = UnetrUpBlock3D(e * 8, e * 4, dtype=dt, device=device)
        self.decoder3 = UnetrUpBlock3D(e * 4, e * 2, dtype=dt, device=device)
        self.decoder2 = UnetrUpBlock3D(e * 2, e, dtype=dt, device=device)

    def forward(self, grids: torch.Tensor, deterministic: bool = True,
                droppath_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        f = self.stages(embed_tokens(self.patch_partition, grids, self.cfg),
                        deterministic, droppath_generator)
        d = maybe_remat(self.cfg, self.decoder4, f[3], f[2])
        d = maybe_remat(self.cfg, self.decoder3, d, f[1])
        return maybe_remat(self.cfg, self.decoder2, d, f[0])


class _DenseHead(nn.Module):
    """base + encoder1 + decoder1, shared by both heads. Parameters are
    created on `device` uninitialised: load a state dict or call
    models.mae.init_weights."""

    def __init__(self, cfg: MAEConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        e, dt = cfg.swin.embed_dim, cfg.dtype
        self.base = MAETrunkWithDecoder(cfg, device)
        self.encoder1 = UnetResBlock3D(cfg.input_channels, e // 2, dtype=dt, device=device)
        self.decoder1 = UnetrUpBlock3D(e, e // 2, upsample_factor=cfg.swin.patch_size[0],
                                       use_skip=True, dtype=dt, device=device)

    def forward(self, grids: torch.Tensor, deterministic: bool = True,
                droppath_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """grids [B, R, R, R, 4] -> the head's float32 output. A training
        forward (deterministic=False) draws the stochastic-depth keep factors
        from `droppath_generator`."""
        enc1 = maybe_remat(self.cfg, self.encoder1, grids.to(self.cfg.dtype))
        d = self.base(grids, deterministic, droppath_generator)
        return self.head(maybe_remat(self.cfg, self.decoder1, d, enc1))


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


def nearest_resize(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """[B, R, R, R, C] -> [B, out, out, out, C] by nearest_indices on each
    spatial axis (index_select, so the backward sums into each source)."""
    for axis in (1, 2, 3):
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
        return nearest_resize(self.voxel_out(d).float(), self.out_resolution)


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


def voxel_sr_loss(pred: torch.Tensor, target_hi: torch.Tensor):
    """Alpha-masked RGB MSE against the padded high-res target
    (reference: feature_extractor.py:2134-2161). Returns (loss, aux) with
    aux = {mse, psnr}: the numerator sums 3 channels and the loss divides by
    the voxel count, mse by the element count (kept as the JAX head has it)."""
    target_hi = target_hi.float()
    mask = (target_hi[..., 3:] > 0.01).float()
    se = ((pred[..., :3] - target_hi[..., :3]) ** 2 * mask).sum()
    loss = se / torch.clamp(mask.sum(), min=1.0)
    mse = se / torch.clamp(3 * mask.sum(), min=1.0)
    return loss, {"mse": mse.detach(),
                  "psnr": -10.0 * torch.log10(torch.clamp(mse.detach(), min=1e-12))}


def voxel_semantics_loss(logits: torch.Tensor, target: torch.Tensor,
                         class_weights: Optional[torch.Tensor] = None):
    """Weighted masked cross-entropy + the soft-mIoU metric (reference:
    feature_extractor.py:2694-2746; metrics.py:540-553 masked_cross_entropy),
    as the JAX head computes them:

      * the logits are zeroed at void voxels (target 0), which stay in the
        mean: each adds log(num_classes) to the unweighted CE;
      * with class weights, nll is weighted by w[target], w[0] counting as
        given (0 from calculate_class_weights), over the sum of the weights;
      * soft mIoU (no gradient) from the softmax of the unmasked logits over
        the valid voxels, averaged over the classes present.

    logits [B, R, R, R, C] float32, target [B, R, R, R] int. Returns
    (ce, {"ce", "soft_miou"})."""
    c = logits.shape[-1]
    valid = target > 0
    t = torch.where(valid, target, torch.zeros_like(target)).long()
    lg = logits * valid[..., None].to(logits.dtype)
    nll = -torch.log_softmax(lg, dim=-1).gather(-1, t[..., None])[..., 0]
    if class_weights is not None:
        w = class_weights.to(nll.device, torch.float32)[t]
        ce = (nll * w).sum() / torch.clamp(w.sum(), min=1e-9)
    else:
        ce = nll.mean()

    with torch.no_grad():
        m = valid.reshape(-1).float()
        flat_t = t.reshape(-1)
        probs = torch.softmax(logits.detach().reshape(-1, c).float(), dim=-1)
        p_sum = (probs * m[:, None]).sum(0)
        p_true = probs.gather(1, flat_t[:, None])[:, 0] * m
        inter = torch.zeros(c, device=logits.device).index_add_(0, flat_t, p_true)
        count = torch.zeros(c, device=logits.device).index_add_(0, flat_t, m)
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
