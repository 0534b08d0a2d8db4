"""Plain float32 NeRF-MAE voxel semantic segmentation (the benchmark's
reference; torch and numpy only).

The voxel semantics head of arXiv 2404.01300 over the MAE trunk (reference
code nerf_rpn/model/feature_extractor.py:2521-2847,
SwinTransformer_VoxelSemantics_Pretrained_Skip): the trunk (swin.py) and
the MAE's UNETR decoders 4/3/2 (mae.py) under `base.`; `encoder1`, a
residual block (3^3 conv -> instance norm -> leaky ReLU -> 3^3 conv ->
instance norm, plus a 1x1 conv and instance norm as the shortcut, leaky
ReLU) on the raw R^3 grid, 4 -> E/2 channels; `decoder1`, a transposed
conv with stride = kernel = patch (E -> E/2, one input voxel per output
voxel), its output concatenated with encoder1's, and a residual block
E -> E/2; `sem_out`, a 1x1 conv to the classes' logits at R^3. The loss is
the class-weighted cross-entropy; soft mIoU is reported beside it.

Departures from the published head, each as the system under test states
it (nerf_mae_torch/models/heads.py, voxel_semantics_loss,
calculate_class_weights):
- the logits of void voxels (label 0) are zeroed before the softmax and
  those voxels stay in the sum, weighted by the void class's weight (0 from
  the class weights), so they add nothing to the weighted loss;
- the weighted cross-entropy divides by the summed weights of the batch's
  voxels (the weighted mean), over the whole batch when it is computed in
  row blocks;
- soft mIoU has no gradient: from the softmax of the unzeroed logits over
  the non-void voxels, per class intersection over union, averaged over the
  classes present in the batch's labels;
- the class weights are 1 / log(1.02 + freq) over the non-void voxels of
  the training labels, void's weight 0, in numpy;
- the trunk has mae.py's departures (no mask token: every token is seen).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from . import mae, swin
from .swin import Numerics, Params


def shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's name and shape, as the system's state dict names
    them."""
    e, half = cfg["embed_dim"], cfg["embed_dim"] // 2
    out = swin.trunk_shapes(cfg, "base.patch_partition.", "base.stages.")
    for k, cin, cout in ((4, 8 * e, 4 * e), (3, 4 * e, 2 * e), (2, 2 * e, e)):
        d = f"base.decoder{k}."
        out[d + "transp_conv.weight"] = (cin, cout, 2, 2, 2)
        out[d + "transp_conv.bias"] = (cout,)
        out.update(mae.res_shapes(d + "conv_block.", 2 * cout, cout))
    out.update(mae.res_shapes("encoder1.", cfg["input_channels"], half))
    p = cfg["patch_size"]
    out["decoder1.transp_conv.weight"] = (e, half, p, p, p)
    out["decoder1.transp_conv.bias"] = (half,)
    out.update(mae.res_shapes("decoder1.conv_block.", 2 * half, half))
    out["sem_out.conv.weight"] = (cfg["num_classes"], half, 1, 1, 1)
    out["sem_out.conv.bias"] = (cfg["num_classes"],)
    return out


def class_weights(labels: np.ndarray, num_classes: int, c: float = 1.02) -> np.ndarray:
    """[num_classes] float32: 1 / log(c + freq_k), freq over the non-void
    voxels of all `labels`; void's weight 0."""
    flat = np.asarray(labels).reshape(-1)
    flat = flat[flat != 0]
    counts = np.bincount(flat, minlength=num_classes)[:num_classes].astype(np.float64)
    w = 1.0 / np.log(c + counts / max(flat.size, 1))
    w[0] = 0.0
    return w.astype(np.float32)


def upsample_block(x: torch.Tensor, skip: torch.Tensor, p: Params, prefix: str, stride: int,
                   num: Numerics) -> torch.Tensor:
    """Transposed conv (stride = kernel), skip concat, residual block."""
    y = num.conv_transpose3d(x.permute(0, 4, 1, 2, 3), p[prefix + "transp_conv.weight"],
                             p[prefix + "transp_conv.bias"], stride=stride)
    return mae.res_block(torch.cat([y.permute(0, 2, 3, 4, 1), skip], -1), p,
                         prefix + "conv_block.", num)


def forward(p: Params, grids: torch.Tensor, cfg: dict, keeps: List[List[torch.Tensor]],
            num: Numerics) -> torch.Tensor:
    """grids [B, R, R, R, 4] -> logits [B, R, R, R, num_classes]."""
    enc1 = mae.res_block(grids, p, "encoder1.", num)
    f = swin.encoder(swin.embed(grids, p, "base.patch_partition.", cfg, num), p,
                     "base.stages.", cfg, keeps, num)
    d = mae.up_block(f[3], f[2], p, "base.decoder4.", num)
    d = mae.up_block(d, f[1], p, "base.decoder3.", num)
    d = mae.up_block(d, f[0], p, "base.decoder2.", num)
    d = upsample_block(d, enc1, p, "decoder1.", cfg["patch_size"], num)
    return mae.conv(d, p, "sem_out.conv", num)


def weighted_nll_sum(logits: torch.Tensor, labels: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """Sum over the voxels of w[label] * -log softmax(logits zeroed at void)[label]."""
    valid = (labels > 0)[..., None].to(logits.dtype)
    nll = -torch.log_softmax(logits * valid, -1).gather(-1, labels[..., None])[..., 0]
    return (nll * weights[labels]).sum()


def miou_sums(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """[3, C]: per class, the summed probability over non-void voxels, the
    summed probability of the true class, and the count of its voxels."""
    c = logits.shape[-1]
    probs = torch.softmax(logits.detach().reshape(-1, c), -1)
    t = labels.reshape(-1)
    m = (t > 0).to(probs.dtype)
    p_true = probs.gather(1, t[:, None])[:, 0] * m
    return torch.stack([(probs * m[:, None]).sum(0),
                        torch.zeros(c, device=t.device).index_add_(0, t, p_true),
                        torch.zeros(c, device=t.device).index_add_(0, t, m)])


def soft_miou(sums: torch.Tensor) -> float:
    p_sum, inter, count = sums
    present = count > 0
    iou = torch.where(present, inter / torch.clamp(p_sum + count - inter, min=1e-9),
                      torch.zeros_like(inter))
    return float(iou.sum() / torch.clamp(present.sum().to(iou.dtype), min=1.0))


def loss_and_grads(p: Params, grids: torch.Tensor, labels: torch.Tensor, keeps,
                   weights: torch.Tensor, cfg: dict, num: Numerics, rows_per_pass: int):
    """The batch's loss, the gradient of every parameter and the terms
    (ce, soft_miou), computed `rows_per_pass` rows at a time (every
    operation is per sample; the weight sum and the mIoU sums are the
    batch's), so that a batch fits in float32."""
    labels = labels.long()
    w_sum = max(float(weights[labels].sum()), 1e-9)
    grads = {k: torch.zeros_like(v) for k, v in p.items()}
    total, sums = 0.0, 0.0
    for s in range(0, grids.shape[0], rows_per_pass):
        rows = slice(s, s + rows_per_pass)
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        logits = forward(leaves, grids[rows], cfg, swin.rows_of(keeps, rows), num)
        loss = weighted_nll_sum(logits, labels[rows], weights) / w_sum
        sums = sums + miou_sums(logits, labels[rows])
        names = list(leaves)
        got = torch.autograd.grad(loss, [leaves[k] for k in names], allow_unused=True)
        for k, g in zip(names, got):
            if g is not None:
                grads[k] += g
        total += float(loss.detach())
        del logits, loss, got, leaves
    return total, grads, {"ce": total, "soft_miou": soft_miou(sums)}
