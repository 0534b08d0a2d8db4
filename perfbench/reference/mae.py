"""Plain float32 NeRF-MAE (the benchmark's reference; torch and numpy only).

The masked autoencoder of arXiv 2404.01300 (reference code
nerf_mae/model/mae/swin_mae3d.py:1067-1599) with the subpixel decoder head of
the system under test: patch embedding, masked tokens replaced by a learned
mask token, the Swin trunk (swin.py), three UNETR up blocks (transposed
conv x2, skip concat, residual block of 3^3 convs with instance norms and
leaky ReLU), a residual block and a 3^3 projection to p^3 x 4 channels per
token, and the masked reconstruction loss: RGB MSE over voxels of target
alpha > 0.01 (three channels summed over a voxel count), sigmoid-alpha MSE
over valid voxels of masked tokens.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from . import swin
from .swin import Numerics, Params


def shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's name and shape."""
    e = cfg["embed_dim"]
    out = swin.trunk_shapes(cfg, "patch_partition.", "stages.")
    out["mask_token"] = (e,)
    for k, cin, cout in ((4, 8 * e, 4 * e), (3, 4 * e, 2 * e), (2, 2 * e, e)):
        d = f"decoder{k}."
        out[d + "transp_conv.weight"] = (cin, cout, 2, 2, 2)
        out[d + "transp_conv.bias"] = (cout,)
        out.update(res_shapes(d + "conv_block.", 2 * cout, cout))
    out.update(res_shapes("subpixel_head.res.", e, e))
    p = cfg["patch_size"]
    out["subpixel_head.proj.weight"] = (cfg["out_channels"] * p ** 3, e, 3, 3, 3)
    out["subpixel_head.proj.bias"] = (cfg["out_channels"] * p ** 3,)
    return out


def res_shapes(prefix: str, cin: int, cout: int) -> Dict[str, Tuple[int, ...]]:
    out = {prefix + "conv1.weight": (cout, cin, 3, 3, 3), prefix + "conv1.bias": (cout,),
           prefix + "conv2.weight": (cout, cout, 3, 3, 3), prefix + "conv2.bias": (cout,)}
    if cin != cout:
        out[prefix + "conv3.weight"] = (cout, cin, 1, 1, 1)
        out[prefix + "conv3.bias"] = (cout,)
    return out


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per sample and channel over the three spatial axes, no affine."""
    mu = x.mean(dim=(1, 2, 3), keepdim=True)
    var = ((x - mu) ** 2).mean(dim=(1, 2, 3), keepdim=True)
    return (x - mu) / torch.sqrt(var + eps)


def conv(x: torch.Tensor, p: Params, name: str, num: Numerics) -> torch.Tensor:
    """'SAME' stride-1 conv of a channel-last grid."""
    w = p[name + ".weight"]
    y = num.conv3d(x.permute(0, 4, 1, 2, 3), w, p[name + ".bias"], padding=w.shape[-1] // 2)
    return y.permute(0, 2, 3, 4, 1)


def res_block(x: torch.Tensor, p: Params, prefix: str, num: Numerics) -> torch.Tensor:
    lrelu = lambda t: F.leaky_relu(t, 0.01)
    h = lrelu(instance_norm(conv(x, p, prefix + "conv1", num)))
    h = instance_norm(conv(h, p, prefix + "conv2", num))
    r = instance_norm(conv(x, p, prefix + "conv3", num)) if prefix + "conv3.weight" in p else x
    return lrelu(h + r)


def up_block(x: torch.Tensor, skip: torch.Tensor, p: Params, prefix: str,
             num: Numerics) -> torch.Tensor:
    y = num.conv_transpose3d(x.permute(0, 4, 1, 2, 3), p[prefix + "transp_conv.weight"],
                             p[prefix + "transp_conv.bias"], stride=2).permute(0, 2, 3, 4, 1)
    return res_block(torch.cat([y, skip], -1), p, prefix + "conv_block.", num)


def forward(p: Params, grids: torch.Tensor, token_mask: torch.Tensor, cfg: dict,
            keeps: List[List[torch.Tensor]], num: Numerics) -> torch.Tensor:
    """grids [B, R, R, R, 4], token_mask [B, T, T, T] (True = masked) ->
    prediction in patch order [B, T, T, T, p^3, 4] (alpha before sigmoid)."""
    x = swin.embed(grids, p, "patch_partition.", cfg, num)
    x = torch.where(token_mask[..., None], p["mask_token"], x)
    f = swin.encoder(x, p, "stages.", cfg, keeps, num)
    d = up_block(f[3], f[2], p, "decoder4.", num)
    d = up_block(d, f[1], p, "decoder3.", num)
    d = up_block(d, f[0], p, "decoder2.", num)
    h = conv(res_block(d, p, "subpixel_head.res.", num), p, "subpixel_head.proj", num)
    b, t = h.shape[0], h.shape[1]
    return h.reshape(b, t, t, t, cfg["patch_size"] ** 3, cfg["out_channels"])


def patchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, R, R, R, C] -> [B, T, T, T, p^3, C], voxels of a patch row-major."""
    b, r, _, _, c = x.shape
    t = r // patch
    x = x.reshape(b, t, patch, t, patch, t, patch, c).permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b, t, t, t, patch ** 3, c)


def valid_voxels(sizes: torch.Tensor, r: int) -> torch.Tensor:
    """[B, R, R, R] bool: inside each scene's un-padded extent."""
    i = torch.arange(r, device=sizes.device)
    return ((i[None, :, None, None] < sizes[:, 0, None, None, None])
            & (i[None, None, :, None] < sizes[:, 1, None, None, None])
            & (i[None, None, None, :] < sizes[:, 2, None, None, None]))


def loss_sums(pred: torch.Tensor, grids: torch.Tensor, token_mask: torch.Tensor,
              sizes: torch.Tensor, cfg: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two loss terms' numerators over the rows given."""
    tgt = patchify(grids, cfg["patch_size"])
    valid = patchify(valid_voxels(sizes, cfg["resolution"])[..., None].float(),
                     cfg["patch_size"])
    removed = valid * token_mask[..., None, None].float()
    alpha_mask = (tgt[..., 3:] > 0.01).float()
    return (((pred[..., :3] - tgt[..., :3]) ** 2 * alpha_mask).sum(),
            ((torch.sigmoid(pred[..., 3:]) - tgt[..., 3:]) ** 2 * removed).sum())


def counts(grids: torch.Tensor, token_mask: torch.Tensor, sizes: torch.Tensor,
           cfg: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """The batch's two loss denominators: voxels of alpha > 0.01, and valid
    voxels of masked tokens."""
    up = token_mask
    for axis in (1, 2, 3):
        up = up.repeat_interleave(cfg["patch_size"], dim=axis)
    return ((grids[..., 3] > 0.01).sum(),
            (valid_voxels(sizes, cfg["resolution"]) & up).sum())


def loss_and_grads(p: Params, grids: torch.Tensor, sizes: torch.Tensor,
                   token_mask: torch.Tensor, keeps, cfg: dict, num: Numerics,
                   rows_per_pass: int):
    """The batch's loss, the gradient of every parameter and the loss's two
    terms, computed
    `rows_per_pass` rows at a time (every operation is per sample, the two
    counts are the batch's), so that a batch fits in float32."""
    n_rgb, n_alpha = (max(float(c), 1.0) for c in counts(grids, token_mask, sizes, cfg))
    grads = {k: torch.zeros_like(v) for k, v in p.items()}
    total, terms = 0.0, {"loss_rgb": 0.0, "loss_alpha": 0.0}
    for s in range(0, grids.shape[0], rows_per_pass):
        rows = slice(s, s + rows_per_pass)
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        pred = forward(leaves, grids[rows], token_mask[rows], cfg, swin.rows_of(keeps, rows), num)
        rgb, alpha = loss_sums(pred, grids[rows], token_mask[rows], sizes[rows], cfg)
        loss = rgb / n_rgb + alpha / n_alpha
        names = [k for k in leaves]
        got = torch.autograd.grad(loss, [leaves[k] for k in names], allow_unused=True)
        for k, g in zip(names, got):
            if g is not None:
                grads[k] += g
        total += float(loss.detach())
        terms["loss_rgb"] += float(rgb.detach()) / n_rgb
        terms["loss_alpha"] += float(alpha.detach()) / n_alpha
        del pred, rgb, alpha, loss, got, leaves
    return total, grads, terms
