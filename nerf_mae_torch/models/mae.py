"""SwinMAE3D, the masked-autoencoder model (counterpart of
nerf_mae_tpu/models/mae.py).

The reference's SwinTransformer_MAE3D_New
(reference: nerf_mae/model/mae/swin_mae3d.py:1067-1599): 4^3/s4 patch
embedding, fixed 3D sincos position embedding, learned mask token, 4-stage
Swin encoder, UNETR skip decoder (or the subpixel head), and the masked
reconstruction loss. Channel-last [B, R, R, R, 4] batches with `sizes
[B, 3]`; float32 parameters named after the reference state_dict, compute
in `cfg.dtype`.

On a space axis (`spatial`, parallel.spatial.set_spatial) the model takes
and returns this rank's slab of axis 1 (the even layout): the position
embedding's rows at the slab's offset, the token mask drawn for the whole
grid and sliced, and the loss's validity mask in global coordinates.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from nerf_mae_torch import tracing
from nerf_mae_torch.config import MAEConfig
from nerf_mae_torch.metrics import CountSum, one_rank
from nerf_mae_torch.models.swin import (
    Norm,
    SwinEncoder3D,
    flax_layer_norm,
    remat_call,
)
from nerf_mae_torch.models.unetr import (
    Conv3d,
    SubpixelHead3D,
    UnetOutBlock3D,
    UnetrUpBlock3D,
)
from nerf_mae_torch.ops.masking import block_mask_3d
from nerf_mae_torch.ops.patchify import (
    maybe_unflatten_patches,
    patchify_3d,
    voxel_validity_mask,
)
from nerf_mae_torch.ops.pos_embed import sincos_pos_embed_3d
from nerf_mae_torch.ops.window_attention import mm_f32
from nerf_mae_torch.parallel import spatial as sp


@functools.lru_cache(maxsize=8)
def pos_embed_tensor(dim: int, grid: int, device: torch.device,
                     dtype: torch.dtype) -> torch.Tensor:
    """sincos_pos_embed_3d on `device` in `dtype`, made once per key (a
    normal tensor even when first asked for under inference_mode)."""
    with torch.inference_mode(False):
        emb = torch.from_numpy(np.array(sincos_pos_embed_3d(dim, grid)))
        return emb.to(device=device, dtype=dtype)


def patch_embed(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """Patch embedding over ONE weight [E, Cin, p, p, p] (reference
    `patch_partition.0`), two equivalent paths:

      * voxel grid [B, R, R, R, Cin]: conv with kernel = stride = p;
      * patched [B, T, T, T, p^3, Cin]: one [.., p^3 * Cin] @ [p^3 * Cin, E]
        product (patchify_3d's (i, j, k) C-order flatten matches the
        kernel layout).
    """
    p = weight.shape[-1]
    e = weight.shape[0]
    if x.ndim == 6:
        k = weight.to(dtype).permute(2, 3, 4, 1, 0).reshape(-1, e)
        flat = x.to(dtype).reshape(*x.shape[:4], -1)
        return mm_f32(flat, k).to(dtype) + bias.to(dtype)
    y = torch.nn.functional.conv3d(
        x.to(dtype).permute(0, 4, 1, 2, 3), weight.to(dtype), stride=p)
    return y.permute(0, 2, 3, 4, 1) + bias.to(dtype)


def build_trunk(model: nn.Module, cfg: MAEConfig, device) -> None:
    """The MAE trunk and its decoders 4/3/2 onto `model` (SwinMAE3D, the
    dense heads' `base`), under the reference's names: `patch_partition`
    (the patch embedding's conv and LayerNorm), `stages` (remat_stages, or
    cfg.remat on every stage where unset) and `decoder4..2`, whose res
    blocks take cfg.swin.attention_impl."""
    e, dt = cfg.swin.embed_dim, cfg.dtype
    model.patch_partition = nn.ModuleDict({
        "0": Conv3d(cfg.input_channels, e, cfg.swin.patch_size[0], device=device),
        "2": Norm(e, device=device),
    })
    remat_stages = cfg.remat_stages
    if remat_stages is None:
        remat_stages = (cfg.remat,) * len(cfg.swin.depths)
    model.stages = SwinEncoder3D(cfg.swin, dtype=dt, device=device,
                                 remat_stages=remat_stages, remat_policy=cfg.remat_policy)
    up = functools.partial(UnetrUpBlock3D, dtype=dt, attention_impl=cfg.swin.attention_impl,
                           device=device)
    model.decoder4, model.decoder3 = up(8 * e, 4 * e), up(4 * e, 2 * e)
    model.decoder2 = up(2 * e, e)


def maybe_remat(model: nn.Module, remat: bool, fn, *args, counter: Optional[str] = None):
    """fn(*args), under torch.utils.checkpoint with model.cfg.remat_policy
    where `remat` and grad mode are on (recomputed whole on a space axis,
    model.spatial: its collectives run on every rank), each such run
    added to the counter `counter` (tracing.count)."""
    if remat and torch.is_grad_enabled():
        if counter:
            tracing.count(counter)
        return remat_call(fn, model.cfg.remat_policy, *args, early_stop=model.spatial is None)
    return fn(*args)


def traced_piece(name: str, model: nn.Module, remat: bool, fn, *args,
                 counter: Optional[str] = None):
    """maybe_remat(...) inside the span `name`, its output marked for the
    piece's backward record (a recomputation falls in the piece's `.bwd`)."""
    with tracing.span(name):
        return tracing.mark(maybe_remat(model, remat, fn, *args, counter=counter), name)


def decode(model: nn.Module, features: List[torch.Tensor], remat: bool,
           counter: Optional[str] = None) -> torch.Tensor:
    """decoder4/3/2 of `model` (build_trunk's) over the encoder's feature
    pyramid, each a traced_piece in its span nerf_mae.decoder{4,3,2}."""
    d = features[3]
    for i in (4, 3, 2):
        d = traced_piece(f"nerf_mae.decoder{i}", model, remat, getattr(model, f"decoder{i}"),
                         d, features[i - 2], counter=counter)
    return d


def embed_tokens(patch_partition: nn.ModuleDict, grids: torch.Tensor,
                 cfg: MAEConfig, mesh=None) -> torch.Tensor:
    """Patch-embed + LayerNorm + pos-embed -> [B, T, T, T, C]. Takes the
    voxel grid [B, R, R, R, 4], its patched form [B, T, T, T, p^3, 4] or
    the channel-flat patched form [B, T, T, T, p^3 * 4]; on a space axis
    (mesh) their slabs, and the position embedding's rows of the slab."""
    dt = cfg.dtype
    grids = maybe_unflatten_patches(grids, cfg.swin.patch_size[0], cfg.input_channels)
    conv, norm = patch_partition["0"], patch_partition["2"]
    x = patch_embed(grids, conv.weight, conv.bias, dt)
    x = flax_layer_norm(x, norm.weight, norm.bias, cfg.swin.norm_eps).to(dt)
    pos = pos_embed_tensor(cfg.swin.embed_dim, sp.grid_len(x), x.device, dt)
    return x + sp.take_slab(pos, mesh)


class SwinMAE3D(nn.Module):
    """Masked reconstruction (`forward`) and the unmasked feature pyramid
    (`encode`). Parameters are created on `device` (default: the CUDA card)
    uninitialised: load a state dict or call `init_weights`."""

    spatial = None  # the mesh on a space axis (module doc)

    def __init__(self, cfg: MAEConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        dt, e, impl = cfg.dtype, cfg.swin.embed_dim, cfg.swin.attention_impl
        p = cfg.swin.patch_size[0]
        build_trunk(self, cfg, device)
        self.mask_token = nn.Parameter(torch.empty(e, device=device))
        if cfg.decoder_type == "subpixel":
            self.subpixel_head = SubpixelHead3D(e, cfg.out_channels, patch=p, dtype=dt,
                                                attention_impl=impl, device=device)
        else:
            self.decoder1 = UnetrUpBlock3D(e, e // 2, upsample_factor=p, use_skip=False,
                                           dtype=dt, attention_impl=impl, device=device)
            self.out = UnetOutBlock3D(e // 2, cfg.out_channels, dtype=dt,
                                      device=device)

    def embed(self, grids: torch.Tensor) -> torch.Tensor:
        """embed_tokens through this model's patch embedding."""
        return embed_tokens(self.patch_partition, grids, self.cfg, self.spatial)

    def forward(
        self,
        grids: torch.Tensor,
        deterministic: bool = True,
        token_mask: Optional[torch.Tensor] = None,  # [B, T, T, T] bool
        generator: Optional[torch.Generator] = None,
        patched_pred: bool = False,
        droppath_generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (pred [B, R, R, R, 4] float32, or its patchify_3d
        permutation when patched_pred, and token_mask [B, T, T, T] bool).
        Without token_mask the mask is drawn from `generator`, which is
        then required. A training forward (deterministic=False) draws the
        stochastic-depth keep factors from `droppath_generator`. On a space
        axis grids, pred and token_mask are this rank's slabs; a drawn mask
        is drawn whole and sliced. Spans (tracing.py): nerf_mae.embed (the
        embedding and the mask), the encoder's stages, nerf_mae.decoder4/3/2
        and nerf_mae.head, each output marked for its backward."""
        cfg = self.cfg
        with tracing.span("nerf_mae.embed"):
            x = self.embed(grids)
            if token_mask is None:
                if generator is None:
                    raise ValueError("pass token_mask or a generator to draw it")
                token_mask = block_mask_3d(
                    generator, grids.shape[0], cfg.token_grid,
                    block=cfg.mask_block, p_remove=cfg.masking_prob,
                    strategy=cfg.masking_strategy, per_sample=cfg.per_sample_mask,
                )
                token_mask = sp.take_slab(token_mask, self.spatial)
            token_mask = token_mask.to(x.device)
            # masked tokens (position embedding included) become the mask
            # token (reference: swin_mae3d.py:1461-1463, 1375-1380)
            x = torch.where(token_mask[..., None], self.mask_token.to(cfg.dtype), x)
            x = tracing.mark(x, "nerf_mae.embed")

        remat = cfg.decoder_remat
        d = decode(self, self.stages(x, deterministic, droppath_generator), remat)
        with tracing.span("nerf_mae.head"):
            if cfg.decoder_type == "subpixel":
                pred = maybe_remat(self, remat,
                                   lambda t: self.subpixel_head(t, patched=patched_pred), d)
            else:
                pred = self.out(maybe_remat(self, remat, self.decoder1, d))
                if patched_pred:
                    pred = patchify_3d(pred, cfg.swin.patch_size[0])
            pred = tracing.mark(pred.float(), "nerf_mae.head")
        return pred, token_mask

    def encode(self, grids: torch.Tensor,
               deterministic: bool = True) -> List[torch.Tensor]:
        """Unmasked feature pyramid for downstream backbones
        (reference: feature_extractor.py:1155-1176)."""
        return self.stages(self.embed(grids), deterministic)


def _trunc_normal(shape, std, gen, device):
    t = torch.empty(shape, device=device)
    return torch.nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                       generator=gen)


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Random weights from `seed` for SwinMAE3D or a downstream head (the
    trunk under any prefix), after the JAX package's initialisers:
    truncated normal(0.02) for attention, merge and mask-token weights and
    the bias table, xavier-uniform linears with ~0 biases for the MLP,
    LayerNorm ones/zeros, fan-in normal convs with zero biases."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if ".norm" in name or "patch_partition.2." in f".{name}":  # LayerNorms
            p.fill_(1.0 if leaf == "weight" else 0.0)
        elif ".mlp." in name:
            if leaf == "weight":
                fan_out, fan_in = p.shape
                lim = (6.0 / (fan_in + fan_out)) ** 0.5
                p.uniform_(-lim, lim, generator=gen)
            else:
                p.normal_(0.0, 1e-6, generator=gen)
        elif p.ndim == 5:  # conv kernels, fan-in normal
            fan_in = (p[:, 0] if "transp_conv" in name else p[0]).numel()
            p.normal_(0.0, fan_in ** -0.5, generator=gen)
        elif leaf == "bias":  # conv and attention biases
            p.zero_()
        else:  # attention weights, bias tables, reductions, mask token
            p.copy_(_trunc_normal(p.shape, 0.02, gen, dev))
    return model


def mae_loss(
    pred: torch.Tensor,  # [B, R, R, R, 4] raw output (alpha pre-sigmoid)
    target: torch.Tensor,  # [B, R, R, R, 4] padded rgbsigma (alpha in [0, 1])
    token_mask: torch.Tensor,  # [B, T, T, T] bool, True = masked
    sizes: torch.Tensor,  # [B, 3] true scene extents
    cfg: MAEConfig,
    count_sum: CountSum = one_rank,
    mesh=None,
):  # pred/target also accepted pre-patchified [B, T, T, T, p^3, 4]
    """The reference's masked-reconstruction loss, exactly
    (reference: swin_mae3d.py:1513-1563):

      * RGB: MSE over all voxels with target alpha > 0.01; the numerator
        sums 3 channels while the denominator counts voxels once (kept
        verbatim);
      * alpha: sigmoid, then MSE over voxels both inside the valid extent
        and in a masked token patch.

    `count_sum` makes both voxel counts global before their clamps (a
    data-parallel rank's share of the global loss, metrics.py). Returns
    (loss, aux) with aux = {loss_rgb, loss_alpha, n_rgb, n_alpha}, the
    counts of the rows given. On a space axis (mesh) the tensors are this
    rank's slabs and the validity mask is taken at the slab's planes.
    """
    p = cfg.swin.patch_size[0]
    pred = pred.float()
    target = maybe_unflatten_patches(target, p, cfg.input_channels).float()
    pred_p = pred if pred.ndim == 6 else patchify_3d(pred, p)
    tgt_p = target if target.ndim == 6 else patchify_3d(target, p)

    rows = sp.grid_slab(cfg.token_grid, mesh)
    valid = voxel_validity_mask(sizes, cfg.resolution,
                                (p * rows.start, p * rows.stop))  # [B, R, R, R]
    valid_p = patchify_3d(valid[..., None].float(), p)[..., 0]
    mask_remove = valid_p * token_mask[..., None].float()

    tgt_rgb, tgt_alpha = tgt_p[..., :3], tgt_p[..., 3:]
    pred_rgb, pred_alpha = pred_p[..., :3], pred_p[..., 3:]

    alpha_mask = (tgt_alpha > 0.01).float()
    mr = mask_remove[..., None]
    n_rgb, n_alpha = alpha_mask.sum(), mr.sum()
    total_rgb, total_alpha = count_sum(torch.stack([n_rgb, n_alpha]))
    loss_rgb = ((pred_rgb - tgt_rgb) ** 2 * alpha_mask).sum() / torch.clamp(
        total_rgb, min=1.0)

    pred_alpha = torch.sigmoid(pred_alpha)
    loss_alpha = ((pred_alpha - tgt_alpha) ** 2 * mr).sum() / torch.clamp(
        total_alpha, min=1.0)

    loss = loss_rgb + loss_alpha
    return loss, {
        "loss_rgb": loss_rgb,
        "loss_alpha": loss_alpha,
        "n_rgb": n_rgb,
        "n_alpha": n_alpha,
    }


def pad_grids_to_batch(
    grids: List[np.ndarray], resolution: int, channel_first: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad each (4, H, W, D) [or (H, W, D, 4)] scene to resolution^3 and
    stack (reference: swin_mae3d.py:1571-1574). Returns
    (batch [B, R, R, R, 4] float32, sizes [B, 3] int32)."""
    batch = np.zeros(
        (len(grids), resolution, resolution, resolution, 4), dtype=np.float32
    )
    sizes = np.zeros((len(grids), 3), dtype=np.int32)
    for i, g in enumerate(grids):
        g = np.asarray(g, dtype=np.float32)
        if channel_first and g.shape[0] == 4:
            g = np.moveaxis(g, 0, -1)
        h, w, d = g.shape[:3]
        batch[i, :h, :w, :d, :] = g
        sizes[i] = (h, w, d)
    return batch, sizes
