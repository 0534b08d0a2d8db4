"""3D Swin transformer trunk, channel-last (counterpart of
nerf_mae_tpu/models/swin.py).

SwinTransformerBlock / PatchMerging / stage pipeline of the reference
(reference: nerf_mae/model/mae/swin_mae3d.py:310-414, 1131-1172) on
[B, H, W, D, C] tensors. Parameters are float32 and named after the
reference torch state_dict (`norm1`, `attn.qkv`, `attn.proj`,
`attn.relative_position_bias_table`, `norm2`, `mlp.0`, `mlp.3`; the
merges' `norm` and `reduction`), so a reference checkpoint loads as is.

Dispatch per block, as in the JAX package (swin.py:117-132,176-238):
with the kernels wanted (kernels.wanted: attention_impl "kernel", or
"auto" on a CUDA tensor, off a space axis), a tanh-GELU block with
C <= 512 runs the fused Swin-block kernel; otherwise the attention runs
the fused window-attention kernel where C <= 512, with LN and the MLP in
plain PyTorch; everything else is the plain composition. Under autograd the kernels run through their
torch.autograd.Functions (FusedSwinBlockFn, FusedWindowAttentionFn), whose
backwards are kernels too.

Training (deterministic=False) draws the per-sample stochastic-depth keep
factors from a droppath generator; a stage whose `remat` is on runs each
block under torch.utils.checkpoint, except where the fused block kernel
runs: as in the JAX package (swin.py:323-342) that block is never
checkpointed, and its forward keeps the rows its backward reads
(FusedSwinBlockFn) instead of recomputing the block.

On a space axis (`spatial`, parallel.spatial.set_spatial) the trunk takes
and returns slabs in the even layout; each stage relayouts its tokens to
slabs of whole windows (parallel.spatial.window_bounds), where the blocks
run the plain path and a merge stays local, and relayouts each feature map
back to the even layout. Every rank of a space group draws the same keep
factors (a data row's), so the slabs of one sample drop the same paths.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    set_checkpoint_early_stop,
)

from nerf_mae_torch import kernels, tracing
from nerf_mae_torch.config import SwinConfig
from nerf_mae_torch.ops.draws import batch_rand
from nerf_mae_torch.ops.fused_attention import (
    FusedWindowAttentionFn,
    fused_window_attention,
)
from nerf_mae_torch.ops.fused_block import (
    FusedSwinBlockFn,
    fused_swin_block,
    layer_norm,
)
from nerf_mae_torch.ops.window_attention import (
    kernel_supported,
    mm_f32,
    window_attention_3d,
)
from nerf_mae_torch.parallel import spatial as sp


class Linear(nn.Module):
    """Parameter holder in torch Linear layout: weight [out, in], bias [out]."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, device=device))
        self.bias = (nn.Parameter(torch.empty(out_features, device=device))
                     if bias else None)


class Norm(nn.Module):
    """LayerNorm parameter holder: weight (scale) and bias, [C]."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))


def drop_path(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Per-sample stochastic depth ('row' mode, the reference's torchvision
    StochasticDepth at swin_mae3d.py:350): x scaled by its sample's
    keep/(1-rate) factor, keep [B], in x's dtype."""
    return x * keep.to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))


def droppath_keep(batch: int, rate: float,
                  generator: torch.Generator) -> torch.Tensor:
    """[B] float32 keep/(1-rate) factors drawn from `generator` (the same
    draws feed the fused kernel and the plain path); a BatchGenerator draws
    them for the global batch and keeps its rows."""
    keep = batch_rand(generator, (batch,))
    return (keep < 1.0 - rate).float() / (1.0 - rate)


# ops whose outputs remat_policy="dots" keeps (JAX's dots_saveable)
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.convolution.default}


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_call(fn, policy: str, *args, early_stop: bool = True):
    """fn(*args) under torch.utils.checkpoint: "nothing" keeps only the
    inputs, "dots" also the matmul and convolution outputs. early_stop=False
    recomputes fn whole (a function with collectives: every rank must run
    all of them, whatever it saved)."""
    with set_checkpoint_early_stop(early_stop):
        if policy == "dots":
            return checkpoint(fn, *args, use_reentrant=False,
                              context_fn=lambda: create_selective_checkpoint_contexts(
                                  _dots_policy))
        return checkpoint(fn, *args, use_reentrant=False)


def flax_layer_norm(x: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    """flax nn.LayerNorm(dtype=float32) with its default fast variance:
    var = max(0, E[x^2] - mu^2), y = (x - mu) * (rsqrt(var + eps) * scale)
    + bias; returns f32."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    return (xf - mu) * (torch.rsqrt(var + eps) * scale.float()) + bias.float()


def dense(x: torch.Tensor, weight, bias, dtype) -> torch.Tensor:
    """nn.Dense at the compute dtype: f32 accumulation, rounded, then the
    bias added in the compute dtype."""
    y = mm_f32(x.to(dtype), weight.to(dtype).t()).to(dtype)
    return y + bias.to(dtype)


class WindowAttention3D(nn.Module):
    """Parameters of one block's window attention (reference `attn`)."""

    def __init__(self, dim: int, num_heads: int, window: Tuple[int, int, int],
                 device=None):
        super().__init__()
        table = (2 * window[0] - 1) * (2 * window[1] - 1) * (2 * window[2] - 1)
        self.qkv = Linear(dim, 3 * dim, device=device)
        self.proj = Linear(dim, dim, device=device)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty(table, num_heads, device=device))


class SwinBlock3D(nn.Module):
    """One Swin block: LN -> window MSA -> droppath residual -> LN -> MLP.

    (reference: swin_mae3d.py:310-369)
    """

    spatial = None  # the mesh on a space axis: x is a slab of whole windows

    def __init__(self, dim: int, num_heads: int, window: Tuple[int, int, int],
                 shift: Tuple[int, int, int], mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.0, norm_eps: float = 1e-5,
                 dtype: torch.dtype = torch.bfloat16,
                 attention_impl: str = "auto", gelu: str = "tanh",
                 device=None):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.window, self.shift = tuple(window), tuple(shift)
        self.mlp_ratio, self.drop_path_rate = mlp_ratio, drop_path_rate
        self.norm_eps, self.dtype = norm_eps, dtype
        self.attention_impl, self.gelu = attention_impl, gelu
        hidden = int(dim * mlp_ratio)
        self.norm1 = Norm(dim, device=device)
        self.attn = WindowAttention3D(dim, num_heads, self.window, device=device)
        self.norm2 = Norm(dim, device=device)
        self.mlp = nn.ModuleDict({
            "0": Linear(dim, hidden, device=device),
            "3": Linear(hidden, dim, device=device),
        })
        # set by SwinEncoder3D from the stage's remat setting
        self.remat, self.remat_policy = False, "nothing"

    def _kernel_weights(self):
        """The qkv, proj, fc1 and fc2 weights in the compute dtype for the
        kernels. Without autograd the casts are cached and made again only
        when a parameter is replaced or changed in place, so that a served
        forward does not cast every weight on every call. Autograd must see
        the casts, and parameters made under inference_mode carry no version
        counter, so neither case is cached."""
        params = (self.attn.qkv.weight, self.attn.proj.weight,
                  self.mlp["0"].weight, self.mlp["3"].weight)
        if torch.is_grad_enabled() or any(p.is_inference() for p in params):
            return tuple(p.to(self.dtype) for p in params)
        key = tuple((p.data_ptr(), p._version) for p in params) + (self.dtype,)
        cached = getattr(self, "_cast_cache", None)
        if cached is None or cached[0] != key:
            with torch.inference_mode(False), torch.no_grad():
                cached = (key, tuple(p.to(self.dtype).contiguous() for p in params))
            self._cast_cache = cached
        return cached[1]

    def _kernels(self, x: torch.Tensor) -> bool:
        """True where this block runs a kernel: the fused block (tanh GELU)
        or the fused window attention (kernels.wanted, then the shape)."""
        return (kernels.wanted(x, self.attention_impl, self.spatial)
                and kernel_supported(x.shape[-1], self.window))

    def keep_factors(self, x: torch.Tensor, deterministic: bool,
                     generator: Optional[torch.Generator]) -> torch.Tensor:
        """[B, 2] float32 (attention, MLP) stochastic-depth keep/(1-rate)
        factors: ones when deterministic or the rate is 0, else drawn from
        `generator`."""
        b = x.shape[0]
        rate = self.drop_path_rate
        if deterministic or rate == 0.0:
            return torch.ones((b, 2), dtype=torch.float32, device=x.device)
        if generator is None:
            raise ValueError("a training forward with stochastic depth needs "
                             "a droppath generator")
        return torch.stack([droppath_keep(b, rate, generator),
                            droppath_keep(b, rate, generator)], -1)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, G0, G1, G2, C]. Training (deterministic=False) draws the
        keep factors from `generator`; they are drawn before a remat'd block
        runs, so its recompute uses the same ones."""
        keep = self.keep_factors(x, deterministic, generator)
        fused = self.gelu == "tanh" and self._kernels(x)
        if self.remat and torch.is_grad_enabled() and not fused:
            return remat_call(self._block, self.remat_policy, x, keep,
                              early_stop=self.spatial is None)
        return self._block(x, keep)

    def _block(self, x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        attn, fc1, fc2 = self.attn, self.mlp["0"], self.mlp["3"]
        kernel = self._kernels(x)
        grad = torch.is_grad_enabled()

        if kernel and self.gelu == "tanh":
            if grad:  # float32 parameters: the Function casts them inside
                weights = (self.attn.qkv.weight, self.attn.proj.weight,
                           fc1.weight, fc2.weight)
                block = FusedSwinBlockFn.apply
            else:
                weights = self._kernel_weights()
                block = fused_swin_block
            w_qkv, w_proj, w_fc1, w_fc2 = weights
            return block(
                x.to(self.dtype),
                self.norm1.weight, self.norm1.bias,
                w_qkv, attn.qkv.bias, w_proj, attn.proj.bias,
                self.norm2.weight, self.norm2.bias,
                w_fc1, fc1.bias, w_fc2, fc2.bias,
                attn.relative_position_bias_table, keep,
                self.window, self.shift, self.num_heads, self.norm_eps,
            ).to(x.dtype)

        h = layer_norm(x, self.norm1.weight, self.norm1.bias, self.norm_eps)
        if kernel:
            attention = FusedWindowAttentionFn.apply if grad else fused_window_attention
            w_qkv, w_proj = self._kernel_weights()[:2]
        else:
            attention = functools.partial(window_attention_3d, mesh=self.spatial)
            w_qkv, w_proj = attn.qkv.weight, attn.proj.weight
        h = attention(
            h.to(self.dtype), w_qkv, attn.qkv.bias, w_proj, attn.proj.bias,
            attn.relative_position_bias_table,
            self.window, self.shift, self.num_heads,
        )
        x = x + drop_path(h.to(x.dtype), keep[:, 0])

        h = layer_norm(x, self.norm2.weight, self.norm2.bias, self.norm_eps)
        h = dense(h, fc1.weight, fc1.bias, self.dtype)
        h = torch.nn.functional.gelu(
            h, approximate="none" if self.gelu == "erf" else "tanh")
        h = dense(h, fc2.weight, fc2.bias, self.dtype)
        return x + drop_path(h.to(x.dtype), keep[:, 1])


class PatchMerging3D(nn.Module):
    """8-way 2x2x2 concat -> LayerNorm(8C) -> Linear(2C or C, no bias).

    (reference: swin_mae3d.py:372-414)

    A slab of whole windows starts at an even plane, so it merges locally;
    the odd pad of axis 1 falls on the rank that holds the global end.
    """

    def __init__(self, dim: int, expand_dim: bool = True, norm_eps: float = 1e-5,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.norm_eps, self.dtype = norm_eps, dtype
        self.norm = Norm(8 * dim, device=device)
        out_dim = dim * 2 if expand_dim else dim
        self.reduction = Linear(8 * dim, out_dim, bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, d, c = x.shape
        pads = (h % 2, w % 2, d % 2)
        if any(pads):
            x = torch.nn.functional.pad(x, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        # the reference's concat order, h-parity fastest:
        # (0,0,0),(1,0,0),(0,1,0),(1,1,0),(0,0,1),(1,0,1),(0,1,1),(1,1,1)
        parts = [x[:, dx::2, dy::2, dz::2, :]
                 for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]
        x = torch.cat(parts, dim=-1)
        x = flax_layer_norm(x, self.norm.weight, self.norm.bias, self.norm_eps)
        return mm_f32(x.to(self.dtype),
                      self.reduction.weight.to(self.dtype).t()).to(self.dtype)


class SwinEncoder3D(nn.ModuleList):
    """The 4-stage Swin trunk over an already patch-embedded token grid.

    The module list is the reference's `stages`: stage s holds its
    PatchMerging3D at index 0 when s > 0, then its blocks, so the parameter
    names are `stages.{s}.{i}.*` once SwinMAE3D registers it as `stages`.
    Input [B, T, T, T, embed_dim]; returns the per-stage feature pyramid
    [C@T, 2C@T/2, 4C@T/4, 8C@T/8] (reference: swin_mae3d.py:1131-1172).
    `remat_stages` (one bool per stage) turns on the blocks' checkpointing.
    On a space axis, input and features are even slabs (module doc).
    Spans (tracing.py): nerf_mae.stage{s} around stage s, nerf_mae.merge{s}
    around its merge, each output marked for its backward.
    """

    spatial = None  # the mesh on a space axis

    def __init__(self, cfg: SwinConfig, dtype: torch.dtype = torch.bfloat16,
                 device=None, remat_stages: Optional[Sequence[bool]] = None,
                 remat_policy: str = "nothing"):
        stages = []
        total_blocks = sum(cfg.depths)
        block_id = 0
        remat_stages = remat_stages or (False,) * len(cfg.depths)
        for i_stage, depth in enumerate(cfg.depths):
            dim = cfg.stage_dims[i_stage]
            stage = []
            if i_stage > 0:
                stage.append(PatchMerging3D(
                    cfg.stage_dims[i_stage - 1], expand_dim=cfg.expand_dim,
                    norm_eps=cfg.norm_eps, dtype=dtype, device=device))
            for i_layer in range(depth):
                sd = cfg.stochastic_depth_prob * block_id / max(total_blocks - 1, 1)
                shift = tuple(0 if i_layer % 2 == 0 else ws // 2
                              for ws in cfg.window_size)
                block = SwinBlock3D(
                    dim, cfg.num_heads[i_stage], tuple(cfg.window_size), shift,
                    mlp_ratio=cfg.mlp_ratio, drop_path_rate=sd,
                    norm_eps=cfg.norm_eps, dtype=dtype,
                    attention_impl=cfg.attention_impl, gelu=cfg.gelu,
                    device=device)
                block.remat = bool(remat_stages[i_stage])
                block.remat_policy = remat_policy
                stage.append(block)
                block_id += 1
            stages.append(nn.ModuleList(stage))
        super().__init__(stages)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        mesh = self.spatial
        features = []
        layout = None if mesh is None else sp.even_bounds(sp.grid_len(x), mesh.space)
        for s, stage in enumerate(self):
            with tracing.span(f"nerf_mae.stage{s}"):
                for layer in stage:
                    if isinstance(layer, PatchMerging3D):
                        with tracing.span(f"nerf_mae.merge{s}"):
                            x = tracing.mark(layer(x), f"nerf_mae.merge{s}")
                        if mesh is not None:
                            layout = sp.halve_bounds(layout)
                    else:
                        if mesh is not None:  # this stage's slabs of whole windows
                            windows = sp.window_bounds(sp.grid_len(x), layer.window[0],
                                                       mesh.space)[0]
                            x, layout = sp.relayout(x, layout, windows, mesh), windows
                        x = layer(x, deterministic, generator)
                x = tracing.mark(x, f"nerf_mae.stage{s}")
                if mesh is not None:
                    even = sp.even_bounds(sp.grid_len(x), mesh.space)
                    features.append(sp.relayout(x, layout, even, mesh))
                else:
                    features.append(x)
        return features
