"""Plain float32 3D Swin trunk over a parameter dict (the benchmark's
reference; imports torch and numpy only).

A frozen, independent statement of the NeRF-MAE trunk (arXiv 2404.01300,
reference code nerf_mae/model/mae/swin_mae3d.py:27-414; Swin of arXiv
2103.14030): 4^3 patch embedding, LayerNorm, 3D sin-cos position embedding,
stages of shifted-window blocks (LN -> window MSA with a relative-position
bias -> per-sample stochastic depth -> LN -> MLP with the tanh GELU) and
2x2x2 patch mergings. Channel-last [B, X, Y, Z, C] tensors. Parameters are
looked up by the state-dict names the system under test uses, so one dict of
weights made by the benchmark serves both sides.

`Numerics` carries the precision: float32 (TF32 off, set by the caller), or
"fp8", every product on fp8 operands (the control that must come out
incorrect).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def fp8_round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to the fp8 format `dtype` under a per-tensor scale that
    maps its largest magnitude to the format's largest, back in float32."""
    top = torch.finfo(dtype).max
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Operand(torch.autograd.Function):
    """A product's operand in e4m3 (the forward's fp8 format); its gradient
    passes through as it comes."""

    @staticmethod
    def forward(ctx, x):
        return fp8_round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return g


class _Product(torch.autograd.Function):
    """A product's result as it is; the gradient reaching it rounded to
    e5m2 (the backward's fp8 format), so that both backward products take
    fp8 operands too."""

    @staticmethod
    def forward(ctx, y):
        return y

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g, torch.float8_e5m2)


class Numerics:
    """Where products round: "float32" leaves them alone; "fp8" computes
    every matrix product and convolution on fp8 operands, as fp8 training
    does: e4m3 activations and weights in the forward, e5m2 gradients in
    the backward, each tensor under its own scale, accumulation in float32."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.fp8 = precision == "fp8"

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return _Operand.apply(x) if self.fp8 else x

    def out(self, y: torch.Tensor) -> torch.Tensor:
        return _Product.apply(y) if self.fp8 else y

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.out(torch.matmul(self.q(a), self.q(b)))

    def linear(self, x, w, b=None):
        y = self.mm(x, w.t())
        return y if b is None else y + b

    def conv3d(self, x, w, b=None, stride=1, padding=0):
        return self.out(F.conv3d(self.q(x), self.q(w), b, stride=stride, padding=padding))

    def conv_transpose3d(self, x, w, b=None, stride=1):
        return self.out(F.conv_transpose3d(self.q(x), self.q(w), b, stride=stride))


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(np.sqrt(2.0 / np.pi) * (x + 0.044715 * x ** 3)))


@functools.lru_cache(maxsize=8)
def sincos_pos_embed_3d(dim: int, grid: int) -> np.ndarray:
    """[grid, grid, grid, dim] float32: per-axis sin/cos embeddings of even
    width (dim // 3) // 2 * 2, the first third encoding the second axis
    (the reference's meshgrid "xy" order), zero-padded to dim."""
    axis = (dim // 3) // 2 * 2
    omega = 1.0 / 10000 ** (np.arange(axis // 2, dtype=np.float64) / (axis / 2.0))
    coords = np.arange(grid, dtype=np.float64)
    g1, g0, g2 = np.meshgrid(coords, coords, coords)  # "xy": the first varies along axis 1

    def one(pos):
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], 1)

    emb = np.concatenate([one(g1), one(g0), one(g2)], 1)
    emb = np.concatenate([emb, np.zeros((emb.shape[0], dim - emb.shape[1]))], 1)
    return emb.reshape(grid, grid, grid, dim).astype(np.float32)


def relative_index(window: Tuple[int, int, int]) -> np.ndarray:
    """[N, N] index into the (2w-1)^3 bias table, row-major offsets."""
    c = np.stack(np.meshgrid(*[np.arange(w) for w in window], indexing="ij")).reshape(3, -1)
    rel = (c[:, :, None] - c[:, None, :]).transpose(1, 2, 0)
    rel = rel + np.array(window) - 1
    return (rel[..., 0] * (2 * window[1] - 1) * (2 * window[2] - 1)
            + rel[..., 1] * (2 * window[2] - 1) + rel[..., 2])


def shift_mask(grid, window, shift) -> np.ndarray:
    """[nW, N, N] additive mask (0 / -100): tokens from different shift
    regions of the padded grid do not attend to each other."""
    region = np.zeros(grid, np.float32)
    label = 0
    spans = [((0, g - w), (g - w, g - s), (g - s, g)) for g, w, s in zip(grid, window, shift)]
    for a in spans[0]:
        for b in spans[1]:
            for c in spans[2]:
                region[a[0]:a[1], b[0]:b[1], c[0]:c[1]] = label
                label += 1
    r = partition(torch.from_numpy(region)[None, ..., None], window)[0][0, ..., 0].numpy()
    return np.where(r[:, :, None] != r[:, None, :], -100.0, 0.0).astype(np.float32)


def partition(x: torch.Tensor, window) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    b, g0, g1, g2, c = x.shape
    n = (g0 // window[0], g1 // window[1], g2 // window[2])
    x = x.reshape(b, n[0], window[0], n[1], window[1], n[2], window[2], c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(b, n[0] * n[1] * n[2], -1, c)
    return x, n


def unpartition(x: torch.Tensor, window, n) -> torch.Tensor:
    b, _, _, c = x.shape
    x = x.reshape(b, n[0], n[1], n[2], window[0], window[1], window[2], c)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, n[0] * window[0], n[1] * window[1], n[2] * window[2], c)


def window_attention(x: torch.Tensor, p: Params, prefix: str, heads: int, window,
                     shift, num: Numerics) -> torch.Tensor:
    """Shifted-window MSA of a [B, G0, G1, G2, C] grid: zero-pad to whole
    windows, cyclic shift (none along an axis one window covers), attention
    per window and head, undo the shift, crop."""
    b, g0, g1, g2, c = x.shape
    grid = (g0, g1, g2)
    pad = [(w - g % w) % w for g, w in zip(grid, window)]
    padded = tuple(g + q for g, q in zip(grid, pad))
    shift = tuple(0 if w >= g else s for g, w, s in zip(padded, window, shift))
    x = F.pad(x, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))
    if any(shift):
        x = torch.roll(x, tuple(-s for s in shift), dims=(1, 2, 3))
    xw, n = partition(x, window)
    nw, nt = xw.shape[1], xw.shape[2]
    hd = c // heads
    qkv = num.linear(xw, p[prefix + "qkv.weight"], p[prefix + "qkv.bias"])
    qkv = qkv.reshape(b, nw, nt, 3, heads, hd).permute(3, 0, 1, 4, 2, 5)
    q, k, v = qkv[0] * hd ** -0.5, qkv[1], qkv[2]
    logits = num.mm(q, k.transpose(-1, -2))
    idx = torch.as_tensor(relative_index(tuple(window)), device=x.device)
    logits = logits + p[prefix + "relative_position_bias_table"][idx].permute(2, 0, 1)[None, None]
    if any(shift):
        logits = logits + torch.as_tensor(shift_mask(padded, window, shift),
                                          device=x.device)[None, :, None]
    o = num.mm(torch.softmax(logits, -1), v)
    o = o.permute(0, 1, 3, 2, 4).reshape(b, nw, nt, c)
    o = num.linear(o, p[prefix + "proj.weight"], p[prefix + "proj.bias"])
    o = unpartition(o, window, n)
    if any(shift):
        o = torch.roll(o, shift, dims=(1, 2, 3))
    return o[:, :g0, :g1, :g2]


def block(x: torch.Tensor, p: Params, prefix: str, heads: int, window, shift,
          keep: torch.Tensor, eps: float, num: Numerics) -> torch.Tensor:
    """One Swin block; keep [B, 2] are the (attention, MLP) keep/(1-rate)
    factors of stochastic depth."""
    scale = lambda t, i: t * keep[:, i].reshape(-1, 1, 1, 1, 1)
    h = layer_norm(x, p[prefix + "norm1.weight"], p[prefix + "norm1.bias"], eps)
    x = x + scale(window_attention(h, p, prefix + "attn.", heads, window, shift, num), 0)
    h = layer_norm(x, p[prefix + "norm2.weight"], p[prefix + "norm2.bias"], eps)
    h = gelu_tanh(num.linear(h, p[prefix + "mlp.0.weight"], p[prefix + "mlp.0.bias"]))
    return x + scale(num.linear(h, p[prefix + "mlp.3.weight"], p[prefix + "mlp.3.bias"]), 1)


def merge(x: torch.Tensor, p: Params, prefix: str, eps: float, num: Numerics) -> torch.Tensor:
    """2x2x2 patch merging: pad odd axes, concatenate the 8 parities with
    the first axis fastest, LayerNorm, bias-free linear."""
    g = x.shape[1:4]
    x = F.pad(x, (0, 0, 0, g[2] % 2, 0, g[1] % 2, 0, g[0] % 2))
    x = torch.cat([x[:, i::2, j::2, k::2] for k in (0, 1) for j in (0, 1) for i in (0, 1)], -1)
    x = layer_norm(x, p[prefix + "norm.weight"], p[prefix + "norm.bias"], eps)
    return num.linear(x, p[prefix + "reduction.weight"])


def drop_rates(depths: Sequence[int], rate: float) -> List[List[float]]:
    """Stochastic-depth rate of each block: linear in the block's index
    over the whole trunk, from 0 to `rate`."""
    total = sum(depths)
    out, i = [], 0
    for d in depths:
        out.append([rate * (i + j) / max(total - 1, 1) for j in range(d)])
        i += d
    return out


def encoder(x: torch.Tensor, p: Params, prefix: str, cfg: dict, keeps: List[List[torch.Tensor]],
            num: Numerics) -> List[torch.Tensor]:
    """The stages over an embedded token grid; returns each stage's output.
    Parameter names: {prefix}{s}.{i}.* with stage s's merge at i = 0 when
    s > 0. keeps[s][j] is block j of stage s's [B, 2] keep factors."""
    window = tuple(cfg["window_size"])
    feats = []
    for s, depth in enumerate(cfg["depths"]):
        first = 0
        if s > 0:
            x = merge(x, p, f"{prefix}{s}.0.", cfg["norm_eps"], num)
            first = 1
        for j in range(depth):
            shift = tuple(0 if j % 2 == 0 else w // 2 for w in window)
            x = block(x, p, f"{prefix}{s}.{first + j}.", cfg["num_heads"][s], window, shift,
                      keeps[s][j], cfg["norm_eps"], num)
        feats.append(x)
    return feats


def embed(grids: torch.Tensor, p: Params, prefix: str, cfg: dict, num: Numerics) -> torch.Tensor:
    """Patch embedding (conv, kernel = stride = patch), LayerNorm, position
    embedding: [B, R, R, R, 4] -> [B, T, T, T, E]."""
    patch = cfg["patch_size"]
    x = num.conv3d(grids.permute(0, 4, 1, 2, 3), p[prefix + "0.weight"],
                   p[prefix + "0.bias"], stride=patch).permute(0, 2, 3, 4, 1)
    x = layer_norm(x, p[prefix + "2.weight"], p[prefix + "2.bias"], cfg["norm_eps"])
    pos = torch.as_tensor(sincos_pos_embed_3d(cfg["embed_dim"], x.shape[1]), device=x.device)
    return x + pos


def stage_dims(cfg: dict) -> List[int]:
    return [cfg["embed_dim"] * 2 ** s for s in range(len(cfg["depths"]))]


def trunk_shapes(cfg: dict, patch_prefix: str, stage_prefix: str) -> Dict[str, Tuple[int, ...]]:
    """Every trunk parameter's name and shape."""
    e, w = cfg["embed_dim"], cfg["window_size"]
    table = (2 * w[0] - 1) * (2 * w[1] - 1) * (2 * w[2] - 1)
    pt = cfg["patch_size"]
    out = {patch_prefix + "0.weight": (e, cfg["input_channels"], pt, pt, pt),
           patch_prefix + "0.bias": (e,), patch_prefix + "2.weight": (e,),
           patch_prefix + "2.bias": (e,)}
    dims = stage_dims(cfg)
    for s, depth in enumerate(cfg["depths"]):
        c, first = dims[s], 0
        if s > 0:
            out[f"{stage_prefix}{s}.0.norm.weight"] = (8 * dims[s - 1],)
            out[f"{stage_prefix}{s}.0.norm.bias"] = (8 * dims[s - 1],)
            out[f"{stage_prefix}{s}.0.reduction.weight"] = (c, 8 * dims[s - 1])
            first = 1
        hidden = int(c * cfg["mlp_ratio"])
        for j in range(depth):
            b = f"{stage_prefix}{s}.{first + j}."
            out.update({
                b + "norm1.weight": (c,), b + "norm1.bias": (c,),
                b + "attn.qkv.weight": (3 * c, c), b + "attn.qkv.bias": (3 * c,),
                b + "attn.proj.weight": (c, c), b + "attn.proj.bias": (c,),
                b + "attn.relative_position_bias_table": (table, cfg["num_heads"][s]),
                b + "norm2.weight": (c,), b + "norm2.bias": (c,),
                b + "mlp.0.weight": (hidden, c), b + "mlp.0.bias": (hidden,),
                b + "mlp.3.weight": (c, hidden), b + "mlp.3.bias": (c,),
            })
    return out


def draw_keeps(cfg: dict, batch: int, generator: Optional[torch.Generator],
               device) -> List[List[torch.Tensor]]:
    """Stochastic-depth keep factors of a training forward, drawn block by
    block in trunk order (two uniform [B] draws, attention then MLP, for
    each block whose rate is above 0): keep = (u < 1 - rate) / (1 - rate).
    A block of rate 0, or no generator (an eval forward), keeps all."""
    out = []
    for rates in drop_rates(cfg["depths"], cfg["stochastic_depth_prob"]):
        stage = []
        for rate in rates:
            if generator is None or rate == 0.0:
                stage.append(torch.ones((batch, 2), device=device))
                continue
            u = [torch.rand((batch,), generator=generator, device=device) for _ in range(2)]
            stage.append(torch.stack([(t < 1.0 - rate).float() / (1.0 - rate) for t in u], -1))
        out.append(stage)
    return out


def rows_of(keeps: List[List[torch.Tensor]], rows: slice) -> List[List[torch.Tensor]]:
    return [[k[rows] for k in stage] for stage in keeps]
