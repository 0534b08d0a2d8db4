"""3D shifted-window multi-head attention, plain PyTorch (counterpart of
nerf_mae_tpu/ops/window_attention.py).

Functionally the reference's shifted_window_attention
(reference: nerf_mae/model/mae/swin_mae3d.py:27-197) on channel-last
[B, H, W, D, C] grids. The shift mask and the relative-position index are
static numpy functions of (grid, window, shift), cached per shape.

This is the plain path: it runs stage 3 (C > 512) of the main path, every
block of a CPU tensor under attention_impl="auto", and every block under
"plain". Its products go to torch.matmul, as the JAX package leaves them to
XLA.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def window_partition_3d(
    x: torch.Tensor, window: Sequence[int]
) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """[B, H, W, D, C] -> ([B, nW, N, C], windows-per-axis). H/W/D must divide."""
    b, h, w, d, c = x.shape
    nh, nw, nd = h // window[0], w // window[1], d // window[2]
    x = x.reshape(b, nh, window[0], nw, window[1], nd, window[2], c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    x = x.reshape(b, nh * nw * nd, window[0] * window[1] * window[2], c)
    return x, (nh, nw, nd)


def window_unpartition_3d(
    x: torch.Tensor, window: Sequence[int], counts: Tuple[int, int, int]
) -> torch.Tensor:
    """Inverse of window_partition_3d: [B, nW, N, C] -> [B, H, W, D, C]."""
    b, _, _, c = x.shape
    nh, nw, nd = counts
    x = x.reshape(b, nh, nw, nd, window[0], window[1], window[2], c)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, nh * window[0], nw * window[1], nd * window[2], c)


@functools.lru_cache(maxsize=32)
def relative_position_index_3d(window: Tuple[int, int, int]) -> np.ndarray:
    """[N, N] int32 index into the (2w0-1)(2w1-1)(2w2-1) bias table.

    Same row-major arithmetic as the reference (swin_mae3d.py:257-280).
    The cached array is read-only.
    """
    coords = np.stack(
        np.meshgrid(
            np.arange(window[0]),
            np.arange(window[1]),
            np.arange(window[2]),
            indexing="ij",
        )
    ).reshape(3, -1)
    rel = coords[:, :, None] - coords[:, None, :]  # [3, N, N]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[..., 0] += window[0] - 1
    rel[..., 1] += window[1] - 1
    rel[..., 2] += window[2] - 1
    rel[..., 0] *= (2 * window[1] - 1) * (2 * window[2] - 1)
    rel[..., 1] *= 2 * window[2] - 1
    out = rel.sum(-1).astype(np.int32)
    out.setflags(write=False)
    return out


def _region_slices(dim: int, w: int, s: int):
    """The three shift regions along one axis (reference: swin_mae3d.py:127-141)."""
    return ((0, dim - w), (dim - w, dim - s), (dim - s, dim))


@functools.lru_cache(maxsize=64)
def shifted_window_mask(
    grid: Tuple[int, int, int],
    window: Tuple[int, int, int],
    shift: Tuple[int, int, int],
) -> Optional[np.ndarray]:
    """[nW, N, N] float32 additive mask (0 / -100) for shifted windows.

    Tokens wrapped from opposite grid edges share a window after the cyclic
    shift; pairs from different 27-region labels must not attend
    (reference: swin_mae3d.py:124-167). None when there is no shift.
    The cached array is read-only.
    """
    if sum(shift) == 0:
        return None
    region = np.zeros(grid, dtype=np.float32)
    count = 0
    for hs in _region_slices(grid[0], window[0], shift[0]):
        for ws in _region_slices(grid[1], window[1], shift[1]):
            for ds in _region_slices(grid[2], window[2], shift[2]):
                region[hs[0] : hs[1], ws[0] : ws[1], ds[0] : ds[1]] = count
                count += 1
    nh, nw, nd = (grid[i] // window[i] for i in range(3))
    r = region.reshape(nh, window[0], nw, window[1], nd, window[2])
    r = r.transpose(0, 2, 4, 1, 3, 5).reshape(nh * nw * nd, -1)  # [nW, N]
    diff = r[:, :, None] - r[:, None, :]
    out = np.where(diff != 0, np.float32(-100.0), np.float32(0.0))
    out.setflags(write=False)
    return out


def window_geometry(grid, window, shift):
    """(pad, padded grid, effective shift) of one block: zero-pad to window
    multiples; no shift along axes the window covers
    (reference: swin_mae3d.py:69-75)."""
    window = tuple(window)
    pad = tuple((window[i] - grid[i] % window[i]) % window[i] for i in range(3))
    padded = tuple(grid[i] + pad[i] for i in range(3))
    shift = tuple(0 if window[i] >= padded[i] else shift[i] for i in range(3))
    return pad, padded, shift


def kernel_supported(c: int, window) -> bool:
    """True where both CUDA kernels (fused block, fused window attention)
    run: the JAX package's fused_block_supported and pallas_supported agree
    on this rule. Padded grids are handled; only the window token count and
    C bind (C <= 512 keeps stage 3 on the plain path, as on the TPU)."""
    n = window[0] * window[1] * window[2]
    return n % 8 == 0 and c % 8 == 0 and c <= 512


def pad_roll_partition(x, window, pad, shift):
    """[B, G0, G1, G2, C] -> ([B, nW, N, C], counts): zero-pad, cyclic
    shift by -shift, window partition."""
    if any(pad):
        x = torch.nn.functional.pad(x, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))
    if sum(shift) > 0:
        x = torch.roll(x, (-shift[0], -shift[1], -shift[2]), dims=(1, 2, 3))
    return window_partition_3d(x, window)


def unpartition_unroll_crop(xw, window, counts, grid, shift):
    """Inverse of pad_roll_partition: [B, nW, N, C] -> [B, G0, G1, G2, C]."""
    x = window_unpartition_3d(xw, window, counts)
    if sum(shift) > 0:
        x = torch.roll(x, tuple(shift), dims=(1, 2, 3))
    return x[:, : grid[0], : grid[1], : grid[2], :]


# The cached tensors below are made outside inference_mode even when first
# asked for under it: a serving call must not leave inference tensors that a
# later training step would save for its backward.


@functools.lru_cache(maxsize=32)
def _rel_index_tensor(window, device):
    with torch.inference_mode(False):
        return torch.tensor(
            relative_position_index_3d(window), dtype=torch.long, device=device
        )


@functools.lru_cache(maxsize=32)
def shift_mask_tensor(grid, window, shift, device):
    """shifted_window_mask as a float32 tensor on `device` (or None)."""
    m = shifted_window_mask(grid, window, shift)
    if m is None:
        return None
    with torch.inference_mode(False):
        return torch.tensor(m, device=device)


def relative_position_bias(bias_table: torch.Tensor, window) -> torch.Tensor:
    """[(2w-1)^3, heads] table -> [heads, N, N] float32 bias."""
    idx = _rel_index_tensor(tuple(window), bias_table.device)
    return bias_table[idx].permute(2, 0, 1).float()


@functools.lru_cache(maxsize=32)
def _table_members(window, device):
    """[table, K] positions (into the flattened [N, N] logits) that read each
    bias-table row, padded with N*N (an appended zero), in increasing order."""
    idx = relative_position_index_3d(window).reshape(-1)
    rows = (2 * window[0] - 1) * (2 * window[1] - 1) * (2 * window[2] - 1)
    counts = np.bincount(idx, minlength=rows)
    order = np.argsort(idx, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    members = np.full((rows, counts.max()), idx.size, np.int64)
    for t in range(rows):
        members[t, : counts[t]] = order[starts[t]: starts[t] + counts[t]]
    with torch.inference_mode(False):
        return torch.tensor(members, device=device)


def relative_position_bias_grad(dlogit: torch.Tensor, window) -> torch.Tensor:
    """[heads, N, N] float32 logit gradient -> [(2w-1)^3, heads] bias-table
    gradient: the scatter-add through relative_position_index_3d, as a
    gather and a sum in a fixed order (deterministic on every device)."""
    heads = dlogit.shape[0]
    flat = dlogit.reshape(heads, -1).float()
    flat = torch.cat([flat, flat.new_zeros(heads, 1)], dim=1)
    members = _table_members(tuple(window), dlogit.device)
    return flat[:, members].sum(-1).t().contiguous()


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with float32 accumulation: the products of values held in the
    compute dtype are exact in float32 (XLA's preferred_element_type)."""
    return torch.matmul(a.float(), b.float())


def window_attention_3d(
    x: torch.Tensor,
    qkv_weight: torch.Tensor,  # [3C, C] (torch Linear layout)
    qkv_bias: Optional[torch.Tensor],  # [3C]
    proj_weight: torch.Tensor,  # [C, C]
    proj_bias: Optional[torch.Tensor],  # [C]
    bias_table: torch.Tensor,  # [(2w-1)^3, heads]
    window: Sequence[int],
    shift: Sequence[int],
    num_heads: int,
) -> torch.Tensor:
    """Shifted-window MSA over a [B, H, W, D, C] grid; returns the same shape
    in x.dtype. Pad-then-roll; qkv is cast to x.dtype before the q scale
    (window_attention.py:150-154 of the JAX package); softmax in float32."""
    b, h, w, d, c = x.shape
    window = tuple(window)
    pad, padded, shift = window_geometry((h, w, d), window, shift)
    xw, counts = pad_roll_partition(x, window, pad, shift)
    n_windows, n_tokens = xw.shape[1], xw.shape[2]
    head_dim = c // num_heads
    dt = x.dtype

    qkv = mm_f32(xw, qkv_weight.to(dt).t())
    if qkv_bias is not None:
        qkv = qkv + qkv_bias.float()
    qkv = qkv.to(dt).reshape(b, n_windows, n_tokens, 3, num_heads, head_dim)
    q, k, v = qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]
    # -> [B, nW, heads, N, hd]
    q = q.permute(0, 1, 3, 2, 4) * (head_dim**-0.5)
    k = k.permute(0, 1, 3, 2, 4)
    v = v.permute(0, 1, 3, 2, 4)

    attn = mm_f32(q, k.transpose(-1, -2))
    attn = attn + relative_position_bias(bias_table, window)[None, None]
    mask = shift_mask_tensor(padded, window, shift, x.device)
    if mask is not None:
        attn = attn + mask[None, :, None]
    attn = torch.softmax(attn, dim=-1).to(dt)
    out = mm_f32(attn, v).to(dt)
    out = out.permute(0, 1, 3, 2, 4).reshape(b, n_windows, n_tokens, c)
    out = mm_f32(out, proj_weight.to(dt).t())
    if proj_bias is not None:
        out = out + proj_bias.float()
    out = out.to(dt)
    return unpartition_unroll_crop(out, window, counts, (h, w, d), shift)
