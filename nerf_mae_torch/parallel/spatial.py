"""The `space` axis of a [data, space] mesh: the grid sharded in slabs of
planes, and the collectives GSPMD writes for the JAX package from its
annotations (nerf_mae_tpu/parallel/mesh.py grid_pspec), here by hand.

Layouts. Every grid-shaped tensor [B, G, G, G, ...] is cut along axis 1:
the rank at space index s holds planes [lo_s, hi_s) of a contiguous
partition of [0, G). A layout is the list of every rank's (lo, hi), the
same on all ranks. Grids are cubes, so a slab's axis 2 gives G.
- `even_bounds(G, S)`: JAX's even split, ceil(G / S) planes a rank, the
  last ranks shorter or empty. Every tensor that passes between modules is
  in this layout (the batch, the embedded tokens, the encoder's features,
  the decoders, the heads' outputs).
- `window_bounds(G, w, S)`: whole windows of the grid zero-padded to a
  multiple of w, ceil(windows / S) a rank; the Swin stages compute in it,
  so that a window never spans two ranks.
- `halve_bounds`: the layout a patch merging leaves (each rank merges the
  plane pairs it holds: window bounds are even).

Collectives, each an autograd.Function whose backward is its transpose:
- `exchange` moves planes between layouts (`relayout`, with a cyclic
  offset for a shifted window's roll), gathers overlapping ranges (`halo`:
  k planes from each neighbour, zeros beyond the global ends, as a SAME
  convolution pads) and sums the gradient of every copy back into the
  plane it came from;
- `space_sum` is a sum over the space group whose backward is the identity
  (its result is replicated: a downstream gradient is counted once).
They use only `all_gather` (of each rank's planes to send, padded to the
largest) and `all_reduce`, which NCCL and gloo both have for CUDA tensors.
Every rank joins every collective, a rank whose slab is empty at that stage
too: the plans are functions of the global shapes alone, so all ranks of a
group call the same collectives in the same order, forward and backward
(autograd runs the nodes in reverse creation order, and a remat'd block
recomputes its collectives in full: `remat_call(..., early_stop=False)`).
An empty slab's convolution still connects its output to its input
(`empty_result`), so that its backward reaches the same collectives.

No parameter may enter a computation that the S ranks repeat: the trainers
sum every gradient over the world, so a replicated use would count it S
times (the JAX package's Shardy partitioner over-counted a replicated
operand's cotangent so, tests/test_spatial.py).
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

Bounds = Tuple[Tuple[int, int], ...]


def is_spatial(mesh) -> bool:
    """Whether the mesh has a space axis of more than one rank."""
    return mesh is not None and getattr(mesh, "space", 1) > 1


@functools.lru_cache(maxsize=256)
def even_bounds(n: int, s: int) -> Bounds:
    """JAX's even split of n planes over s ranks: ceil(n / s) a rank, the
    last ranks shorter or empty."""
    c = -(-n // s)
    return tuple((min(r * c, n), min((r + 1) * c, n)) for r in range(s))


@functools.lru_cache(maxsize=256)
def window_bounds(n: int, w: int, s: int) -> Tuple[Bounds, Bounds]:
    """(real, padded) bounds of whole windows: the grid zero-padded to a
    multiple of w (window_geometry's pad), ceil(windows / s) windows a
    rank, the last ranks fewer or none; real bounds clip the pad."""
    n_win = -(-n // w)
    c = -(-n_win // s)
    padded = tuple((min(r * c, n_win) * w, min((r + 1) * c, n_win) * w) for r in range(s))
    return tuple((min(a, n), min(b, n)) for a, b in padded), padded


def halve_bounds(bounds: Bounds) -> Bounds:
    """The bounds after a 2x patch merging of slabs with even starts."""
    return tuple((-(-lo // 2), -(-hi // 2)) for lo, hi in bounds)


def scale_bounds(bounds: Bounds, f: int) -> Bounds:
    """The bounds after an f-fold upsampling of each plane."""
    return tuple((lo * f, hi * f) for lo, hi in bounds)


def grid_len(x: torch.Tensor) -> int:
    """The global length of a grid slab's axis 1 (grids are cubes)."""
    return x.shape[2]


def grid_slab(n: int, mesh) -> slice:
    """This rank's planes [lo, hi) of an axis of n planes: JAX's even split
    over the space axis (even_bounds); all of them off a space axis."""
    if not is_spatial(mesh):
        return slice(0, n)
    return slice(*even_bounds(n, mesh.space)[mesh.space_rank])


def take_slab(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's even slab of a tensor every rank holds whole (axis 1);
    the backward fills the other planes with zeros, so a gradient summed
    over the ranks counts each plane once."""
    return x[:, grid_slab(x.shape[1], mesh)]


def empty_result(shape: Sequence[int], *inputs: torch.Tensor) -> torch.Tensor:
    """A zero-size tensor of `shape` whose autograd graph reaches every
    input: what an operation on an empty slab returns where the operation
    itself refuses empty inputs (a convolution)."""
    zero = sum(t.reshape(-1)[:0].sum() for t in inputs if t is not None)
    return zero.to(inputs[0].dtype).expand(*shape)


# ------------------------------------------------------------------- plans

@functools.lru_cache(maxsize=512)
def _plan(src: Bounds, dst: Bounds, n: int, offset: int, cyclic: bool):
    """Pieces (src rank, src local start, dst rank, dst local start, count)
    that fill each rank's destination range: its plane i is global plane
    i + offset of the source (mod n when cyclic; zero outside [0, n)
    otherwise)."""
    owner = [(r, i - lo) for r, (lo, hi) in enumerate(src) for i in range(lo, hi)]
    pieces: List[list] = []
    for d, (a, b) in enumerate(dst):
        run = None
        for i in range(a, b):
            j = i + offset
            if cyclic:
                j %= n
            elif not 0 <= j < n:
                run = None
                continue
            s, ls = owner[j]
            if run is not None and run[0] == s and run[1] + run[4] == ls \
                    and run[3] + run[4] == i - a:
                run[4] += 1
            else:
                run = [s, ls, d, i - a, 1]
                pieces.append(run)
    return tuple(tuple(p) for p in pieces)


def _sent(pieces, rank: int, role: int):
    """The cross-rank pieces that `rank` sends (role 0: it is the source;
    role 2: the destination, in the backward), with each piece's offset
    inside that rank's send buffer."""
    out, at = [], 0
    for p in pieces:
        if p[role] == rank and p[0] != p[2]:
            out.append((p, at))
            at += p[4]
    return out, at


def all_gather(t: torch.Tensor, mesh) -> List[torch.Tensor]:
    """Every space rank's `t` (all the same shape), in space-rank order."""
    out = [torch.empty_like(t) for _ in range(mesh.space)]
    mesh.collectives += 1
    dist.all_gather(out, t.contiguous(), group=mesh.space_group)
    return out


def all_reduce(t: torch.Tensor, mesh) -> torch.Tensor:
    """In place: the sum of `t` over the space group."""
    mesh.collectives += 1
    dist.all_reduce(t, dist.ReduceOp.SUM, group=mesh.space_group)
    return t


def _move(x: torch.Tensor, pieces, out_len: int, mesh, backward: bool) -> torch.Tensor:
    """Run a plan forward (source slabs -> destination slabs) or backward
    (destination gradients summed back into the source slabs)."""
    me = mesh.space_rank
    src_role, dst_role = (2, 0) if backward else (0, 2)
    src_at, dst_at = (3, 1) if backward else (1, 3)
    out = x.new_zeros((x.shape[0], out_len) + tuple(x.shape[2:]))
    sends = [_sent(pieces, r, src_role) for r in range(mesh.space)]
    width = max(total for _, total in sends)
    if width:  # every rank takes part, with a zero buffer if it sends nothing
        buf = x.new_zeros((x.shape[0], width) + tuple(x.shape[2:]))
        for p, at in sends[me][0]:
            buf[:, at:at + p[4]] = x[:, p[src_at]:p[src_at] + p[4]]
        parts = all_gather(buf, mesh)
        for r in range(mesh.space):
            for p, at in sends[r][0]:
                if p[dst_role] == me:
                    out[:, p[dst_at]:p[dst_at] + p[4]] += parts[r][:, at:at + p[4]]
    for p in pieces:
        if p[0] == me and p[2] == me:
            out[:, p[dst_at]:p[dst_at] + p[4]] += x[:, p[src_at]:p[src_at] + p[4]]
    return out


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pieces, out_len, mesh):
        ctx.pieces, ctx.in_len, ctx.mesh = pieces, x.shape[1], mesh
        return _move(x, pieces, out_len, mesh, backward=False)

    @staticmethod
    def backward(ctx, g):
        return _move(g, ctx.pieces, ctx.in_len, ctx.mesh, backward=True), None, None, None


def exchange(x: torch.Tensor, src: Bounds, dst: Bounds, n: int, mesh, offset: int = 0,
             cyclic: bool = False) -> torch.Tensor:
    """This rank's destination range dst[rank] of the global axis-1 tensor
    held in layout `src` (n planes): plane i is global plane i + offset,
    mod n when cyclic, zero outside [0, n) otherwise. Destination ranges
    may overlap (a halo); the backward sums every copy's gradient into its
    source plane."""
    src, dst = tuple(map(tuple, src)), tuple(map(tuple, dst))
    pieces = _plan(src, dst, n, offset % n if cyclic and n else offset, cyclic)
    a, b = dst[mesh.space_rank]
    return _Exchange.apply(x, pieces, b - a, mesh)


def relayout(x: torch.Tensor, src: Bounds, dst: Bounds, mesh, offset: int = 0
             ) -> torch.Tensor:
    """Move a tensor from layout `src` to layout `dst` of the same planes
    (n: their union's end); a non-zero offset rolls it cyclically (plane i
    of the result is plane (i + offset) mod n: torch.roll by -offset of
    the whole axis). The identity where nothing moves."""
    src, dst = tuple(map(tuple, src)), tuple(map(tuple, dst))
    if src == dst and not offset:
        return x
    return exchange(x, src, dst, src[-1][1], mesh, offset, cyclic=True)


def halo(x: torch.Tensor, k: int, mesh) -> torch.Tensor:
    """The even slab with k planes of each neighbour on either side (zeros
    beyond the global ends); an empty slab stays empty."""
    n = grid_len(x)
    bounds = even_bounds(n, mesh.space)
    dst = tuple((lo - k, hi + k) if hi > lo else (lo, lo) for lo, hi in bounds)
    return exchange(x, bounds, dst, n, mesh)


class _SpaceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        return all_reduce(t.clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def space_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of t over the space group, on every rank of it; the backward
    is the identity (the result is replicated, its gradient counted once)."""
    if not is_spatial(mesh):
        return t
    return _SpaceSum.apply(t, mesh)


def set_spatial(module: torch.nn.Module, mesh) -> torch.nn.Module:
    """Give every submodule that declares a `spatial` attribute the mesh
    (None off a space axis): it then computes on this rank's slabs."""
    for m in module.modules():
        if hasattr(m, "spatial"):
            m.spatial = mesh if is_spatial(mesh) else None
    return module
