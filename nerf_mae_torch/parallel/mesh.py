"""Data and grid parallelism over torch.distributed (counterpart of
nerf_mae_tpu/parallel/mesh.py, whose `data` axis replaces the reference's
NCCL DDP: nerf_mae/run_swin_mae3d.py:809-902, its DistributedSampler at
:578-586; its `space` axis shards the voxel grid).

A `DataMesh` is one rank's view of the process group: its rank, the world
size, its local rank, its device and the group, laid out as a row-major
[data, space] grid (make_mesh_2d): rank r sits at data index r // S and
space index r % S, and the S ranks of one data row form its `space_group`.
The batch is sharded over `data`, the parameters are replicated, and with
S > 1 every grid leaf (ndim >= 4) is cut into slabs of its axis 1 over
`space` (parallel/spatial.py computes on them):

    mesh = make_mesh()                      # torchrun's env, or world size 1
    trainer = MAETrainer(mae_cfg, train_cfg, total_steps, mesh=mesh)
    state = trainer.init(seed)              # replicate(model, mesh)
    batch = shard_batch(host_batch, mesh)   # rows [d*b, (d+1)*b), slab of the grids
    state, metrics = trainer.train_step(state, batch)  # global metrics

The trainers reduce with explicit collectives, not through a
DistributedDataParallel wrapper:
- they call model methods outside `forward` (the MAE's `encode`, the RCNN's
  `sample`, `pool` and `scores`), and DDP prepares its reducer only inside
  `forward`;
- detection has parameters that a step leaves without a gradient, which
  DDP's reducer must be told about and the trainers fill with zeros anyway;
- the losses divide by counts taken over the whole batch (`count_sum`, each
  loss's hook), so a rank's loss is its share of the global loss and the
  gradients are summed, not averaged.
`all_reduce_grads` sums the gradients after the backward, in the order of
the parameters, in a few flat buffers: every rank then clips the same
global gradient and makes the same non-finite skip decision, as JAX's
jitted step does. Overlapping the reduction with the backward (DDP's
buckets) is left for later.

With no process group (no torchrun environment and no explicit world size)
the mesh is one rank without a group and every collective here is the
identity. With a group, even of one rank (torchrun --nproc_per_node 1),
every collective runs. The gradients, counts and metrics are summed over
the whole world: a slab's gradient is a partial sum, as a row's is.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from nerf_mae_torch.parallel.spatial import grid_slab, is_spatial

log = logging.getLogger(__name__)

# flat gradient buffers hold at most this many bytes each
BUCKET_BYTES = 256 * 2**20
# a collective that waits longer than this raises (a rank died or hangs)
TIMEOUT = datetime.timedelta(minutes=30)


@dataclasses.dataclass
class DataMesh:
    """One rank of a data-parallel group. `group` is None for a lone
    process (world size 1, collectives are the identity). It counts the
    collectives it ran and the gradient bytes it reduced, and logs both
    when closed. As a context manager it destroys the group it created on
    exit."""

    rank: int
    world_size: int
    local_rank: int
    device: torch.device
    group: Optional[Any] = None
    owns_group: bool = False
    collectives: int = 0
    grad_bytes: int = 0
    space: int = 1  # the size of the space axis
    space_group: Optional[Any] = None  # the S ranks of this rank's data row

    @property
    def data_world(self) -> int:
        return self.world_size // self.space

    @property
    def data_rank(self) -> int:
        return self.rank // self.space

    @property
    def space_rank(self) -> int:
        return self.rank % self.space

    def close(self) -> None:
        if self.group is not None:
            log.info("data mesh rank %d of %d (%s): %d collectives, %d gradient bytes "
                     "reduced", self.rank, self.world_size, dist.get_backend(self.group),
                     self.collectives, self.grad_bytes)
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.group = None
        self.owns_group = False

    def __enter__(self) -> "DataMesh":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value in (None, "") else int(value)


def _local_rank(rank: int, device: str) -> int:
    """LOCAL_RANK, else the rank (modulo the cards on "cuda")."""
    local = _env_int("LOCAL_RANK")
    if local is not None:
        return local
    return rank % torch.cuda.device_count() if device == "cuda" else rank


def make_mesh(n_devices: Optional[int] = None, device: str = "cuda",
              backend: Optional[str] = None, rank: Optional[int] = None,
              world_size: Optional[int] = None,
              init_method: Optional[str] = None, n_space: int = 1) -> DataMesh:
    """This rank's DataMesh.

    The process group is the one already initialised, else one started from
    the explicit arguments (rank, world_size, init_method such as
    "tcp://localhost:29500"), else from torchrun's environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR / MASTER_PORT). Without any, the
    mesh is world size 1 with no group. The backend is nccl for "cuda" and
    gloo for "cpu" unless named. The device is cuda:LOCAL_RANK (the rank
    modulo the cards without it), or the CPU when asked for; asking for
    cuda without a card raises (no fallback).
    Raises when n_devices asks for more ranks than exist: a silently smaller
    mesh would make a multi-rank run prove nothing (mesh.py:31-40).
    n_space > 1 lays the world out as [world / n_space, n_space]
    (make_mesh_2d) and makes the space groups (every rank makes every group,
    in the same order); it raises unless it divides the world."""
    if n_space < 1:
        raise ValueError(f"n_space must be >= 1, got {n_space}")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: device 'cuda' requested but no CUDA device is "
                           "available (pass device='cpu' for gloo ranks on the CPU)")
    owns = False
    if dist.is_initialized():
        rank, world_size = dist.get_rank(), dist.get_world_size()
    else:
        world_size = world_size if world_size is not None else _env_int("WORLD_SIZE")
        if world_size is not None:
            rank = rank if rank is not None else _env_int("RANK")
            if rank is None:
                raise ValueError("make_mesh: a world size without a rank (set RANK or "
                                 "pass rank=)")
            if backend is None:
                backend = "nccl" if device == "cuda" else "gloo"
            if device == "cuda":  # before the group, so that NCCL binds this card
                torch.cuda.set_device(_local_rank(rank, device))
            dist.init_process_group(backend, init_method=init_method or "env://",
                                    rank=rank, world_size=world_size, timeout=TIMEOUT)
            owns = True
        else:
            rank, world_size = 0, 1
    if n_devices is not None and n_devices > world_size:
        raise RuntimeError(
            f"make_mesh: asked for {n_devices} ranks but the world has {world_size}; "
            f"start {n_devices} processes (torchrun --nproc_per_node {n_devices}, or "
            "WORLD_SIZE / RANK / MASTER_ADDR / MASTER_PORT for each)")
    if n_devices is not None and n_devices < world_size:
        raise RuntimeError(f"make_mesh: asked for {n_devices} ranks of a world of "
                           f"{world_size}; a mesh spans the whole group")
    if world_size % n_space:
        raise ValueError(f"make_mesh: a space axis of {n_space} does not divide a world of "
                         f"{world_size} ranks (start a multiple of --mesh_space processes)")
    local_rank = _local_rank(rank, device)
    dev = torch.device("cuda", local_rank) if device == "cuda" else torch.device("cpu")
    group = dist.group.WORLD if dist.is_initialized() else None
    space_group = None
    for d in range(world_size // n_space if n_space > 1 else 0):
        g = dist.new_group(list(range(d * n_space, (d + 1) * n_space)))
        if d == rank // n_space:
            space_group = g
    return DataMesh(rank, world_size, local_rank, dev, group, owns, space=n_space,
                    space_group=space_group)


def prepare_spatial_config(mesh: Optional[DataMesh], swin_cfg):
    """A SwinConfig for the grid sharding (mesh.py:88-128); unchanged off a
    space axis. attention_impl "kernel" is refused: the fused kernels take
    whole grids, not slabs (as pallas_call has no partitioning rule);
    "auto" becomes "plain", whose window attention the slabs partition."""
    if not is_spatial(mesh):
        return swin_cfg
    if swin_cfg.attention_impl == "kernel":
        raise ValueError(
            "attention_impl='kernel' cannot run under spatial sharding; use 'plain' (the "
            "window attention is partitioned over the space axis with explicit halo "
            "exchanges and relayouts)")
    if swin_cfg.attention_impl == "auto":
        return dataclasses.replace(swin_cfg, attention_impl="plain")
    return swin_cfg


def check_token_grid(mesh: Optional[DataMesh], token_grid: int) -> None:
    """Refuse a token grid that the space axis does not divide: the voxel
    slabs (an even split of R = p T) must hold whole patches."""
    if is_spatial(mesh) and token_grid % mesh.space:
        raise ValueError(f"the token grid {token_grid} (resolution / patch) does not divide "
                         f"over a space axis of {mesh.space}: choose --mesh_space among its "
                         "divisors")


def distributed(mesh: Optional[DataMesh]) -> bool:
    """Whether the mesh has a process group (its collectives run)."""
    return mesh is not None and mesh.group is not None


def is_main(mesh: Optional[DataMesh]) -> bool:
    """Rank 0, or a lone process: the rank that writes checkpoints, logs and
    reports."""
    return mesh is None or mesh.rank == 0


def barrier(mesh: Optional[DataMesh]) -> None:
    if not distributed(mesh):
        return
    if dist.get_backend(mesh.group) == "nccl":
        dist.barrier(mesh.group, device_ids=[mesh.device.index])
    else:
        dist.barrier(mesh.group)


def batch_rows(batch: int, rank: int = 0, world: int = 1) -> slice:
    """Rank's rows [rank*b, (rank+1)*b) of a global batch of `batch` rows,
    b = batch / world; raises when the batch does not divide by the world
    size."""
    if batch % world:
        raise ValueError(f"a global batch of {batch} does not divide over {world} ranks "
                         "(--batch_size is global: make it a multiple of the world size)")
    b = batch // world
    return slice(rank * b, (rank + 1) * b)


def host_slab(batch: Dict[str, np.ndarray], mesh: Optional[DataMesh]
              ) -> Dict[str, np.ndarray]:
    """This rank's slab (grid_slab of axis 1) of every grid leaf (ndim >=
    4: the dense [B, R, R, R, C] grids, the patch-major [B, T, T, T, ...]
    ones, label grids), as grid_pspec shards them; other leaves whole."""
    if not is_spatial(mesh):
        return batch
    return {k: v[:, grid_slab(v.shape[1], mesh)] if v.ndim >= 4 else v
            for k, v in batch.items()}


def shard_batch(batch: Dict[str, np.ndarray], mesh: Optional[DataMesh],
                transfer_dtype: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global host batch (its data row's), and its
    slab of every grid leaf on a space axis, on the mesh's device, through
    the transfer of common.HostToDevice (patch-major leaves channel-flat,
    float32 grid leaves cast to transfer_dtype). Raises when the batch does
    not divide over the data axis (scripts/run_mae_pretrain.py:245)."""
    from nerf_mae_torch.common import HostToDevice  # common imports this module

    n = len(next(iter(batch.values())))
    sl = batch_rows(n) if mesh is None else batch_rows(n, mesh.data_rank, mesh.data_world)
    device = torch.device("cpu") if mesh is None else mesh.device
    put = HostToDevice(device, transfer_dtype)
    return put.ready(put(host_slab({k: v[sl] for k, v in batch.items()}, mesh)))


def _flat_groups(tensors: Sequence[torch.Tensor], cap_bytes: Optional[int] = None):
    """Indices of `tensors` grouped by (device, dtype) in their order, each
    group cut into buckets of at most cap_bytes (one tensor at least)."""
    groups: Dict[Any, List[List[int]]] = {}
    sizes: Dict[Any, int] = {}
    for i, t in enumerate(tensors):
        key = (t.device, t.dtype)
        nbytes = t.numel() * t.element_size()
        buckets = groups.setdefault(key, [[]])
        if cap_bytes is not None and buckets[-1] and sizes[key] + nbytes > cap_bytes:
            buckets.append([])
            sizes[key] = 0
        buckets[-1].append(i)
        sizes[key] = sizes.get(key, 0) + nbytes
    return [b for buckets in groups.values() for b in buckets]


def _reduce_flat(tensors: Sequence[torch.Tensor], mesh: DataMesh, op: str,
                 cap_bytes: Optional[int] = None) -> None:
    """In place: `op` ("sum" over ranks, or "broadcast" from rank 0) of each
    tensor, through one flat buffer per bucket."""
    for bucket in _flat_groups(tensors, cap_bytes):
        parts = [tensors[i] for i in bucket]
        flat = torch.cat([t.detach().reshape(-1) for t in parts])
        mesh.collectives += 1
        if op == "sum":
            dist.all_reduce(flat, dist.ReduceOp.SUM, group=mesh.group)
        else:
            dist.broadcast(flat, 0, group=mesh.group)
        with torch.no_grad():
            torch._foreach_copy_([t.detach() for t in parts],
                                 [v.view_as(t) for v, t in
                                  zip(flat.split([t.numel() for t in parts]), parts)])


def replicate(module: torch.nn.Module, mesh: Optional[DataMesh]) -> torch.nn.Module:
    """Broadcast the module's parameters and buffers from rank 0 (in place,
    through copy_, which bumps each tensor's version: a cache keyed on it,
    as SwinBlock3D's weight casts are, is rebuilt)."""
    if distributed(mesh):
        tensors = list(module.parameters()) + list(module.buffers())
        _reduce_flat(tensors, mesh, "broadcast", BUCKET_BYTES)
    return module


def all_reduce_grads(params: Iterable[torch.nn.Parameter], mesh: Optional[DataMesh]) -> int:
    """Sum every parameter's .grad over the ranks, in the parameters' order,
    in flat buffers of at most BUCKET_BYTES. The sum's order is the
    collective's, the same on every step, so the result is deterministic.
    Every parameter must have a gradient. Returns the bytes reduced."""
    grads = [p.grad for p in params]
    if not distributed(mesh):
        return 0
    _reduce_flat(grads, mesh, "sum", BUCKET_BYTES)
    nbytes = sum(g.numel() * g.element_size() for g in grads)
    mesh.grad_bytes += nbytes
    return nbytes


def all_reduce_sum(tensors: Sequence[torch.Tensor], mesh: Optional[DataMesh]
                   ) -> List[torch.Tensor]:
    """The sums over the ranks of `tensors` (counts, metrics), as new
    tensors without autograd history, in one flat collective per dtype.
    Without a group: the tensors themselves."""
    tensors = list(tensors)
    if not distributed(mesh):
        return tensors
    out = [t.detach().clone() for t in tensors]
    _reduce_flat(out, mesh, "sum")
    return out


def count_sum(t: torch.Tensor, mesh: Optional[DataMesh]) -> torch.Tensor:
    """One tensor's sum over the ranks: the losses' `count_sum` hook, applied
    to a denominator before its clamp."""
    return all_reduce_sum([t], mesh)[0]


def gather_objects(obj: Any, mesh: Optional[DataMesh]) -> List[Any]:
    """Every rank's `obj` (picklable), in rank order, on every rank."""
    if not distributed(mesh):
        return [obj]
    out: List[Any] = [None] * mesh.world_size
    mesh.collectives += 1
    dist.all_gather_object(out, obj, group=mesh.group)
    return out
