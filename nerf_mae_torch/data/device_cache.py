"""A training corpus held on the card: batching as a device gather
(counterpart of nerf_mae_tpu/data/device_cache.py).

When the corpus is fixed (no fresh host augmentation per epoch) and fits
beside the train state, `--device_data` uploads it once and serves each
batch as an `index_select` on the device: the only per-step host-to-device
traffic is the [B] int64 index vector.

Device bytes = N * R^3 * C * itemsize: 128 scenes at 160^3 x 4 channels
take 4.19 GB in bf16 and 8.39 GB in float32. Float32 leaves with ndim >= 4
(the grids) are cast to `transfer_dtype` before the upload; small
per-scene leaves (sizes, boxes) keep their dtype, because rounding boxes
can make them degenerate. Patch-major leaves [N, T, T, T, p^3, C] are
stored channel-flat [N, T, T, T, p^3*C], the layout the transfer of the
host feed gives (common.transfer_batch), which the model and the loss
accept. Per-epoch host augments draw fresh randomness on every visit and
cannot be cached: the drivers refuse them with --device_data.

On a data-parallel mesh every rank holds the whole corpus, as the JAX
package replicates it over `data` (nerf_mae_tpu/data/device_cache.py:23-27),
and gathers its rows of each global batch's index vector. On a space axis
each rank stores only its slab (the even split of axis 1) of every grid
leaf, as the JAX corpus is sharded P(None, "space") (:97-131), and gathers
its data row's rows of it.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from nerf_mae_torch import tracing
from nerf_mae_torch.parallel.mesh import batch_rows
from nerf_mae_torch.parallel.spatial import even_bounds

log = logging.getLogger(__name__)

TRANSFER_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                   "float16": torch.float16}


def corpus_from_iterator(batches: Iterable[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Drain a host batch iterator (one epoch: loop=False, drop_last=False)
    and concatenate along the batch axis into one corpus dict."""
    chunks = list(batches)
    if not chunks:
        raise ValueError("corpus_from_iterator: empty iterator")
    return {k: (chunks[0][k] if len(chunks) == 1
                else np.concatenate([c[k] for c in chunks], axis=0))
            for k in chunks[0]}


def casts_to(v, transfer_dtype: Optional[str]) -> bool:
    """Whether leaf `v` is a float32 grid (ndim >= 4) that the transfer
    downcasts to `transfer_dtype`."""
    return (transfer_dtype not in (None, "float32") and v.ndim >= 4
            and v.dtype == np.float32)


def corpus_nbytes(corpus: Dict[str, np.ndarray], transfer_dtype: Optional[str] = None) -> int:
    """Device bytes the corpus occupies after the grid-leaf downcast."""
    return sum(v.size * (2 if casts_to(v, transfer_dtype) else v.dtype.itemsize)
               for v in corpus.values())


def device_corpus_batches(
    corpus: Dict[str, np.ndarray],
    device,
    batch_size: int,
    *,
    seed: int = 0,
    shuffle: bool = True,
    loop: bool = True,
    drop_last: bool = True,
    transfer_dtype: Optional[str] = None,
    rank: int = 0,
    world: int = 1,
    space_rank: int = 0,
    space: int = 1,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield batches gathered from the corpus uploaded once to `device`.

    The epoch order is mae_batch_iterator's: a RandomState(seed)
    permutation each epoch, the ragged tail dropped, or (drop_last=False)
    padded to batch_size by repeating its first index. `batch_size` is the
    global batch; world > 1 gathers rank's rows [rank*b, (rank+1)*b) of it
    (rank and world: the data axis). space > 1 keeps the space_rank-th slab
    of axis 1 of every grid leaf (ndim >= 4) on the device. The yielded
    dicts have the host iterator's keys and go straight to train_step.
    Span nerf_mae.feed.gather; counters feed.batches and feed.h2d_bytes
    (the index vector; tracing.py).
    """
    device = torch.device(device)
    n = len(next(iter(corpus.values())))
    if batch_size > n:
        raise ValueError(f"batch_size {batch_size} > corpus size {n}")
    own = batch_rows(batch_size, rank, world)
    if space > 1:
        corpus = {k: v[:, slice(*even_bounds(v.shape[1], space)[space_rank])]
                  if v.ndim >= 4 else v for k, v in corpus.items()}
    nbytes = corpus_nbytes(corpus, transfer_dtype)
    dev = {}
    for k, v in corpus.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if casts_to(v, transfer_dtype):
            t = t.to(TRANSFER_DTYPES[transfer_dtype])
        if t.ndim == 6:  # patch-major leaves, channel-flat
            t = t.reshape(*t.shape[:4], -1)
        dev[k] = t.to(device)
    log.info("device corpus: %d scenes, %.2f GB on %s (%s)", n, nbytes / 2**30, device,
             ", ".join(f"{k}{list(v.shape)} {v.dtype}" for k, v in dev.items()))

    rng = np.random.RandomState(seed)
    while True:
        order = rng.permutation(n) if shuffle else np.arange(n)
        for start in range(0, n, batch_size):
            sel = order[start:start + batch_size]
            if len(sel) < batch_size:
                if drop_last:
                    continue
                # static shapes: pad the tail by repeating its first index
                sel = np.concatenate([sel, np.full(batch_size - len(sel), sel[0], sel.dtype)])
            sel = sel[own]
            with tracing.span("nerf_mae.feed.gather"):
                idx = torch.from_numpy(np.asarray(sel, np.int64)).to(device, non_blocking=True)
                batch = {k: v.index_select(0, idx) for k, v in dev.items()}
            tracing.count("feed.batches")
            tracing.count("feed.h2d_bytes", idx.numel() * idx.element_size())
            yield batch
        if not loop:
            return
