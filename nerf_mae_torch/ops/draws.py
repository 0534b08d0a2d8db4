"""Random draws whose leading dimension is the batch, for one rank of a
data-parallel step.

JAX draws a step's masks, stochastic-depth keep factors and sampler
uniforms over the global batch, because jit sees the global array. A rank
here holds rows [start, start + b) of that batch: its `BatchGenerator`
makes each such draw at the global batch size `total` and keeps its rows,
so the rank sees exactly what those rows see in one process on the whole
batch. A plain torch.Generator draws at the size it is given.
"""

from __future__ import annotations

from typing import Sequence

import torch


class BatchGenerator(torch.Generator):
    """A torch.Generator that knows which rows of the global batch its
    caller holds: `start` and the global batch `total` (set after
    construction; manual_seed as usual)."""

    start: int = 0
    total: int = 0


def batch_generator(device, seed: int, start: int, total: int) -> BatchGenerator:
    gen = BatchGenerator(device=device)
    gen.manual_seed(seed)
    gen.start, gen.total = start, total
    return gen


def batch_rand(generator: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    """torch.rand(shape) on the generator's device, shape[0] being the batch:
    from a BatchGenerator, rows [start, start + shape[0]) of a draw of
    (total, *shape[1:])."""
    shape = tuple(shape)
    if not isinstance(generator, BatchGenerator):
        return torch.rand(shape, generator=generator, device=generator.device)
    full = torch.rand((generator.total,) + shape[1:], generator=generator,
                      device=generator.device)
    return full[generator.start: generator.start + shape[0]]
