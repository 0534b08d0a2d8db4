"""fused_block_fwd_roofline: the fwd fused Swin-block calls' share of their
roofline over the profiled steps (perfbench/readers.py)."""

from perfbench.readers import fused_block_roofline


def read(ctx):
    return fused_block_roofline(ctx, "fwd")
