"""mfu: model FLOPs of the grids trained in the traced window over its wall
time, as a percent of the H100's 989 TFLOP/s dense bf16 peak."""

from perfbench.readers import mfu


def read(ctx):
    return mfu(ctx)
