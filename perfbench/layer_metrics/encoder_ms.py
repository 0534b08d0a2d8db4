"""encoder_ms: the patch embedding and mask, the four Swin stages and their
mergings, forward and backward, ms a step on the device clock
(perfbench/spans.py)."""

from perfbench.spans import piece_ms


def read(ctx):
    return piece_ms(ctx, "encoder")
