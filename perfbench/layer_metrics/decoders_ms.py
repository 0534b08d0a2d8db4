"""decoders_ms: the UNETR decoders 4, 3 and 2, forward and backward
(recomputation included), ms a step on the device clock
(perfbench/spans.py)."""

from perfbench.spans import piece_ms


def read(ctx):
    return piece_ms(ctx, "decoders")
