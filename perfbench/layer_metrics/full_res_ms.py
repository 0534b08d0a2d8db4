"""full_res_ms: the full-resolution stack of a dense head, encoder1 and
decoder1 (the spans nerf_mae.encoder1 and nerf_mae.decoder1), forward and
backward (recomputation included), ms a step on the device clock
(perfbench/spans.py)."""

from perfbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "nerf_mae.encoder1", "nerf_mae.decoder1", "nerf_mae.encoder1.bwd",
                   "nerf_mae.decoder1.bwd")
