"""full_res_roofline: percent of the bound of a step's forward and
backward of encoder1 and decoder1 (perfbench/dense_counts.py, no
recompute) over their device intervals a step (full_res_ms: the spans
nerf_mae.encoder1, nerf_mae.decoder1 and their .bwd, recomputation
included). Intervals and not the device time under the spans' profiler
ranges: the profiler gives a checkpointed forward range up to 1.6x its
interval (on an H100, encoder1 209 ms of device time in a 140 ms
interval), while the device runs the step's kernels back to back. None
off the card or where the spans are missing."""

from perfbench import dense_counts
from perfbench.spans import span_ms

NAMES = ("nerf_mae.encoder1", "nerf_mae.decoder1", "nerf_mae.encoder1.bwd",
         "nerf_mae.decoder1.bwd")


def read(ctx):
    if ctx["device"].type != "cuda":
        return None
    ms = span_ms(ctx, *NAMES)
    if not ms:
        return None
    task = ctx["task"]
    return 100.0 * 1e3 * dense_counts.full_res_bound_s(task.cfg, task.batch) / ms
