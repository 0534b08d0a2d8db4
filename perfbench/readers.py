"""Arithmetic the per-layer readers (layer_metrics/*.py) share. A reader
is read(ctx) -> float or None; ctx holds the cell, the task, the window
({"steps", "wall_s", "step_ms", "peak_bytes"}), the trace summary of the
profiled stretch, the kernels' launch counts over that stretch and the
device. None leaves the metric out of the result line."""

from __future__ import annotations

from typing import Optional

from perfbench import counts, trace

# The hand-written kernels' entry points (nerf_mae_torch/csrc): every
# launch of them on the main path comes from a fused-block call.
HAND_WRITTEN = (r"\b(gemm_tc|gemm_fma|window_attn_\w+|ln_rows|gather_rows|sum_parts"
                r"|colsum_part|dout_rows|ln1_bwd_rows|ln2_bwd_rows)\b")
# the autograd nodes whose device time is a fused-block call's
RANGES = {"fwd": "FusedSwinBlockFn", "bwd": "FusedSwinBlockFnBackward"}


def fused_block_roofline(ctx: dict, kind: str) -> Optional[float]:
    """Percent of the summed bound of the profiled steps' fused-block calls
    of `kind` over the device time those calls launched. None where the
    launch counter does not read the expected calls a step (the step no
    longer runs them as counted here) or where the trace does not tie the
    hand-written kernels' time to the calls."""
    summary, task = ctx["trace"], ctx["task"]
    cfg, steps = task.cfg, summary.steps
    dtype = cfg["compute_dtype"]
    calls = counts.fused_block_calls(cfg, task.batch)
    if not calls or ctx["launches"].get(f"fused_block_{kind}") != steps * len(calls):
        return None
    spent = summary.range_device_s.get(RANGES[kind])
    both = sum(summary.range_device_s.get(r, 0.0) for r in RANGES.values())
    kernels = trace.device_s_matching(summary, HAND_WRITTEN)
    if not spent or kernels <= 0 or both < 0.99 * kernels:
        return None
    bound = steps * counts.fused_block_bound_s(cfg, task.batch, kind, dtype)
    return 100.0 * bound / spent


def mfu(ctx: dict) -> Optional[float]:
    """Percent of the card's dense bf16 peak: the model FLOPs of the grids
    trained in the whole window over its wall time."""
    task, w = ctx["task"], ctx["window"]
    per_grid = counts.FLOPS_PER_GRID[task.kind](task.cfg)["train_total"]
    return 100.0 * per_grid * w["steps"] * task.grids_per_step / w["wall_s"] / counts.PEAK_FLOPS[
        "bfloat16"]


def idle_pct(ctx: dict) -> Optional[float]:
    share = ctx["trace"].idle_share
    return None if share is None else 100.0 * share
