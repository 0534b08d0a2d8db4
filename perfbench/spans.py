"""The system's own spans (nerf_mae_torch/tracing.py, on while the
profiler records) over a traced run's profiled stretch, for the per-layer
readers of the train step's phases, the feed, the model's pieces and the
optimizer's idle time. A reading is ms a step, averaged over the profiled
steps, on the device clock (each span's CUDA events) where the run has a
card, else on the host's. None where the system keeps no spans (a checkout
without tracing.py) or where the number of train-step root spans is not
the trace's number of steps."""

from __future__ import annotations

import re
from typing import Collection, Optional, Tuple

ROOT = "nerf_mae.train_step"
# the model's pieces by layer: forward spans, and the backward records the
# marks on their outputs make (`<piece>.bwd`); a stage's forward span holds
# its merge, the backward has the merge's own record
PIECES = {"encoder": r"embed|stage\d+|merge\d+", "decoders": r"decoder\d+",
          "head": r"head|loss"}


def records(ctx: dict) -> Optional[list]:
    try:
        from nerf_mae_torch import tracing
    except ImportError:
        return None
    recs = tracing.records()
    steps = ctx["trace"].steps
    if not steps or sum(r.name == ROOT for r in recs) != steps:
        return None
    return recs


def _on_device(recs: list) -> bool:
    return any(r.name == ROOT and r.device_start_ms is not None for r in recs)


def interval(r, device: bool) -> Optional[Tuple[float, float]]:
    """(start, end) in ms on the device's clock, or the host's."""
    if device:
        return None if r.device_start_ms is None else (r.device_start_ms, r.device_end_ms)
    return r.start_ns / 1e6, r.end_ns / 1e6


def _total_ms(recs: list, names: Collection[str]) -> Optional[float]:
    device = _on_device(recs)
    spans = [interval(r, device) for r in recs if r.name in names]
    if not spans or None in spans:
        return None
    return sum(b - a for a, b in spans)


def span_ms(ctx: dict, *names: str) -> Optional[float]:
    """The summed intervals of the spans named, a step."""
    recs = records(ctx)
    if recs is None:
        return None
    total = _total_ms(recs, names)
    return None if total is None else total / ctx["trace"].steps


def piece_ms(ctx: dict, layer: str) -> Optional[float]:
    """One layer of the model's pieces, forward and backward, a step."""
    recs = records(ctx)
    if recs is None:
        return None
    rx = re.compile(rf"^nerf_mae\.({PIECES[layer]})(\.bwd)?$")
    names = {r.name for r in recs if rx.match(r.name)
             and (r.name.endswith(".bwd") or not r.name.startswith("nerf_mae.merge"))}
    total = _total_ms(recs, names)
    return None if total is None else total / ctx["trace"].steps


def between_steps_ms(ctx: dict) -> Optional[float]:
    """From one train step's end to the next one's start, averaged over the
    gaps of the profiled steps."""
    recs = records(ctx)
    if recs is None or ctx["trace"].steps < 2:
        return None
    device = _on_device(recs)
    roots = sorted((interval(r, device) for r in recs if r.name == ROOT),
                   key=lambda ab: ab[0])
    gaps = [b[0] - a[1] for a, b in zip(roots, roots[1:])]
    return sum(gaps) / len(gaps)


def range_idle_ms(ctx: dict, name: str) -> Optional[float]:
    """A span's interval less the device time launched under its profiler
    range, a step: the device waiting for the host inside the span."""
    interval_ms = span_ms(ctx, name)
    busy = ctx["trace"].range_device_s.get(name)
    if interval_ms is None or not busy:
        return None
    return interval_ms - 1e3 * busy / ctx["trace"].steps
