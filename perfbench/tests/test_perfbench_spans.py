"""The per-layer metrics that read the system's own spans
(perfbench/spans.py), on a traced run of the tiny resident cell on the
CPU: the seven interval metrics are reported (optimizer_idle_ms needs a
card's device time under its range), the four phases add up to the mean
step interval (the root span's mean length and the mean gap between
roots) and the model's three layers to forward + backward, each to within
3% of the step interval."""

import pytest

from perfbench import spans
from perfbench.tests import tiny

INTERVALS = ("forward_ms", "backward_ms", "optimizer_ms", "between_steps_ms", "encoder_ms",
             "decoders_ms", "head_ms")


@pytest.fixture
def traced_run():
    from nerf_mae_torch import tracing
    tracing.reset()
    c = tiny.cell("mae_b160_resident")
    c.workload["profile"] = {"skip_steps": 1, "steps": 3}
    line = tiny.run(c, traced=True)
    yield c, line
    tracing.reset()


def test_span_metrics_are_listed():
    c = tiny.cell("mae_b160_resident")
    listed = {m["name"]: m for m in c.per_layer}
    for name in INTERVALS + ("optimizer_idle_ms",):
        m = listed[name]
        assert m["source"] == "program_span" and m["moves"] == "grids_per_s"
        assert m["workloads"] == ["mae_b160_resident"]


def test_span_metrics_add_up(traced_run):
    c, line = traced_run
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(INTERVALS) <= set(got), sorted(got)
    assert "optimizer_idle_ms" not in got  # no device time under the range on the CPU
    assert all(got[k] > 0 for k in INTERVALS)
    from nerf_mae_torch import tracing
    roots = [r for r in tracing.records() if r.name == spans.ROOT]
    assert len(roots) == 3
    # the steps' mean interval: a root span's mean length and the mean gap
    step = sum(r.host_ms for r in roots) / 3 + got["between_steps_ms"]
    phases = got["forward_ms"] + got["backward_ms"] + got["optimizer_ms"] + got["between_steps_ms"]
    assert abs(phases - step) <= 0.03 * step, (phases, step)
    model = got["encoder_ms"] + got["decoders_ms"] + got["head_ms"]
    assert abs(model - got["forward_ms"] - got["backward_ms"]) <= 0.03 * step
    assert "mfu" in got  # the cell's other readers still read


def test_no_spans_no_reading():
    """Where the root spans do not match the trace's steps (a program
    without spans, or a stretch they do not cover) the readers return
    None."""
    class Trace:
        steps = 4
        range_device_s = {"nerf_mae.optimizer": 0.1}
    from nerf_mae_torch import tracing
    tracing.reset()
    ctx = {"trace": Trace()}
    assert spans.span_ms(ctx, "nerf_mae.forward") is None
    assert spans.piece_ms(ctx, "encoder") is None
    assert spans.between_steps_ms(ctx) is None
    assert spans.range_idle_ms(ctx, "nerf_mae.optimizer") is None
