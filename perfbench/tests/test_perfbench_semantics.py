"""The voxel semantics cell, sem_s160, at a tiny size on the CPU: its run
is correct; the reference agrees with the system's plain path; the control
(the reference in fp8 in the system's place) and the planted faults come
out incorrect; its configuration is the port's swin_s at the recipe's
sizes; its FLOP count reaches `mfu` and its full-resolution roofline reads
the device time under the spans."""

import tempfile

import pytest
import torch

from perfbench import counts, dense_counts, harness, spec, training
from perfbench.reference.swin import Numerics
from perfbench.tests import tiny
from perfbench.tests.test_perfbench_reference import broken

NAME = "sem_s160"


def _cell(compute_dtype="float32"):
    c = tiny.cell(NAME, compute_dtype)
    c.traffic.update(half_extent=[2, 5], boxes=[2, 5])
    return c


def _task(c, seed=9):
    run = harness.Run(c, seed, torch.device("cpu"), tempfile.mkdtemp(prefix="perfbench-"))
    task = spec.task(c.workload["task"]).build(run)
    task.close()
    return task


def test_run_is_correct():
    line = tiny.run(_cell(), seed=2 ** 33 + 7)
    assert line["correct"] and line["failed"] == 0, line["checks"]
    assert line["checks"]["batch_gap"]["value"] == 0.0
    assert set(line["metrics"]) == {"grids_per_s", "step_ms_p90", "setup_s"}


def test_traced_run_reads_the_pieces():
    from nerf_mae_torch import tracing
    tracing.reset()
    line = tiny.run(_cell(), traced=True)
    tracing.reset()
    got = line["metrics"]
    for name in ("mfu", "forward_ms", "backward_ms", "encoder_ms", "decoders_ms", "head_ms",
                 "full_res_ms"):
        assert got[name]["value"] > 0, name
    # no device time under the ranges on the CPU
    assert "full_res_roofline" not in got and "optimizer_idle_ms" not in got


def test_reference_agrees():
    """The system's plain path in float32 and the reference: the losses,
    terms and first gradients to float32 rounding (amplified by the
    instance norms' backward at the tiny grids)."""
    task = _task(_cell())
    r = training.readings(task.program, task.reference_records(Numerics("float32")))
    assert task.batch_gap() == 0.0
    assert r["loss_rel"] < 1e-5 and r["term_rel"] < 1e-5 and r["grad_gap"] < 1e-2, r
    assert r["change_gap"] < 5e-2, r


def test_fp8_control_incorrect():
    c = _cell()
    task = _task(c)
    ref = task.reference_records(Numerics("float32"))
    sound = {**training.readings(task.program, ref), "batch_gap": 0.0}
    assert harness.verdict(sound, c.workload["limits"])[0]
    control = {**training.readings(task.reference_records(Numerics("fp8")), ref),
               "batch_gap": 0.0}
    assert not harness.verdict(control, c.workload["limits"])[0]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered_row"])
def test_broken_step_incorrect(fault):
    with broken(fault):
        line = tiny.run(_cell())
    assert not line["correct"] and line["failed"] > 0


def test_configuration_is_the_ports_swin_s():
    from nerf_mae_torch.config import SWIN_PRESETS
    cfg = spec.cell(NAME).config
    s = SWIN_PRESETS[cfg["backbone"]]
    assert (cfg["embed_dim"], tuple(cfg["depths"]), tuple(cfg["num_heads"])) == (
        s.embed_dim, s.depths, s.num_heads)
    assert tuple(cfg["window_size"]) == s.window_size and (cfg["patch_size"],) * 3 == s.patch_size
    assert (cfg["mlp_ratio"], cfg["stochastic_depth_prob"], cfg["norm_eps"]) == (
        s.mlp_ratio, s.stochastic_depth_prob, s.norm_eps)
    assert (cfg["resolution"], cfg["num_classes"], cfg["batch_size"]) == (160, 19, 8)
    assert spec.cell(NAME).traffic["batch"] == cfg["batch_size"]


def test_counts():
    cfg = spec.cell(NAME).config
    assert counts.FLOPS_PER_GRID["semantics"] is dense_counts.semantics_flops_per_grid
    per_grid = dense_counts.semantics_flops_per_grid(cfg)
    # decoder1's 3^3 conv on the concatenated 96 channels: ~1.02 TFLOP a grid
    assert 2.0 * 160 ** 3 * 27 * 96 * 48 == pytest.approx(1.019e12, rel=1e-3)
    assert per_grid["decoder1"] > 1.019e12
    flops, nbytes = dense_counts.full_res_work(cfg, 8)
    fwd = 8 * (per_grid["encoder1"] + per_grid["decoder1"])
    # the backward: both products except the input gradient of encoder1's
    # convs on the grid (conv1, conv3)
    grid_convs = 8 * 2.0 * 160 ** 3 * 4 * 48 * (27 + 1)
    assert flops == pytest.approx(3 * fwd - grid_convs, rel=1e-12)
    assert dense_counts.full_res_bound_s(cfg, 8) == pytest.approx(
        max(flops / 989e12, nbytes / 3.35e12), rel=1e-12)


def test_full_res_roofline_reads_the_intervals(monkeypatch):
    """The bound over the stack's span intervals a step, on the card only."""
    reader = spec.layer_metric("full_res_roofline")
    task = type("Task", (), {"cfg": spec.cell(NAME).config, "batch": 8})()
    got = {}
    monkeypatch.setattr(reader, "span_ms", lambda ctx, *names: got.setdefault("names", names)
                        and 1000.0)
    bound = dense_counts.full_res_bound_s(task.cfg, 8)
    ctx = {"task": task, "device": torch.device("cuda")}
    assert reader.read(ctx) == pytest.approx(100 * bound)
    assert set(got["names"]) == {f"nerf_mae.{p}{b}" for p in ("encoder1", "decoder1")
                                 for b in ("", ".bwd")}
    assert reader.read({**ctx, "device": torch.device("cpu")}) is None
    monkeypatch.setattr(reader, "span_ms", lambda ctx, *names: None)
    assert reader.read(ctx) is None


def test_reference_imports_nothing_of_the_system():
    from perfbench.tests.test_perfbench_jax_free import _imports
    tops = set(_imports(spec.ROOT / "perfbench/reference/semantics.py"))
    assert tops <= {"__future__", "typing", "numpy", "torch"}
