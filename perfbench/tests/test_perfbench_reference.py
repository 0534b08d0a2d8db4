"""At a tiny size on the CPU: each task's reference agrees with the
system's plain path, the control (the reference computed in fp8 in the
system's place) is judged incorrect, and a run whose timed path is broken
underneath comes out incorrect, once for each fault a cell can have."""

import contextlib
import tempfile

import pytest
import torch

from perfbench import harness, spec, training
from perfbench.reference.swin import Numerics
from perfbench.tests import tiny

CELLS = ["mae_b160_resident", "mae_b160_disk"]


@pytest.mark.parametrize("name", CELLS)
def test_run_is_correct(name):
    line = tiny.run(tiny.cell(name))
    assert line["correct"] and line["failed"] == 0
    assert line["checks"]["batch_gap"]["value"] == 0.0


@pytest.mark.parametrize("name", CELLS + ["fcos_s160_obb"])
def test_reference_agrees(name):
    """The system's plain path in float32 and the reference: the same
    losses, loss terms and first gradients to float32 rounding."""
    task = _task(tiny.cell(name))
    r = training.readings(task.program, task.reference_records(Numerics("float32")))
    assert task.batch_gap() == 0.0
    assert r["loss_rel"] < 1e-5 and r["term_rel"] < 1e-5 and r["grad_gap"] < 1e-4, r
    assert r["change_gap"] < 1e-2, r


def _task(c, seed=9):
    """A task built as a run's set-up builds it, its state freed."""
    run = harness.Run(c, seed, torch.device("cpu"), tempfile.mkdtemp(prefix="perfbench-"))
    task = spec.task(c.workload["task"]).build(run)
    task.close()
    return task


@pytest.mark.parametrize("name", CELLS)
def test_fp8_control_incorrect(name):
    """The control in the system's place: its first steps judged by the
    cell's limits against the float32 reference."""
    c = tiny.cell(name)
    task = _task(c)
    ref = task.reference_records(Numerics("float32"))
    control = training.readings(task.reference_records(Numerics("fp8")), ref)
    correct, _ = harness.verdict({**control, "batch_gap": 0.0}, c.workload["limits"])
    assert not correct
    sound = training.readings(task.program, ref)
    assert harness.verdict({**sound, "batch_gap": 0.0}, c.workload["limits"])[0]


@contextlib.contextmanager
def broken(what):
    """The system's step broken underneath: "unchanged" leaves the state as
    it was (no optimizer update); "half_batch" trains on the first half of
    each batch; "altered_row" changes a voxel of each batch where the feed
    produces it."""
    from nerf_mae_torch.train import trainer as trainer_mod
    saved = (trainer_mod.Trainer.apply_gradients, training.TrainingTask.next_batch)

    def no_update(self, state):
        state.step += 1
        return torch.zeros(())

    def half(self):
        batch = saved[1](self)
        return {k: v[: v.shape[0] // 2] for k, v in batch.items()}

    def altered(self):
        batch = dict(saved[1](self))
        grids = batch["grids"].clone()
        grids.view(-1)[7] += 0.5
        batch["grids"] = grids
        return batch

    if what == "unchanged":
        trainer_mod.Trainer.apply_gradients = no_update
    else:
        training.TrainingTask.next_batch = half if what == "half_batch" else altered
    try:
        yield
    finally:
        trainer_mod.Trainer.apply_gradients, training.TrainingTask.next_batch = saved


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered_row"])
def test_broken_step_incorrect(name, fault):
    with broken(fault):
        line = tiny.run(tiny.cell(name))
    assert not line["correct"] and line["failed"] > 0
