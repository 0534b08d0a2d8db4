"""`python -m nerf_mae_torch.bench`, the port of bench.py, on the CPU at
swin_nano 32^3 (the NERF_MAE_BENCH_* size overrides): its JSON line has
bench.py's keys (plus the device); two gloo ranks report n_chips,
value_total and scaling_efficiency; a SIGTERM mid-run prints exactly one
line and exits by its value; a failure other than out-of-memory prints a
zero with an error phase and raises instead of trying a smaller batch; an
out-of-memory moves on to the next batch probe."""

import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

import bench as jax_bench
from nerf_mae_torch import bench
from nerf_mae_torch.parallel import dryrun
from nerf_mae_torch.train.trainer import MAETrainer

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"NERF_MAE_BENCH_PRESET": "swin_nano", "NERF_MAE_BENCH_RESOLUTION": "32",
         "NERF_MAE_BENCH_REPS": "1", "NERF_MAE_BENCH_PER_CHIP_BATCH": "1"}


@pytest.fixture
def small(monkeypatch):
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)


def _jax_keys(capsys, n_chips=None):
    """The keys of bench.py's line, from its _emit (no JAX step runs)."""
    jax_bench._state.update(value=1.0, mfu=0.1, step_ms=1.0, phase="done",
                            n_chips=n_chips, value_total=2.0 if n_chips else None,
                            scaling_efficiency=0.5 if n_chips else None, emitted=False)
    jax_bench._emit()
    return set(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))


def _lines(text):
    return [json.loads(l) for l in text.splitlines() if l.startswith("{")]


def test_one_process_line_has_bench_keys(small, capsys):
    handlers = [signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)]
    out = bench.main(["--device", "cpu"])
    lines = _lines(capsys.readouterr().out)
    assert lines == [out]
    assert out["phase"] == "done" and out["value"] > 0 and out["step_ms"] > 0
    assert out["metric"] == "grids_per_sec_per_chip_swinb_mae3d_160"
    assert out["vs_baseline"] == pytest.approx(out["value"] / 3.0)
    assert out["device"] == "cpu"
    assert "mfu" not in out  # no device metric from a CPU run
    want = _jax_keys(capsys) - {"mfu"}
    assert set(out) - {"device"} == want
    assert [signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)] == handlers


def test_two_gloo_ranks_report_scaling(small, capsys):
    outs = dryrun.launch("nerf_mae_torch.bench:main", 2, {"argv": ["--device", "cpu"]},
                         timeout_s=300)
    out = outs[0]
    assert out["phase"] == "done" and out["value"] > 0
    assert out["n_chips"] == 2
    assert out["value_total"] == pytest.approx(2 * out["value"], rel=0.01)
    assert out["scaling_efficiency"] > 0
    assert set(out) - {"device"} == _jax_keys(capsys, n_chips=2) - {"mfu"}


def test_sigterm_mid_run_prints_one_line(tmp_path):
    env = {**os.environ, **SMALL, "NERF_MAE_BENCH_REPS": "100000", "OMP_NUM_THREADS": "1"}
    env.pop("RANK", None)
    env.pop("WORLD_SIZE", None)
    err = open(tmp_path / "err.log", "w+")
    proc = subprocess.Popen([sys.executable, "-m", "nerf_mae_torch.bench", "--device", "cpu"],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=err, text=True)
    try:
        deadline = time.monotonic() + 120
        while "# timing" not in (tmp_path / "err.log").read_text():
            assert proc.poll() is None and time.monotonic() < deadline, \
                (tmp_path / "err.log").read_text()[-2000:]
            time.sleep(0.1)
        time.sleep(1.0)  # some timed steps
        proc.send_signal(signal.SIGTERM)
        stdout, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        err.close()
    lines = _lines(stdout)
    assert len(lines) == 1, stdout
    assert lines[0]["phase"] in ("warmup_batch1", "timed_batch1")
    assert proc.returncode == (0 if lines[0]["value"] > 0 else 1)


def test_a_failure_is_not_hidden_behind_a_smaller_batch(small, monkeypatch, capsys):
    monkeypatch.setenv("NERF_MAE_BENCH_PER_CHIP_BATCH", "8")

    def broken(self, state, batch, token_mask=None):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(MAETrainer, "train_step", broken)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        bench.main(["--device", "cpu"])
    captured = capsys.readouterr()
    lines = _lines(captured.out)
    assert len(lines) == 1
    assert lines[0]["value"] == 0 and lines[0]["phase"] == "error_warmup_batch8"
    assert "batch=4" not in captured.err


def test_out_of_memory_moves_to_the_next_probe(small, monkeypatch, capsys):
    monkeypatch.setenv("NERF_MAE_BENCH_PER_CHIP_BATCH", "8")
    real = MAETrainer.train_step

    def step(self, state, batch, token_mask=None):
        if batch["grids"].shape[0] == 8:
            raise torch.OutOfMemoryError("CUDA out of memory (simulated)")
        return real(self, state, batch, token_mask)

    monkeypatch.setattr(MAETrainer, "train_step", step)
    out = bench.main(["--device", "cpu"])
    captured = capsys.readouterr()
    assert out["phase"] == "done" and out["value"] > 0
    assert "# batch=8 out of memory" in captured.err
    assert "# batch=4 step=" in captured.err
    assert _lines(captured.out) == [out]


def test_cuda_without_a_card_raises(small, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
    lines = _lines(capsys.readouterr().out)
    assert len(lines) == 1 and lines[0]["phase"] == "error_start" and lines[0]["value"] == 0
