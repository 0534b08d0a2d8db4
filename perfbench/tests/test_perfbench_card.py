"""On the card only (marker `cuda`; run there with
`python -m pytest -m cuda perfbench/tests`): one short run of each cell
through the benchmark's command, its last line as the
contract fixes it and correct."""

import json
import subprocess
import sys

import pytest

from perfbench import spec


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the H100 and does not fall back")


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in spec.benchmark()["workloads"]])
def test_cell_runs_on_the_card(card, name):
    cmd = [sys.executable, "perfbench/run.py", "--workload", name, "--seed", "2147483653",
           "--seconds", "3", "--trace", "0"]
    out = subprocess.run(cmd, cwd=spec.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
