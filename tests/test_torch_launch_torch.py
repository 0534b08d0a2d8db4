"""The `_torch` twins of the JAX training recipes
(launch/train_{mae3d,fcos_pretrained,rpn,voxelSR,voxel_semantics}.sh), on
the CPU: each is run by bash with `python` on PATH replaced by a stub that
records its arguments, as is its JAX recipe. The twin runs
`python -m nerf_mae_torch.<driver>` with the recipe's flags, in its order,
plus `--device cuda` (DEVICE overrides it) and the arguments given to the
script; the port driver's own parse_args takes the command line and reads
the recipe's values."""

import os
import shlex
import subprocess

import pytest

from nerf_mae_torch import (run_fcos, run_mae_pretrain, run_rpn, run_voxel_semantics,
                            run_voxel_sr)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = {
    "train_mae3d": run_mae_pretrain,
    "train_fcos_pretrained": run_fcos,
    "train_rpn": run_rpn,
    "train_voxelSR": run_voxel_sr,
    "train_voxel_semantics": run_voxel_semantics,
}


def recorded_argv(script, tmp_path, env=(), args=()):
    """The arguments `python` receives when bash runs `script`."""
    stub = tmp_path / "bin"
    stub.mkdir(exist_ok=True)
    (stub / "python").write_text('#!/bin/sh\nprintf "%s\\n" "$@" > "$ARGV_OUT"\n')
    (stub / "python").chmod(0o755)
    out = tmp_path / "argv.txt"
    environ = {**os.environ, "PATH": f"{stub}{os.pathsep}{os.environ['PATH']}",
               "ARGV_OUT": str(out), **dict(env)}
    res = subprocess.run(["bash", os.path.join(ROOT, "launch", script), *args], cwd=ROOT,
                         env=environ, capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    return out.read_text().splitlines()


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_the_twin_runs_the_recipes_flags_through_the_port_driver(recipe, tmp_path):
    driver = RECIPES[recipe]
    jax_argv = recorded_argv(f"{recipe}.sh", tmp_path)
    assert jax_argv[0] == f"scripts/{driver.__name__.split('.')[-1]}.py"
    argv = recorded_argv(f"{recipe}_torch.sh", tmp_path, args=["--steps", "7"])
    assert argv[:2] == ["-m", driver.__name__]
    assert argv[2:4] == ["--device", "cuda"]
    assert argv[4:] == jax_argv[1:] + ["--steps", "7"]
    args = driver.parse_args(argv[2:])
    assert args.device == "cuda" and args.steps == 7 and args.mode == "train"
    flags = dict(zip(jax_argv[1:], jax_argv[2:]))
    for flag in ("--backbone_type", "--batch_size", "--lr", "--features_path"):
        value = getattr(args, flag[2:])
        assert str(value) == flags[flag] or value == type(value)(flags[flag]), flag
    cpu = recorded_argv(f"{recipe}_torch.sh", tmp_path, env={"DEVICE": "cpu",
                                                              "DATA_ROOT": "d r"})
    assert driver.parse_args(cpu[2:]).device == "cpu"
    assert any(a.startswith("d r/") for a in cpu), shlex.join(cpu)
