"""BENCHMARK.json and a run's result line keep to the benchmark's contract:
names, units and keys, bounds, what each cell reports, and a run that
finds no card, or no program beside the benchmark, prints no result."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from perfbench import spec
from perfbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|expansion|"
                   r"experts_per_token|embed|_dim$|_rank$|_channels$|mlp_ratio|num_heads)")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json():
    raw = (spec.ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    b = json.loads(raw)
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.match(p) for p in b["paths"])
    assert all(not p.startswith("/") and ".." not in p.split("/") for p in b["paths"])
    assert len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    for w in b["command"][1:]:
        if "/" in w or w.endswith(".py"):
            assert any(w == p or w.startswith(p + "/") for p in b["paths"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (b["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200

    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in b[k]}) == len(b[k])

    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in b["paths"])
        assert len(c["reduced"]) <= 16
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        for key in c["reduced"]:
            assert NAME.match(key) and key in cfg and not WIDTH.search(key)
    assert len({c["file"] for c in b["configs"]}) == len(b["configs"])

    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"]) and NAME.match(w["traffic"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(b["workloads"])
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(b["workloads"]) // 4)

    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"]) and m["moves"] in e2e
        for cell in m.get("workloads", [w["name"] for w in b["workloads"]]):
            assert spec.reports(e2e[m["moves"]], cell)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in b["workloads"]:
        reported = [m["name"] for m in b["end_to_end"] if spec.reports(m, w["name"])]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(spec.reports(m, w["name"]) for m in b["per_layer"])


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(traced):
    c = tiny.cell("mae_b160_resident")
    line = tiny.run(c, traced=traced)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if traced else []) + ["checks"]
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if traced:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
        assert set(line["metrics"]) <= {m["name"] for m in c.per_layer}
    else:
        assert set(line["metrics"]) == {m["name"] for m in c.end_to_end}
    for v in line["metrics"].values():
        assert set(v) == {"value", "unit"}
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(line)


def _run(cwd, env=None):
    cmd = [sys.executable, "perfbench/run.py", "--workload", "mae_b160_resident",
           "--seed", "2147483711", "--seconds", "1", "--trace", "0"]
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_fails():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(spec.ROOT, env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_bare_checkout_fails(tmp_path):
    """Beside BENCHMARK.json and perfbench/ alone there is no system to
    run: past the look for a card, the run stops before any result."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
    code = ("import json, torch; from perfbench.tests import tiny; "
            "print(json.dumps(tiny.run(tiny.cell('mae_b160_resident'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "nerf_mae_torch" in out.stderr
