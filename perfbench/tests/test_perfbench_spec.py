"""The harness finds every part of the benchmark by name from its files,
and takes a cell, configuration, traffic mix and per-layer metric added as
files and BENCHMARK.json entries alone."""

import hashlib
import json
import shutil

from perfbench import spec
from perfbench.tests import tiny

DATA_DIRS = ("configs", "workloads", "traffic", "tasks", "layer_metrics")


def test_every_name_resolves():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        c = spec.cell(w["name"])
        assert callable(spec.task(c.workload["task"]).build)
        assert set(c.workload["limits"]) <= {"batch_gap", "loss_rel", "term_rel", "grad_gap",
                                             "change_gap"}
    for m in bench["per_layer"]:
        assert callable(spec.layer_metric(m["name"]).read)
    for c in bench["configs"]:
        assert (spec.ROOT / c["file"]).is_file()


def _digest(root):
    h = hashlib.sha256()
    for p in sorted((root / "perfbench").rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts:
            h.update(str(p.relative_to(root)).encode() + p.read_bytes())
    return h.hexdigest()


def test_added_cell_by_files_alone(tmp_path):
    before = _digest(spec.ROOT)
    root = tmp_path
    (root / "perfbench").mkdir()
    for d in DATA_DIRS:
        shutil.copytree(spec.ROOT / "perfbench" / d, root / "perfbench" / d)
    bench = spec.benchmark()
    mae = next(c for c in bench["configs"] if c["name"] == "mae_swin_b_160")
    # the new files
    cfg = json.loads((spec.ROOT / mae["file"]).read_text())
    cfg.update(tiny.TRUNK, compute_dtype="float32")
    (root / "perfbench/configs/tiny_mae.json").write_text(json.dumps(cfg))
    traffic = json.loads((spec.ROOT / "perfbench/traffic/resident_blobs.json").read_text())
    traffic.update(batch=2, scenes=6, extent=[24, 32], shuffle=False)
    (root / "perfbench/traffic/tiny_ordered.json").write_text(json.dumps(traffic))
    wl = json.loads((spec.ROOT / "perfbench/workloads/mae_b160_resident.json").read_text())
    wl.update(reference_rows=1, profile={"skip_steps": 1, "steps": 2})
    (root / "perfbench/workloads/tiny_cell.json").write_text(json.dumps(wl))
    (root / "perfbench/layer_metrics/profiled_steps.py").write_text(
        "def read(ctx):\n    return float(ctx['trace'].steps)\n")
    # the new entries
    bench["configs"].append({"name": "tiny_mae", "source": "https://arxiv.org/abs/2404.01300",
                             "file": "perfbench/configs/tiny_mae.json", "reduced": [],
                             "why": "a tiny MAE"})
    bench["workloads"].append({"name": "tiny_cell", "config": "tiny_mae",
                               "traffic": "tiny_ordered", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "profiled_steps", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "entry / train step",
                               "moves": "grids_per_s", "workloads": ["tiny_cell"]})
    for m in bench["end_to_end"]:
        if m["name"] == "grids_per_s":
            m["workloads"].append("tiny_cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    c = spec.cell("tiny_cell", root)
    assert [m["name"] for m in c.per_layer] == ["profiled_steps"]
    plain = tiny.run(c, root=root)
    assert plain["correct"] and set(plain["metrics"]) == {"grids_per_s", "setup_s"}
    traced = tiny.run(c, traced=True, root=root)
    assert traced["metrics"]["profiled_steps"]["value"] == 2.0
    assert _digest(spec.ROOT) == before
