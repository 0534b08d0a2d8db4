"""Finding a benchmark's parts by name.

Everything that belongs to one cell, configuration, traffic mix, task or
per-layer metric sits in a file of its own, named after it:

    BENCHMARK.json                        cells, configurations, metrics
    perfbench/workloads/<cell>.json       the cell's task and correctness limits
    perfbench/configs/<config>.json       sizes, source, reductions, assumptions
    perfbench/traffic/<mix>.json          the traffic generator's parameters
    perfbench/tasks/<task>.py             how a task builds and steps the system
    perfbench/layer_metrics/<metric>.py   the reader of one per-layer metric

so a later change adds a cell, a configuration, a mix or a metric by adding
files and BENCHMARK.json entries, and edits none that exist.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json with everything it names, loaded."""

    name: str
    chips: int
    config: dict        # configs/<config>.json
    traffic: dict       # traffic/<mix>.json
    workload: dict      # workloads/<cell>.json
    end_to_end: List[dict]
    per_layer: List[dict]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _named(kind: str, name: str, root: Path, suffix: str) -> Path:
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a benchmark name")
    path = root / "perfbench" / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    return path


def reports(metric: dict, cell: str) -> bool:
    """Whether `metric` is reported in `cell`: its `workloads` list, or
    every cell when it has none."""
    return cell in metric.get("workloads", [cell])


def cell(name: str, root: Path = ROOT, bench: Optional[dict] = None) -> Cell:
    bench = bench or benchmark(root)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    config = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(root / config["file"]),
        traffic=load_json(_named("traffic", w["traffic"], root, ".json")),
        workload=load_json(_named("workloads", name, root, ".json")),
        end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if reports(m, name)],
    )


def _module(kind: str, name: str, root: Path) -> ModuleType:
    path = _named(kind, name, root, ".py")
    spec = importlib.util.spec_from_file_location(f"perfbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def task(name: str, root: Path = ROOT) -> ModuleType:
    """tasks/<name>.py: a module with build(run) -> a task object."""
    return _module("tasks", name, root)


def layer_metric(name: str, root: Path = ROOT) -> ModuleType:
    """layer_metrics/<name>.py: a module with read(ctx) -> float or None."""
    return _module("layer_metrics", name, root)
