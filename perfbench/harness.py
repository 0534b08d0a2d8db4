"""One run of one cell: set-up, a closed-loop window of back-to-back
steps, the per-layer readings of a traced run, the correctness check
against the plain reference, and the result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device (and with --trace 1, breakdown), then "checks":
each number compared with its limit. The same numbers end standard error.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from perfbench import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "nerf_mae_tpu")


def process_start() -> float:
    """The process's start on time.time()'s clock, from /proc (10 ms
    resolution), or now where /proc is missing."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


STARTED = process_start()


def cache_env(root: Path) -> None:
    """Every build and kernel cache of the run inside the checkout, at
    fixed paths (the kernels' own build/kernels/<hash> already is)."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> List[str]:
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(FORBIDDEN))


@dataclasses.dataclass
class Run:
    cell: spec.Cell
    seed: int
    device: object
    scratch: str  # a directory the run may write, removed after it


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", default=0, type=int, choices=(0, 1))
    return p.parse_args(argv)


def fail(msg: str, code: int = 2) -> None:
    print(f"perfbench: {msg}", file=sys.stderr)
    raise SystemExit(code)


def require_cards(torch, chips: int) -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark measures the card and does not fall back")
    if torch.cuda.device_count() < chips:
        fail(f"the cell needs {chips} cards, {torch.cuda.device_count()} found")


def quantile(values: List[float], q: float) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(values), q * 100.0))


class Clock:
    """Step-end marks and memory on the run's device: CUDA events recorded
    on the stream (read after the window's closing synchronisation), or on
    the CPU, where only the tests drive a run, the host clock."""

    def __init__(self, torch, device):
        self.torch, self.cuda = torch, device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def reset_peak(self) -> None:
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats()

    def peak(self) -> int:
        return self.torch.cuda.max_memory_allocated() if self.cuda else 0

    def activities(self):
        from torch.profiler import ProfilerActivity
        return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])


def launch_counters() -> Dict[str, int]:
    """The fused-block kernels' launch counters of the system under test."""
    from nerf_mae_torch.ops import fused_block
    return {"fused_block_fwd": fused_block.fused_swin_block.launches,
            "fused_block_bwd": fused_block.fused_swin_block_bwd.launches}


class Window:
    """The closed loop: steps back to back for `seconds` of the host clock,
    a mark at every step's end; the window closes on a device
    synchronisation after the last step. With `profile` ({"skip_steps",
    "steps"}) torch.profiler covers that stretch of steps, which starts and
    ends synchronised; the window lasts at least until it has ended."""

    def __init__(self, clock: Clock, task, seconds: float, profile: Optional[dict]):
        self.clock, self.task, self.seconds, self.profile = clock, task, seconds, profile
        self.prof = None
        self.launches: Dict[str, int] = {}
        self.profiled_steps = 0

    def run(self) -> dict:
        from torch.profiler import profile, record_function
        from perfbench.trace import STEP
        clock, prof_cfg = self.clock, self.profile
        clock.sync()
        clock.reset_peak()
        marks = [clock.mark()]
        t0 = time.perf_counter()
        steps = 0
        while True:
            if prof_cfg and steps == prof_cfg["skip_steps"]:
                clock.sync()
                before = launch_counters()
                self.prof = profile(activities=clock.activities())
                self.prof.__enter__()
            with record_function(STEP):
                self.task.step()
            marks.append(clock.mark())
            steps += 1
            if prof_cfg and steps == prof_cfg["skip_steps"] + prof_cfg["steps"]:
                clock.sync()
                self.prof.__exit__(None, None, None)
                after = launch_counters()
                self.launches = {k: after[k] - before[k] for k in after}
                self.profiled_steps = prof_cfg["steps"]
            if time.perf_counter() - t0 >= self.seconds and (
                    not prof_cfg or self.profiled_steps):
                break
        clock.sync()
        wall = time.perf_counter() - t0
        return {"steps": steps, "wall_s": wall,
                "step_ms": [clock.ms(a, b) for a, b in zip(marks, marks[1:])],
                "peak_bytes": clock.peak()}


def end_to_end(cell: spec.Cell, window: dict, task, setup_s: float) -> Dict[str, float]:
    grids_per_s = window["steps"] * task.grids_per_step / window["wall_s"]
    values = {"setup_s": setup_s, "grids_per_s": grids_per_s,
              "grids_per_s_from_disk": grids_per_s,
              "step_ms_p90": quantile(window["step_ms"], 0.9)}
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}


def per_layer(cell: spec.Cell, ctx: dict, root: Path = spec.ROOT) -> Dict[str, dict]:
    out = {}
    for m in cell.per_layer:
        value = spec.layer_metric(m["name"], root).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def verdict(readings: Dict[str, float], limits: Dict[str, float]):
    """(correct, checks): every number that has a limit at or under it."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in readings.items() if k in limits}
    missing = [k for k in limits if k not in readings]
    correct = not missing and all(c["value"] <= c["limit"] for c in checks.values())
    return correct, checks


def main(argv=None) -> int:
    args = parse(argv)
    cache_env(spec.ROOT)
    import torch
    cell = spec.cell(args.workload)
    require_cards(torch, cell.chips)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace), device)
    print(json.dumps(line))
    return 0


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, device,
             root: Path = spec.ROOT) -> dict:
    """Everything of a run after the look for cards: returns the result
    line (the tests drive it on the CPU)."""
    import shutil
    import torch
    scratch = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"perfbench-{os.getpid()}")
    os.makedirs(scratch, exist_ok=True)
    try:
        return _run(cell, seed, seconds, traced, device, scratch, torch, root)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


def _run(cell, seed, seconds, traced, device, scratch, torch, root) -> dict:
    clock = Clock(torch, device)
    if traced:  # the profiler's first start is slow: pay it in set-up
        from torch.profiler import profile
        with profile(activities=clock.activities()):
            torch.zeros(1, device=device).add_(1)
            clock.sync()
    task = spec.task(cell.workload["task"], root).build(Run(cell, seed, device, scratch))
    clock.sync()
    setup_peak = clock.peak()
    setup_s = time.time() - STARTED
    window = Window(clock, task, seconds, cell.workload["profile"] if traced else None)
    w = window.run()
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    result = {"device": {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
                         "count": cell.chips, "memory_peak_bytes": max(setup_peak, w["peak_bytes"])}}
    if traced:
        from perfbench import trace
        summary = trace.summarize(window.prof, window.profiled_steps)
        ctx = {"cell": cell, "task": task, "window": w, "trace": summary,
               "launches": window.launches, "device": device}
        metrics = per_layer(cell, ctx, root)
        result["device"].update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = {"device_ops": [list(x) for x in summary.device_ops[:10]],
                               "idle_gaps": [list(x) for x in summary.idle_gaps[:10]]}
    else:
        metrics = end_to_end(cell, w, task, setup_s)

    task.close()
    readings = task.check()
    limits = cell.workload["limits"]
    correct, checks = verdict(readings, limits)
    for k, v in readings.items():
        print(f"check {k} {v!r} " + (f"limit {limits[k]!r}" if k in limits else "not compared"),
              file=sys.stderr)
    print(f"correct {correct}", file=sys.stderr)
    found = forbidden_modules()
    if found:
        fail(f"the run loaded {', '.join(found)}: the benchmark runs without JAX")
    return {"correct": correct, "attempted": w["steps"] + cell.workload["check_steps"],
            "failed": 0 if correct else cell.workload["check_steps"],
            "metrics": metrics, **result, "checks": checks}
