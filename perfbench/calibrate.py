"""The readings that a cell's correctness limits are set from, at the
cell's own size, in one process:

    python3 perfbench/calibrate.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds ...] [--fault-seeds ...] [--out file.jsonl]

For each seed: the system's first steps as a run's set-up drives them,
against the float32 reference (the lower reading comes from these); with
--control-seeds, the reference computed in fp8 (e4m3, a scale per tensor)
against the float32 reference (the control: it has to come out
incorrect); with --fault-seeds, the reference on half of each batch, the
mean over the rest (a fault planted in the reference put in the system's
place). A step that leaves the state unchanged reads 1 on change_gap by
its definition and needs no run. One JSON line per reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import harness, spec  # noqa: E402
from perfbench.reference.swin import Numerics  # noqa: E402
from perfbench.training import readings  # noqa: E402


def details(side, ref) -> dict:
    """Beside the readings: each step's loss gap, the worst leaves of the
    gradient and change gaps, and the median leaf's gaps."""
    import statistics
    g_med = statistics.median(ref.grad_norms.values())
    g = {k: abs(side.grad_norms[k] - v) / max(v, g_med) for k, v in ref.grad_norms.items()}
    moving = [k for k, v in ref.grad_norms.items() if v >= 1e-3 * g_med]
    c_med = statistics.median(ref.change_norms[k] for k in moving)
    c = {k: abs(side.change_norms[k] - ref.change_norms[k]) / max(ref.change_norms[k], c_med)
         for k in moving}
    worst = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:3]
    return {"loss_steps": [abs(a - b) / abs(b) for a, b in zip(side.losses, ref.losses)],
            "term_steps": [{k: abs(a[k] - b[k]) / abs(b[k]) for k in b}
                           for a, b in zip(side.terms, ref.terms)],
            "grad_worst": [(k, v, ref.grad_norms[k] / g_med) for k, v in worst(g)],
            "grad_median": statistics.median(g.values()),
            "grad_moving_worst": worst({k: g[k] for k in moving})[:1],
            "change_worst": [(k, v) for k, v in worst(c)],
            "change_median": statistics.median(c.values()),
            "left_out": len(ref.grad_norms) - len(moving)}


def calibrate(cell, seeds, control_seeds, fault_seeds, device, out, root=spec.ROOT):
    for seed in sorted(set(seeds) | set(control_seeds) | set(fault_seeds)):
        with tempfile.TemporaryDirectory(prefix="perfbench-calibrate-") as scratch:
            one_seed(cell, seed, seed in seeds, seed in control_seeds, seed in fault_seeds,
                     device, scratch, out, root)


def one_seed(cell, seed, program, control, fault, device, scratch, out, root):
    import torch
    t0 = time.time()
    task = spec.task(cell.workload["task"], root).build(
        harness.Run(cell, seed, device, scratch))
    task.close()
    ref = task.reference_records(Numerics("float32"))
    rows = {"seed": seed, "batch_gap": task.batch_gap()}
    sides = {}
    if program:
        sides["program"] = task.program
    if control:
        sides["control_fp8"] = task.reference_records(Numerics("fp8"))
    if fault:
        sides["fault_half_batch"] = task.reference_records(Numerics("float32"),
                                                           slice(0, task.batch // 2))
    for name, side in sides.items():
        rows[name] = readings(side, ref)
        rows[name + "_details"] = details(side, ref)
    rows["seconds"] = time.time() - t0
    print(json.dumps(rows), file=out, flush=True)
    del task
    if device.type == "cuda":
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    harness.cache_env(spec.ROOT)
    import torch
    cell = spec.cell(args.workload)
    harness.require_cards(torch, cell.chips)
    device = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else sys.stdout
    try:
        calibrate(cell, args.seeds, args.control_seeds, args.fault_seeds, device, out)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
