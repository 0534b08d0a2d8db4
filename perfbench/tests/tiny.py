"""Tiny sizes of the benchmark's cells for the CPU tests: the cells' own
files, shrunk (a 32^3 grid, a 12-wide trunk, batch 2), the system in
float32 unless asked otherwise."""

from __future__ import annotations

import torch

from perfbench import harness, spec

TRUNK = {"resolution": 32, "embed_dim": 12, "depths": [1, 1, 2, 1], "num_heads": [3, 6, 12, 24]}


# cells whose files are in the benchmark but not yet in BENCHMARK.json
# (PERF.md, Open questions): their configuration and traffic
UNLISTED = {"fcos_s160_obb": ("fcos_swin_s_160_obb", "resident_obb_boxes"),
            "mae_b160_disk": ("mae_swin_b_160", "disk_blobs_aug")}


def cell(name: str, compute_dtype: str = "float32", root=spec.ROOT) -> spec.Cell:
    if name in UNLISTED:
        config, traffic = UNLISTED[name]
        load = lambda kind, n: spec.load_json(root / "perfbench" / kind / f"{n}.json")
        c = spec.Cell(name, 1, load("configs", config), load("traffic", traffic),
                      load("workloads", name), [], [])
    else:
        c = spec.cell(name, root)
    c.config.update(TRUNK, compute_dtype=compute_dtype)
    if "fpn_channels" in c.config:
        c.config["fpn_channels"] = 32
        c.traffic.update(half_extent=[2, 5], boxes=[2, 5])
    c.traffic.update(batch=2, scenes=6, extent=[24, 32])
    if "workers" in c.traffic:
        c.traffic["workers"] = 2
    c.workload.update(reference_rows=1, profile={"skip_steps": 1, "steps": 2})
    return c


def run(c: spec.Cell, seed: int = 5, traced: bool = False, root=spec.ROOT) -> dict:
    return harness.run_cell(c, seed, 0.5, traced, torch.device("cpu"), root)
