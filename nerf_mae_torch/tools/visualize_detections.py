"""Predicted / ground-truth boxes as camera-view overlay PNGs (the port's
counterpart of scripts/visualize_detections.py; reference:
nerf_rpn/scripts/visualize_rpn_input.py:371-539, headless).

Reads the per-scene npz files of `run_fcos --mode eval --output_proposals`
(boxes, scores, gt_boxes, grid), or any npz with a `grid` (W, L, H, 4) and
`boxes` [N, 6|7] in voxel coordinates, and writes
<out>/<scene>_view{0..3}.png: the scene splatted from the four corner orbit
cameras, ground truth in green, predictions in red with their scores.
Needs matplotlib.

  python -m nerf_mae_torch.tools.visualize_detections --proposals dir --out png_dir
"""

from __future__ import annotations

import argparse
import glob
import logging
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--proposals", required=True,
                   help="npz file or directory of scene_*.npz from "
                        "run_fcos --output_proposals")
    p.add_argument("--out", required=True, help="output directory for PNGs")
    p.add_argument("--score_thresh", default=0.5, type=float)
    p.add_argument("--max_boxes", default=50, type=int)
    p.add_argument("--alpha_thresh", default=0.01, type=float)
    p.add_argument("--grid", default=None,
                   help="optional separate scene npz with rgbsigma when the "
                        "proposals file has no embedded grid")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    log = logging.getLogger("visualize_detections")

    from nerf_mae_torch.viz import render_detection_views

    files = (sorted(glob.glob(os.path.join(args.proposals, "*.npz")))
             if os.path.isdir(args.proposals) else [args.proposals])
    os.makedirs(args.out, exist_ok=True)
    for path in files:
        data = np.load(path)
        if "grid" in data:
            grid = data["grid"]
        elif args.grid:
            g = np.load(args.grid)
            grid = g["rgbsigma"] if "rgbsigma" in g else g[g.files[0]]
        else:
            log.warning("%s: no grid embedded and no --grid given; skipping", path)
            continue
        if grid.shape[0] == 4:  # channel-first input
            grid = np.moveaxis(grid, 0, -1)
        name = os.path.splitext(os.path.basename(path))[0]
        paths = render_detection_views(
            grid, pred_boxes=data["boxes"], pred_scores=data.get("scores"),
            gt_boxes=data.get("gt_boxes"), out_prefix=os.path.join(args.out, name),
            score_thresh=args.score_thresh, max_boxes=args.max_boxes)
        log.info("%s: %d boxes -> %s", name, len(data["boxes"]),
                 ", ".join(os.path.basename(q) for q in paths))


if __name__ == "__main__":
    main()
