"""Detection proposals -> instant-ngp bounding-box json (the port's
counterpart of scripts/proposals2ngp.py; reference:
nerf_rpn/scripts/proposals2ngp.py).

  python -m nerf_mae_torch.tools.proposals2ngp --proposals_npz p.npz \
      --features_npz scene.npz --output boxes.json [--top_n N] [--score_thresh s]
"""

from __future__ import annotations

import argparse

import numpy as np

from nerf_mae_torch.viz import save_ngp_boxes


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--proposals_npz", required=True,
                   help="npz with per-scene 'proposals' [N, 6] (+ 'scores')")
    p.add_argument("--features_npz", required=True,
                   help="scene npz with resolution/bbox/scale/offset metadata")
    p.add_argument("--output", required=True)
    p.add_argument("--top_n", default=None, type=int)
    p.add_argument("--score_thresh", default=None, type=float)
    args = p.parse_args(argv)

    with np.load(args.proposals_npz) as f:
        proposals = f["proposals"]
        scores = f["scores"] if "scores" in f.files else None
    if scores is not None:
        order = np.argsort(-scores)
        proposals, scores = proposals[order], scores[order]
        if args.score_thresh is not None:
            proposals = proposals[scores >= args.score_thresh]
    if args.top_n:
        proposals = proposals[: args.top_n]

    with np.load(args.features_npz) as f:
        meta = {k: f[k] for k in f.files if k != "rgbsigma"}
    save_ngp_boxes(args.output, proposals, meta)
    print(f"wrote {len(proposals)} boxes to {args.output}")


if __name__ == "__main__":
    main()
