"""Headless camera / box visualiser for instant-ngp scenes (the port's
counterpart of scripts/visualize_cameras.py; reference:
data/visualize_cameras/visualize_nerf_{front3d,hm3d,hypersim,scannet,arkit}.py).

Reads each split's transforms.json and writes one ASCII PLY line set with
`edge` elements: per-camera view frusta (the reference's 5-vertex / 8-edge
topology, get_camera_frustum at visualize_nerf_front3d.py:115-139), the
room_bbox and the world OBBs, plus, optionally, the occupied voxels of a
feature grid as points in the same frame. Colours: train frusta green,
val / test red, room_bbox blue (the reference paints it red; blue keeps it
apart from the val / test frusta), OBBs yellow.

  python -m nerf_mae_torch.tools.visualize_cameras --scene <dir> --out cams.ply \
      [--splits train val] [--subsample 8] [--frustum_length 0.1] \
      [--grid features.npz] [--forward -1]

A scene without <split>/transforms.json falls back to the root
transforms.json, which is then drawn once, however many splits fall back.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from nerf_mae_torch.viz import (
    _BOX_EDGES,
    box_lineset,
    camera_frustum_lineset,
    grid_to_pointcloud,
    merge_linesets,
    save_lineset_ply,
)

SPLIT_COLORS = {"train": (0.0, 1.0, 0.0), "val": (1.0, 0.0, 0.0), "test": (1.0, 0.0, 0.0)}
# scripts/preprocess_boxes.py's axis permutation of the ngp-frame metadata
PERM = np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0]], np.float64)


def obb_corner_lineset(obbs, color=(1.0, 0.8, 0.0)):
    """bounding_boxes entries ({extents, orientation 3x3, position}) -> one
    wireframe line set (general rotations, the save_transforms.py schema)."""
    linesets = []
    signs = np.array([[sx, sy, sz] for sz in (-0.5, 0.5) for sy in (-0.5, 0.5)
                      for sx in (-0.5, 0.5)], np.float64)  # viz.box_corners_3d's order
    edges = np.asarray(_BOX_EDGES, np.int64)
    for b in obbs:
        ext = np.asarray(b["extents"], np.float64)
        ori = np.asarray(b["orientation"], np.float64)
        pos = np.asarray(b["position"], np.float64)
        corners = (signs * ext) @ ori.T + pos
        colors = np.tile(np.asarray(color, np.float64)[None], (12, 1))
        linesets.append((corners.astype(np.float32), edges, colors))
    return merge_linesets(linesets)


def scene_linesets(tdict, split_color, subsample=1, frustum_length=0.1, forward=-1.0,
                   draw_boxes=True):
    """One split's transforms dict -> list of (points, lines, colors)."""
    w = float(tdict.get("w", 640.0))
    h = float(tdict.get("h", 480.0))
    if "camera_angle_x" in tdict:
        cax = float(tdict["camera_angle_x"])
    else:  # hypersim / scannet style: focal only
        cax = 2.0 * np.arctan(w / (2.0 * float(tdict["fl_x"])))
    out = []
    for fr in tdict.get("frames", [])[::max(1, subsample)]:
        c2w = np.asarray(fr["transform_matrix"], np.float64)
        out.append(camera_frustum_lineset(c2w, cax, aspect=h / w, length=frustum_length,
                                          color=split_color, forward=forward))
    if draw_boxes:
        if "room_bbox" in tdict:
            lo, hi = tdict["room_bbox"]
            box = np.concatenate([np.asarray(lo, np.float32), np.asarray(hi, np.float32)])
            out.append(box_lineset(box[None], color=(0.2, 0.4, 1.0)))
        if tdict.get("bounding_boxes"):
            out.append(obb_corner_lineset(tdict["bounding_boxes"]))
    return out


def voxel_to_world(vox: np.ndarray, meta) -> np.ndarray:
    """Continuous voxel coordinates [N, 3] of a feature grid -> points in
    its transforms.json frame: the inverse of scripts/preprocess_boxes.py's
    world -> voxel mapping. With bbox_min / bbox_max the grid spans them in
    ngp units under PERM (run_nerf --ngp_frame, the reference's Front3D /
    HM3D grids); without them it spans the [0, 1]^3 ngp cube. Then
    world = (ngp - offset) / scale where the npz holds scale and offset."""
    vox = np.asarray(vox, np.float64)
    res = np.asarray(meta["resolution"], np.float64).reshape(-1)
    res = np.full(3, res[0]) if res.size == 1 else res
    if "bbox_min" in meta and "bbox_max" in meta:
        lo = PERM @ np.asarray(meta["bbox_min"], np.float64)
        hi = PERM @ np.asarray(meta["bbox_max"], np.float64)
        q = lo + vox / res * (hi - lo)
        pts = PERM.T @ q.T if bool(meta.get("from_mitsuba", False)) else q.T
        pts = pts.T
    else:
        pts = vox / res
    if "scale" in meta and "offset" in meta:
        pts = (pts - np.asarray(meta["offset"], np.float64)) / float(meta["scale"])
    return pts


def grid_points(npz_path: str, alpha_thresh: float = 0.01) -> np.ndarray:
    """The occupied voxels' centres of a feature grid npz, in the frame of
    its transforms.json, float32 [N, 3]."""
    with np.load(npz_path) as f:
        meta = {k: f[k] for k in f.files}
    rgbsigma = meta.pop("rgbsigma")
    meta.setdefault("resolution", np.asarray(rgbsigma.shape[:3]))
    pc = grid_to_pointcloud(np.asarray(rgbsigma), alpha_thresh)
    if not len(pc["points"]):
        return np.zeros((0, 3), np.float32)
    return voxel_to_world(pc["points"] + 0.5, meta).astype(np.float32)


def main(argv=None):
    """Writes --out; returns {"points", "lines", "colors", "n_frusta"}."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scene", required=True, help="scene dir holding <split>/transforms.json")
    ap.add_argument("--out", required=True, help="output .ply path")
    ap.add_argument("--splits", nargs="+", default=["train"])
    ap.add_argument("--subsample", type=int, default=1,
                    help="keep every Nth frame (reference mains use ::8)")
    ap.add_argument("--frustum_length", type=float, default=0.1)
    ap.add_argument("--forward", type=float, default=-1.0,
                    help="camera-frame z-sign of the view direction: -1 for nerf/OpenGL "
                         "poses, +1 for the reference's raw +z frusta")
    ap.add_argument("--grid", default=None,
                    help="optional features .npz (rgbsigma + resolution / bbox / scale / "
                         "offset metadata) to add occupied voxels as points")
    ap.add_argument("--alpha_thresh", type=float, default=0.01)
    ap.add_argument("--no_boxes", action="store_true")
    args = ap.parse_args(argv)

    linesets, n_frusta, loaded = [], 0, set()
    for split in args.splits:
        tpath = os.path.join(args.scene, split, "transforms.json")
        if not os.path.isfile(tpath):  # flat scene dirs: transforms at root
            tpath = os.path.join(args.scene, "transforms.json")
        if tpath in loaded:
            print(f"{split}: no {split}/transforms.json; {tpath} is already drawn")
            continue
        with open(tpath) as f:
            tdict = json.load(f)
        ls = scene_linesets(tdict, SPLIT_COLORS.get(split, (0.0, 1.0, 0.0)),
                            subsample=args.subsample, frustum_length=args.frustum_length,
                            forward=args.forward,
                            draw_boxes=not loaded and not args.no_boxes)
        loaded.add(tpath)
        n_frusta += sum(1 for p, _, _ in ls if len(p) == 5)
        linesets.extend(ls)

    points, lines, colors = merge_linesets(linesets)
    if args.grid:
        points = np.concatenate([points, grid_points(args.grid, args.alpha_thresh)])

    save_lineset_ply(args.out, points, lines, colors)
    print(f"wrote {args.out}: {len(points)} vertices, {len(lines)} edges, {n_frusta} frusta")
    return {"points": points, "lines": lines, "colors": colors, "n_frusta": n_frusta}


if __name__ == "__main__":
    main()
