"""Generate + filter ScanNet oriented-box annotations (L0 data production).

Two subcommands mirroring the reference pipeline stages:

  generate  — per scene: read `<scene>_vh_clean.aggregation.json` (instance ->
              segment ids), `<scene>_vh_clean_2.0.010000.segs.json` (vertex ->
              segment id), and `<scene>_vh_clean_2.ply` (vertex positions);
              fit each instance's min/max AABB corners and 7-DoF OBB
              (rotating-calipers min-area rectangle + z extent) and write
              `<scene>.json` (reference: data/scannet/generate_bbox.py:72-145).
  filter    — rescale the fitted OBBs into the rgbsigma grid's voxel
              coordinates using the scene npz `resolution` and drop
              excluded-label / too-small boxes; write `<scene>.npy` boxes +
              filtered json (reference: data/scannet/filter_bbox.py:26-87).

Pure-numpy host-side tooling — no open3d, no plyfile dependency (the
minimal PLY vertex reader below covers the ascii and binary_little_endian
files ScanNet ships). Run as `python -m nerf_mae_torch.tools.generate_scannet_obb`.
"""

from __future__ import annotations

import argparse
import json
import os
import struct

import numpy as np

from nerf_mae_torch.data.scannet_obb import filter_obbs, instance_obb

_PLY_DTYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply_vertices(path: str) -> np.ndarray:
    """Read the x/y/z vertex properties of a PLY file -> [N, 3] float32.

    Supports `format ascii` and `format binary_little_endian` with scalar
    vertex properties (ScanNet's `_vh_clean_2.ply` layout); other elements
    (faces) are skipped.
    """
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype_code)])
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unterminated PLY header")
            parts = line.decode("ascii", "replace").strip().split()
            if not parts or parts[0] == "comment":
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                elements.append((parts[1], int(parts[2]), []))
            elif parts[0] == "property":
                if parts[1] == "list":
                    elements[-1][2].append((parts[-1], ("list", parts[2], parts[3])))
                else:
                    elements[-1][2].append((parts[-1], _PLY_DTYPES[parts[1]]))
            elif parts[0] == "end_header":
                break
        if fmt not in ("ascii", "binary_little_endian"):
            raise ValueError(f"{path}: unsupported PLY format {fmt}")

        verts = None
        for name, count, props in elements:
            if name == "vertex":
                if any(isinstance(d, tuple) for _, d in props):
                    raise ValueError(f"{path}: list property in vertex element")
                dt = np.dtype([(p, "<" + d) for p, d in props])
                if fmt == "ascii":
                    rows = [f.readline().split()[: len(props)] for _ in range(count)]
                    arr = np.array([[float(v) for v in r] for r in rows])
                    verts = arr[:, [i for i, (p, _) in enumerate(props)
                                    if p in ("x", "y", "z")]]
                    order = [p for p, _ in props if p in ("x", "y", "z")]
                    verts = verts[:, [order.index(a) for a in "xyz"]]
                else:
                    raw = np.frombuffer(f.read(count * dt.itemsize), dtype=dt,
                                        count=count)
                    verts = np.stack([raw["x"], raw["y"], raw["z"]], axis=1)
                break
            # skip a non-vertex element that precedes vertex (unusual)
            if fmt == "ascii":
                for _ in range(count):
                    f.readline()
            else:
                for _ in range(count):
                    for _, d in props:
                        if isinstance(d, tuple):
                            n = struct.unpack(
                                "<" + {"u1": "B", "u2": "H", "u4": "I",
                                       "i1": "b", "i2": "h", "i4": "i"}[
                                           _PLY_DTYPES[d[1]]],
                                f.read(np.dtype(_PLY_DTYPES[d[1]]).itemsize))[0]
                            f.read(n * np.dtype(_PLY_DTYPES[d[2]]).itemsize)
                        else:
                            f.read(np.dtype(d).itemsize)
        if verts is None:
            raise ValueError(f"{path}: no vertex element")
        return np.asarray(verts, dtype=np.float32)


def process_scene(scene_path: str, output_path: str) -> dict:
    """Fit per-instance AABB + OBB for one ScanNet scene directory.

    Mirrors generate_bbox.py:114-145: instances come from the aggregation
    json's segGroups; each instance's vertices are the union of its segment
    ids in the `.segs.json` index; positions come from the clean_2 mesh.
    Instances whose segments resolve to zero vertices are recorded with a
    null obb instead of crashing (the reference would raise in np.min).
    """
    scene_name = os.path.basename(os.path.normpath(scene_path))
    with open(os.path.join(scene_path,
                           f"{scene_name}_vh_clean.aggregation.json")) as f:
        aggregation = json.load(f)
    with open(os.path.join(
            scene_path, f"{scene_name}_vh_clean_2.0.010000.segs.json")) as f:
        seg_indices = np.asarray(json.load(f)["segIndices"], dtype=np.int64)
    vertices = read_ply_vertices(
        os.path.join(scene_path, f"{scene_name}_vh_clean_2.ply"))

    instances = []
    for group in aggregation["segGroups"]:
        seg_set = np.asarray(group["segments"], dtype=np.int64)
        mask = np.isin(seg_indices, seg_set)
        inst = {"obj_id": group["objectId"], "label": group["label"]}
        pos = vertices[mask]
        if pos.shape[0] == 0:
            inst.update(min_pt=None, max_pt=None, obb=None)
        else:
            inst.update(
                min_pt=pos.min(axis=0).tolist(),
                max_pt=pos.max(axis=0).tolist(),
                obb=instance_obb(pos).tolist(),
            )
        instances.append(inst)

    json_dict = {"scene_name": scene_name, "instances": instances}
    if output_path:
        with open(os.path.join(output_path, f"{scene_name}.json"), "w") as f:
            json.dump(json_dict, f, indent=2)
    return json_dict


def filter_scene(feature_path: str, obj_json_path: str, npy_output_path: str,
                 json_output_path: str, min_size: float) -> None:
    """Filter one scene's OBB json against its rgbsigma npz (filter_bbox.py:26)."""
    data = np.load(feature_path)
    with open(obj_json_path) as f:
        json_dict = json.load(f)
    inst = [x for x in json_dict["instances"] if x.get("obb") is not None]
    if not inst:
        np.save(npy_output_path, np.zeros((0, 7)))
        json_dict["instances"] = []
    else:
        obbs = np.asarray([x["obb"] for x in inst])
        labels = [x["label"] for x in inst]
        min_pts = np.asarray([x["min_pt"] for x in inst])
        max_pts = np.asarray([x["max_pt"] for x in inst])
        filtered, keep = filter_obbs(obbs, labels, min_pts, max_pts,
                                     np.asarray(data["resolution"]),
                                     min_size=min_size)
        np.save(npy_output_path, filtered)
        json_dict["instances"] = [x for x, k in zip(inst, keep) if k]
    with open(json_output_path, "w") as f:
        json.dump(json_dict, f, indent=2)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="fit OBBs from scene meshes")
    g.add_argument("--scene_path", required=True,
                   help="directory of ScanNet scene directories")
    g.add_argument("--output_path", required=True)

    fl = sub.add_parser("filter", help="rescale to grid coords + filter")
    fl.add_argument("--feature_dir", required=True,
                    help="rgbsigma npz dir (provides `resolution`)")
    fl.add_argument("--obj_json_dir", required=True)
    fl.add_argument("--npy_output_dir", required=True)
    fl.add_argument("--json_output_dir", required=True)
    fl.add_argument("--min_size", type=float, default=8)

    args = ap.parse_args(argv)
    if args.cmd == "generate":
        os.makedirs(args.output_path, exist_ok=True)
        scenes = sorted(os.listdir(args.scene_path))
        for s in scenes:
            process_scene(os.path.join(args.scene_path, s), args.output_path)
            print(f"generated {s}")
    else:
        os.makedirs(args.npy_output_dir, exist_ok=True)
        os.makedirs(args.json_output_dir, exist_ok=True)
        for scene in sorted(os.listdir(args.feature_dir)):
            name = scene.split(".")[0]
            filter_scene(
                os.path.join(args.feature_dir, f"{name}.npz"),
                os.path.join(args.obj_json_dir, f"{name}.json"),
                os.path.join(args.npy_output_dir, f"{name}.npy"),
                os.path.join(args.json_output_dir, f"{name}.json"),
                args.min_size,
            )
            print(f"filtered {name}")


if __name__ == "__main__":
    main()
