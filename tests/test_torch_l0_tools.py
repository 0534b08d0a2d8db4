"""The port's L0 label and visualisation tools against the JAX package's and
the scripts' on the same inputs (numpy code on both sides, so equal, not
close): data/voxelize.py, data/scannet_obb.py, tools/generate_scannet_obb.py
(on a small binary PLY scene), the ten functions of viz.py from
ngp_matrix_to_nerf to save_lineset_ply, and tools/proposals2ngp.py,
tools/visualize_detections.py and tools/visualize_cameras.py.

visualize_cameras does not copy three faults of scripts/visualize_cameras.py
(ROADMAP, Queue 3), each held here: the grid's voxel -> world mapping uses
the npz's bbox and preprocess_boxes' axis permutation (:135), a root
transforms.json that several splits fall back to is drawn once (:114), and
a room_bbox given as arrays makes the right box (:82).
"""

import json
import os
import struct
import sys

import numpy as np
import pytest
from PIL import Image

from nerf_mae_torch import viz as tviz
from nerf_mae_torch.data import scannet_obb as tobb
from nerf_mae_torch.data import voxelize as tvox
from nerf_mae_torch.tools import generate_scannet_obb as tgen
from nerf_mae_torch.tools import proposals2ngp as tp2n
from nerf_mae_torch.tools import visualize_cameras as tcams
from nerf_mae_torch.tools import visualize_detections as tdets
from nerf_mae_tpu import viz as jviz
from nerf_mae_tpu.data import scannet_obb as jobb
from nerf_mae_tpu.data import voxelize as jvox

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scripts"))
import generate_scannet_obb as sgen  # noqa: E402
import preprocess_boxes as sprep  # noqa: E402
import proposals2ngp as sp2n  # noqa: E402
import visualize_cameras as scams  # noqa: E402
import visualize_detections as sdets  # noqa: E402


def equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            equal(g, w)
    elif want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert np.asarray(got).dtype == np.asarray(want).dtype


# ---------------------------------------------------------------- voxelize

@pytest.mark.parametrize("convention", ["opencv", "opengl"])
def test_depth_to_pointcloud_matches_jax(convention):
    rs = np.random.RandomState(0)
    depth = rs.rand(6, 8).astype(np.float32) * 5
    depth[0, :3] = 0.0
    K = np.array([[7.0, 0, 4.1], [0, 7.5, 2.9], [0, 0, 1]])
    c2w = np.eye(4)
    c2w[:3, :3] = np.linalg.qr(rs.randn(3, 3))[0]
    c2w[:3, 3] = rs.randn(3)
    labels = rs.randint(0, 4, (6, 8))
    for lab in (None, labels):
        equal(tvox.depth_to_pointcloud(depth, K, c2w, lab, 4.0, convention),
              jvox.depth_to_pointcloud(depth, K, c2w, lab, 4.0, convention))


def test_depth2pc_voxelize_and_boxes_match_jax():
    rs = np.random.RandomState(1)
    depths = [rs.rand(6, 8) * 3 + 0.5 for _ in range(3)]
    masks = [rs.randint(0, 3, (6, 8)) for _ in range(3)]
    c2ws = [np.eye(4) + np.pad(0.1 * rs.randn(3, 4), ((0, 1), (0, 0))) for _ in range(3)]
    K = np.array([[6.0, 0, 4], [0, 6, 3], [0, 0, 1]])
    want = jvox.depth2pc_scene(depths, masks, c2ws, K, points_per_obj=20, seed=3)
    equal(tvox.depth2pc_scene(depths, masks, c2ws, K, points_per_obj=20, seed=3), want)
    pts = rs.rand(400, 3) * 2 - 1
    labels = rs.randint(0, 5, 400)
    grid = tvox.voxelize_labels(pts, labels, [-1, -1, -1], [1, 1, 1], (6, 5, 4))
    equal(grid, jvox.voxelize_labels(pts, labels, [-1, -1, -1], [1, 1, 1], (6, 5, 4)))
    inst = np.zeros((8, 8, 8), np.int64)
    inst[1:4, 2:5, 0:3] = 2
    inst[5:8, 5:8, 5:8] = 7
    inst[0, 7, 7] = 3  # below min_voxels
    equal(tvox.boxes_from_instance_labels(inst), jvox.boxes_from_instance_labels(inst))


# ---------------------------------------------------------------- scannet OBBs

def test_scannet_obb_matches_jax():
    rs = np.random.RandomState(2)
    for pts in (rs.rand(40, 2), np.array([[0.0, 0], [1, 1], [2, 2]]), np.array([[1.0, 2.0]])):
        equal(tobb.convex_hull_2d(pts), jobb.convex_hull_2d(pts))
        equal(tobb.min_area_rect(pts), jobb.min_area_rect(pts))
    verts = rs.randn(60, 3) * [2.0, 1.0, 0.5]
    equal(tobb.instance_obb(verts), jobb.instance_obb(verts))
    obbs = np.stack([tobb.instance_obb(rs.randn(30, 3) * s) for s in (1.0, 2.0, 0.1)])
    labels = ["chair", "table", "wall"]
    mins, maxs = rs.rand(3, 3) - 2, rs.rand(3, 3) + 2
    equal(tobb.filter_obbs(obbs, labels, mins, maxs, [160, 150, 80], min_size=8.0),
          jobb.filter_obbs(obbs, labels, mins, maxs, [160, 150, 80], min_size=8.0))
    assert tobb.SCANNET_EXCLUDED_LABELS == jobb.SCANNET_EXCLUDED_LABELS


def _binary_ply(path, verts):
    n = len(verts)
    header = ("ply\nformat binary_little_endian 1.0\ncomment made by a test\n"
              f"element vertex {n}\nproperty float x\nproperty float y\nproperty float z\n"
              "property uchar red\nproperty uchar green\nproperty uchar blue\n"
              "element face 1\nproperty list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode())
        for v in verts:
            f.write(struct.pack("<fffBBB", *v, 10, 20, 30))
        f.write(struct.pack("<Biii", 3, 0, 1, 2))


def test_generate_scannet_obb_matches_the_script(tmp_path):
    rs = np.random.RandomState(3)
    scene = tmp_path / "scans" / "scene0001_00"
    scene.mkdir(parents=True)
    verts = (rs.randn(90, 3) * [2.0, 1.5, 0.6]).astype(np.float32)
    seg = rs.randint(0, 6, 90)
    _binary_ply(scene / "scene0001_00_vh_clean_2.ply", verts)
    with open(scene / "scene0001_00_vh_clean_2.0.010000.segs.json", "w") as f:
        json.dump({"segIndices": seg.tolist()}, f)
    with open(scene / "scene0001_00_vh_clean.aggregation.json", "w") as f:
        json.dump({"segGroups": [
            {"objectId": 0, "label": "chair", "segments": [0, 1]},
            {"objectId": 1, "label": "table", "segments": [2, 3, 4]},
            {"objectId": 2, "label": "wall", "segments": [5]},
            {"objectId": 3, "label": "sofa", "segments": [99]},  # no vertices
        ]}, f)
    equal(tgen.read_ply_vertices(str(scene / "scene0001_00_vh_clean_2.ply")), verts)
    for tool, name in ((tgen, "port"), (sgen, "script")):
        out = tmp_path / name
        out.mkdir()
        tool.process_scene(str(scene), str(out))
    got = json.loads((tmp_path / "port" / "scene0001_00.json").read_text())
    assert got == json.loads((tmp_path / "script" / "scene0001_00.json").read_text())
    assert got["instances"][3]["obb"] is None

    feat = tmp_path / "feat.npz"
    np.savez(feat, resolution=np.array([160, 140, 60]))
    for tool, name in ((tgen, "port"), (sgen, "script")):
        tool.filter_scene(str(feat), str(tmp_path / name / "scene0001_00.json"),
                          str(tmp_path / f"{name}.npy"), str(tmp_path / f"{name}_f.json"), 8.0)
    equal(np.load(tmp_path / "port.npy"), np.load(tmp_path / "script.npy"))
    assert (json.loads((tmp_path / "port_f.json").read_text())
            == json.loads((tmp_path / "script_f.json").read_text()))


# ---------------------------------------------------------------- viz

def _meta(from_mitsuba=False):
    return {"resolution": np.array([40, 36, 24]), "bbox_min": np.array([0.1, 0.2, 0.05]),
            "bbox_max": np.array([0.9, 0.8, 0.7]), "scale": 0.4,
            "offset": np.array([0.5, 0.45, 0.4]), "from_mitsuba": from_mitsuba}


@pytest.mark.parametrize("from_mitsuba", [False, True])
def test_ngp_boxes_match_jax(from_mitsuba, tmp_path):
    rs = np.random.RandomState(4)
    m = np.hstack([np.linalg.qr(rs.randn(3, 3))[0], rs.randn(3, 1)])
    equal(tviz.ngp_matrix_to_nerf(m, 0.4, np.array([0.1, 0.2, 0.3]), from_mitsuba),
          jviz.ngp_matrix_to_nerf(m, 0.4, np.array([0.1, 0.2, 0.3]), from_mitsuba))
    lo = rs.rand(5, 3) * 20
    props = np.concatenate([lo, lo + rs.rand(5, 3) * 10 + 1], axis=1)
    equal(tviz.proposals_to_ngp_boxes(props, _meta(from_mitsuba)),
          jviz.proposals_to_ngp_boxes(props, _meta(from_mitsuba)))
    tviz.save_ngp_boxes(str(tmp_path / "a.json"), props, _meta(from_mitsuba))
    jviz.save_ngp_boxes(str(tmp_path / "b.json"), props, _meta(from_mitsuba))
    assert (tmp_path / "a.json").read_bytes() == (tmp_path / "b.json").read_bytes()


def _grid(res=16, seed=5):
    rs = np.random.RandomState(seed)
    g = rs.rand(res, res, res, 4).astype(np.float32)
    g[..., 3] = (g[..., 3] > 0.8) * g[..., 3]
    return g


def test_projection_and_splat_match_jax():
    rs = np.random.RandomState(6)
    for boxes in (np.concatenate([rs.rand(4, 3), rs.rand(4, 3) + 1], 1),
                  np.concatenate([rs.rand(4, 6) * 3, rs.rand(4, 1)], 1)):
        equal(tviz.box_corners_3d(boxes), jviz.box_corners_3d(boxes))
    from nerf_mae_torch.ops.projection import _K, get_w2cs

    w2c = get_w2cs(16)[1]
    pts = rs.rand(30, 3) * 16
    equal(tviz.project_to_image(pts, w2c, _K), jviz.project_to_image(pts, w2c, _K))
    g = _grid()
    equal(tviz.splat_grid_view(g, w2c, _K, hw=(60, 80)), jviz.splat_grid_view(g, w2c, _K, hw=(60, 80)))


def _pixels(paths):
    return [np.asarray(Image.open(p)) for p in paths]


def test_render_detection_views_and_the_tool_match_jax(tmp_path):
    rs = np.random.RandomState(7)
    g = _grid()
    boxes = np.concatenate([rs.rand(3, 3) * 8 + 4, rs.rand(3, 3) * 4 + 2, rs.rand(3, 1)], 1)
    scores = np.array([0.9, 0.3, 0.7])
    kw = dict(pred_scores=scores, gt_boxes=boxes[:1] + 0.5, views=None)
    got = tviz.render_detection_views(g, boxes, str(tmp_path / "t"), **kw)
    want = jviz.render_detection_views(g, boxes, str(tmp_path / "j"), **kw)
    assert len(got) == 4
    equal(_pixels(got), _pixels(want))

    np.savez(tmp_path / "scene_0.npz", grid=g, boxes=boxes, scores=scores, gt_boxes=boxes[:2])
    tdets.main(["--proposals", str(tmp_path / "scene_0.npz"), "--out", str(tmp_path / "tp")])
    sdets.main(["--proposals", str(tmp_path / "scene_0.npz"), "--out", str(tmp_path / "sp")])
    names = sorted(os.listdir(tmp_path / "tp"))
    assert names == sorted(os.listdir(tmp_path / "sp")) and len(names) == 4
    equal(_pixels([tmp_path / "tp" / n for n in names]),
          _pixels([tmp_path / "sp" / n for n in names]))


def test_linesets_and_their_ply_match_jax(tmp_path):
    rs = np.random.RandomState(8)
    c2w = np.eye(4)
    c2w[:3, :3] = np.linalg.qr(rs.randn(3, 3))[0]
    c2w[:3, 3] = rs.randn(3)
    for fwd in (-1.0, 1.0):
        equal(tviz.camera_frustum_lineset(c2w, 0.9, 0.75, 0.2, forward=fwd),
              jviz.camera_frustum_lineset(c2w, 0.9, 0.75, 0.2, forward=fwd))
    boxes = np.concatenate([rs.rand(2, 6) * 3, rs.rand(2, 1)], 1)
    equal(tviz.box_lineset(boxes), jviz.box_lineset(boxes))
    equal(tviz.box_lineset(np.zeros((0, 6))), jviz.box_lineset(np.zeros((0, 6))))
    sets = [tviz.camera_frustum_lineset(c2w, 0.9), tviz.box_lineset(boxes)]
    equal(tviz.merge_linesets(sets), jviz.merge_linesets(sets))
    equal(tviz.merge_linesets([]), jviz.merge_linesets([]))
    p, l, c = tviz.merge_linesets(sets)
    tviz.save_lineset_ply(str(tmp_path / "a.ply"), p, l, c)
    jviz.save_lineset_ply(str(tmp_path / "b.ply"), p, l, c)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()


def test_proposals2ngp_matches_the_script(tmp_path, monkeypatch):
    rs = np.random.RandomState(9)
    lo = rs.rand(6, 3) * 20
    np.savez(tmp_path / "p.npz", proposals=np.concatenate([lo, lo + 3], 1),
             scores=rs.rand(6))
    np.savez(tmp_path / "f.npz", rgbsigma=np.zeros((2, 2, 2, 4)), **_meta())
    flags = ["--proposals_npz", str(tmp_path / "p.npz"), "--features_npz",
             str(tmp_path / "f.npz"), "--top_n", "4", "--score_thresh", "0.2"]
    tp2n.main(flags + ["--output", str(tmp_path / "a.json")])
    monkeypatch.setattr(sys, "argv", ["proposals2ngp.py"] + flags
                        + ["--output", str(tmp_path / "b.json")])
    sp2n.main()
    assert (tmp_path / "a.json").read_bytes() == (tmp_path / "b.json").read_bytes()


# ---------------------------------------------------------------- visualize_cameras

def _transforms(n, room_bbox=True, boxes=True, seed=10):
    rs = np.random.RandomState(seed)
    frames = []
    for i in range(n):
        c2w = np.eye(4)
        c2w[:3, :3] = np.linalg.qr(rs.randn(3, 3))[0]
        c2w[:3, 3] = rs.randn(3)
        frames.append({"file_path": f"images/{i}.png", "transform_matrix": c2w.tolist()})
    out = {"camera_angle_x": 1.1, "w": 64.0, "h": 48.0, "frames": frames}
    if room_bbox:
        out["room_bbox"] = [[-1.0, -1.2, -0.5], [1.5, 1.0, 0.8]]
    if boxes:
        out["bounding_boxes"] = [{"extents": [0.4, 0.3, 0.5],
                                  "orientation": np.linalg.qr(rs.randn(3, 3))[0].tolist(),
                                  "position": [0.2, -0.1, 0.3]}]
    return out


def test_visualize_cameras_matches_the_script_on_split_scenes(tmp_path):
    for split, n in (("train", 5), ("val", 3)):
        (tmp_path / split).mkdir()
        with open(tmp_path / split / "transforms.json", "w") as f:
            json.dump(_transforms(n, seed=n), f)
    flags = ["--scene", str(tmp_path), "--splits", "train", "val", "--subsample", "2"]
    out = tcams.main(flags + ["--out", str(tmp_path / "a.ply")])
    scams.main(flags + ["--out", str(tmp_path / "b.ply")])
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    assert out["n_frusta"] == 3 + 2


def test_visualize_cameras_draws_a_root_fallback_once(tmp_path, capsys):
    """Fault :114 of the script: every split without its own file falls back
    to the root transforms.json, and the script draws it once per split."""
    with open(tmp_path / "transforms.json", "w") as f:
        json.dump(_transforms(4), f)
    flags = ["--scene", str(tmp_path), "--splits", "train", "val", "test"]
    out = tcams.main(flags + ["--out", str(tmp_path / "a.ply")])
    assert out["n_frusta"] == 4
    assert "val: no val/transforms.json" in capsys.readouterr().out
    scams.main(flags + ["--out", str(tmp_path / "b.ply")])
    assert "12 frusta" in capsys.readouterr().out  # the script's duplicates


def test_visualize_cameras_room_box_from_arrays():
    """Fault :82 of the script: a room_bbox of arrays made lo + hi an
    elementwise sum; the port concatenates."""
    t = _transforms(1, boxes=False)
    lists = tcams.scene_linesets(t, (0, 1, 0))
    t["room_bbox"] = [np.asarray(b) for b in t["room_bbox"]]
    arrays = tcams.scene_linesets(t, (0, 1, 0))
    equal(arrays[-1], lists[-1])
    corners = arrays[-1][0]
    np.testing.assert_allclose(corners.min(0), [-1.0, -1.2, -0.5])
    np.testing.assert_allclose(corners.max(0), [1.5, 1.0, 0.8])
    with pytest.raises(IndexError):  # the script's elementwise sum: 3 values, not 6
        scams.scene_linesets(t, (0, 1, 0))


@pytest.mark.parametrize("from_mitsuba", [False, True])
def test_visualize_cameras_grid_lands_where_preprocess_boxes_puts_it(from_mitsuba, tmp_path):
    """Fault :135 of the script: the grid's voxels are mapped to the world by
    inverting scripts/preprocess_boxes.py (the npz's bbox, PERM, scale and
    offset), so a box's voxel centre maps back to the box's world position,
    and an occupied voxel of a run_nerf --ngp_frame grid to its world point."""
    meta = _meta(from_mitsuba)
    rs = np.random.RandomState(11)
    world = rs.rand(4, 3) * 0.6 - 0.3
    ann = {"bounding_boxes": [{"extents": [0.1, 0.1, 0.1], "orientation": np.eye(3).tolist(),
                               "position": p.tolist()} for p in world]}
    vox = sprep.process_obbs(ann, meta)[:, :3]
    np.testing.assert_allclose(tcams.voxel_to_world(vox, meta), world, atol=1e-5)

    # a run_nerf --ngp_frame grid over a world room box, one occupied voxel
    lo, hi, s, off = np.array([-1.0, -0.5, 0.0]), np.array([1.0, 0.5, 0.8]), 0.5, np.array(
        [0.5, 0.5, 0.3])
    res = np.array([20, 10, 8])
    g = np.zeros((*res, 4), np.float32)
    g[13, 2, 5, 3] = 5.0
    np.savez(tmp_path / "g.npz", rgbsigma=g, resolution=res,
             bbox_min=(lo * s + off)[[1, 2, 0]], bbox_max=(hi * s + off)[[1, 2, 0]],
             scale=s, offset=off, from_mitsuba=False)
    want = lo + (np.array([13, 2, 5]) + 0.5) / res * (hi - lo)
    np.testing.assert_allclose(tcams.grid_points(str(tmp_path / "g.npz"))[0], want, atol=1e-5)
