"""The port's scene datasets on disk against the reference fixture and the
JAX package, on the CPU.

tests/fixtures/golden_data.npz holds tiny raw scene arrays and what the
reference datasets produced from them (density->alpha for Front3D and
ScanNet, the SR and semantic targets, the deterministic augmentations);
these tests replay them through nerf_mae_torch.data as
tests/test_parity_golden_data.py does through the JAX package, at its
tolerances, and hold every function bitwise (or at rtol 1e-6) against its
JAX original on the same inputs and draws.
"""

import os

import numpy as np
import pytest

from nerf_mae_tpu.data import datasets as jdata
from nerf_mae_torch import data

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "golden_data.npz")


@pytest.fixture(scope="module")
def fx():
    return dict(np.load(FIX))


@pytest.fixture()
def scene_dir(fx, tmp_path):
    for sub in ("features", "boxes", "out", "sem"):
        (tmp_path / sub).mkdir()
    np.savez(tmp_path / "features" / "a.npz", rgbsigma=fx["in_rgbsigma"])
    np.save(tmp_path / "boxes" / "a.npy", fx["in_boxes"])
    np.savez(tmp_path / "out" / "a.npz", rgbsigma=fx["in_out_rgbsigma"])
    np.save(tmp_path / "sem" / "a.npy", fx["in_sem"])
    return tmp_path


def _both(scene_dir, **kw):
    """The port's and the JAX package's SceneDataset on the same files."""
    kw = {k: str(scene_dir / v) if k.endswith("_path") else v for k, v in kw.items()}
    return (data.SceneDataset(str(scene_dir / "features"), **kw),
            jdata.SceneDataset(str(scene_dir / "features"), **kw))


def _equal_items(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("case,kw,want", [
    ("front3d", {"boxes_path": "boxes"}, {"rgbsigma": "front3d_rgbsigma",
                                          "boxes": "front3d_boxes"}),
    ("scannet", {"boxes_path": "boxes", "dataset_type": "scannet"},
     {"rgbsigma": "scannet_rgbsigma"}),
    ("sr", {"out_feat_path": "out"}, {"rgbsigma": "sr_in", "out_rgbsigma": "sr_out"}),
    ("semantics", {"sem_feat_path": "sem"}, {"rgbsigma": "sem_in"}),
])
def test_scene_loading_matches_reference_and_jax(fx, scene_dir, case, kw, want):
    ours, theirs = _both(scene_dir, **kw)
    item = ours[0]
    for key, ref in want.items():
        if key == "boxes":
            np.testing.assert_array_equal(item[key], fx[ref])
        else:
            np.testing.assert_allclose(item[key], fx[ref], rtol=1e-6, atol=1e-7)
    if case == "semantics":
        np.testing.assert_array_equal(item["semantics"][None], fx["sem_labels"])
    _equal_items(item, theirs[0])


def _augment(module, fx, boxes, flip, rot):
    item = {"rgbsigma": fx["front3d_rgbsigma"].copy(), "boxes": boxes.copy()}
    return module.augment_scene(item, np.random.RandomState(0), flip_prob=flip,
                                rotate_prob=rot, rot_scale_prob=0.0)


@pytest.mark.parametrize("flip,rot,grid,aabb,obb", [
    (0.0, 1.0, "rot90_rgbsigma", "rot90_boxes", "rot90_obb"),
    (1.0, 0.0, "flip_rgbsigma", "flip_boxes", "flip_obb"),
])
def test_rot90_and_flips_match_reference_and_jax(fx, flip, rot, grid, aabb, obb):
    for boxes, want in ((fx["front3d_boxes"], aabb), (fx["in_obb"], obb)):
        out = _augment(data, fx, boxes, flip, rot)
        np.testing.assert_allclose(out["rgbsigma"], fx[grid], atol=1e-7)
        np.testing.assert_allclose(out["boxes"], fx[want], atol=1e-6)
        _equal_items(out, _augment(jdata, fx, boxes, flip, rot))


def test_rotate_and_scale_matches_reference_and_jax(fx):
    args = (np.ascontiguousarray(fx["front3d_rgbsigma"]), fx["in_obb"].copy())
    g, b = data.rotate_and_scale_scene(*args, angle=0.12, scale=1.07)
    np.testing.assert_allclose(b, fx["rotscale_obb"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g, fx["rotscale_rgbsigma"], atol=1e-4)
    jg, jb = jdata.rotate_and_scale_scene(*args, angle=0.12, scale=1.07)
    np.testing.assert_array_equal(g, jg)
    np.testing.assert_array_equal(b, jb)
    idx = np.random.RandomState(1).uniform(-2, 9, (50, 3))
    np.testing.assert_array_equal(data._trilinear_gather_zeros(args[0], idx),
                                  jdata._trilinear_gather_zeros(args[0], idx))


def test_random_augments_draw_as_jax(fx, scene_dir):
    """Flip, rot90 and rotate+scale drawn from the dataset's seeded stream:
    the same items, bitwise, over several draws."""
    np.save(scene_dir / "boxes" / "a.npy", fx["in_obb"])
    ours, theirs = _both(scene_dir, boxes_path="boxes", flip_prob=0.5, rotate_prob=0.5,
                         rot_scale_prob=0.5, seed=3)
    for _ in range(6):
        _equal_items(ours[0], theirs[0])


def test_split_percent_uint8_and_dropped_scenes(tmp_path):
    """load_split; percent_train; a uint8 grid is /255 without density ->
    alpha; a scene missing its features file or with no boxes is dropped;
    preload gives the same items."""
    feats, boxes = tmp_path / "features", tmp_path / "boxes"
    feats.mkdir()
    boxes.mkdir()
    rs = np.random.RandomState(0)
    for i in range(4):
        g = rs.rand(5, 6, 7, 4).astype(np.float32)
        if i == 1:
            g = (g * 255).astype(np.uint8)
        np.savez(feats / f"s{i}.npz", rgbsigma=g)
        np.save(boxes / f"s{i}.npy", np.zeros((0 if i == 2 else 2, 6), np.float32))
    split = tmp_path / "split.npz"
    np.savez(split, train_scenes=np.array(["s0", "s1", "s2", "gone"]),
             val_scenes=np.array(["s3"]))
    assert data.load_split(str(split)) == jdata.load_split(str(split))
    scene_list = data.load_split(str(split))["train"]
    for kw in ({}, {"boxes_path": str(boxes)}, {"percent_train": 0.5},
               {"preload": True}):
        ours = data.SceneDataset(str(feats), scene_list=scene_list, **kw)
        theirs = jdata.SceneDataset(str(feats), scene_list=scene_list, **kw)
        assert ours.scenes == theirs.scenes
        for i in range(len(ours)):
            _equal_items(ours[i], theirs[i])
    assert data.SceneDataset(str(feats), scene_list=scene_list,
                             boxes_path=str(boxes)).scenes == ["s0", "s1"]
    item = data.SceneDataset(str(feats), scene_list=["s1"])[0]
    with np.load(feats / "s1.npz") as f:
        np.testing.assert_array_equal(item["rgbsigma"],
                                      f["rgbsigma"].astype(np.float32) / 255.0)
    assert data.SceneDataset(str(feats)).scenes == ["s0", "s1", "s2", "s3"]
