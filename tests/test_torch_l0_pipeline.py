"""The port's L0 data production end to end (slow tier), the counterpart of
tests/test_l0_pipeline.py:

  raw poses + world boxes
    -> scripts/save_transforms.py           (numpy, serves both packages)
    -> views of an analytic stand-in field rendered with the port's
       render_rays, written with the port's PNG codec
    -> nerf_mae_torch.run_nerf --task train_extract --ngp_frame --device cpu
    -> scripts/preprocess_boxes.py          (world OBBs -> voxel [N, 7])
    -> the port's SceneDataset + detection_batch_iterator
    -> one swin_nano FCOS train step (finite loss, positives matched)

with the voxel boxes on the extracted density (the JAX test's centroid
check). Marked slow as the JAX test is: it trains a NeRF for 250 steps
and an FCOS step on the CPU (~2 minutes). chip_smoke.py phase 17 runs the
same chain at full width on the card.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from nerf_mae_torch import run_nerf
from nerf_mae_torch.config import SWIN_PRESETS, TrainConfig
from nerf_mae_torch.data import SceneDataset, detection_batch_iterator
from nerf_mae_torch.models.fcos import FCOSConfig
from nerf_mae_torch.nerf.images import write_png
from nerf_mae_torch.nerf.render import get_rays, render_rays
from nerf_mae_torch.train.det_trainer import DetectionTrainer

pytestmark = pytest.mark.slow
torch.set_num_threads(1)
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scripts"))


def look_at(eye, target, up=(0, 0, 1)):
    eye = np.asarray(eye, np.float64)
    f = eye - np.asarray(target, np.float64)
    f /= np.linalg.norm(f)
    r = np.cross(np.asarray(up, np.float64), f)
    r /= np.linalg.norm(r)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = r, np.cross(f, r), f, eye
    return c2w


def test_l0_pipeline_composes_on_the_port(tmp_path):
    from preprocess_boxes import main as preprocess_boxes_main
    from save_transforms import main as save_transforms_main

    objs = [(np.array([9.0, -3.8, 0.8]), np.array([1.6, 1.6, 1.4])),
            (np.array([12.0, -2.2, 0.7]), np.array([1.4, 1.4, 1.2]))]
    mid = (objs[0][0] + objs[1][0]) / 2
    rng = np.random.RandomState(0)
    ang = np.linspace(0, 2 * np.pi, 16, endpoint=False)
    eyes = np.stack([mid[0] + 3.8 * np.cos(ang), mid[1] + 3.8 * np.sin(ang),
                     2.2 + 0.15 * rng.randn(16)], axis=1)
    scene = tmp_path / "scene0"
    (scene / "poses").mkdir(parents=True)
    for i, e in enumerate(eyes):
        with open(scene / "poses" / f"{i:02d}.json", "w") as f:
            json.dump({"pose": look_at(e, mid).tolist()}, f)
    items = []
    for pos, ext in objs:  # the HM3D json is y-up
        lo, hi = pos - ext / 2, pos + ext / 2
        items.append({"class_name": "chair", "bbox": [lo[[0, 2, 1]].tolist(),
                                                      hi[[0, 2, 1]].tolist()]})
    with open(tmp_path / "boxes.json", "w") as f:
        json.dump(items, f)

    W = H = 24
    tpath = scene / "transforms.json"
    assert save_transforms_main([
        "--input_dir", str(scene), "--boxes_json", str(tmp_path / "boxes.json"), "--output",
        str(tpath), "--swap_yz", "--width", str(W), "--height", str(H), "--fov_x", "70"]) == 0
    with open(tpath) as f:
        tj = json.load(f)

    blobs = [(torch.tensor(b["position"], dtype=torch.float32), 0.75 * min(b["extents"]))
             for b in tj["bounding_boxes"]]
    colors = [torch.tensor([4.0, -4.0, -4.0]), torch.tensor([-4.0, -4.0, 4.0])]

    def field(_params, pts, _vd):
        sigma = torch.zeros(pts.shape[:-1])
        rgb = torch.zeros(pts.shape[:-1] + (3,))
        for (c, r), col in zip(blobs, colors):
            inside = torch.linalg.norm(pts - c, dim=-1) < r
            sigma = torch.where(inside, 60.0, sigma)
            rgb = torch.where(inside[..., None], col, rgb)
        return rgb, sigma

    focal = 0.5 * W / np.tan(0.5 * tj["camera_angle_x"])
    poses = np.asarray([fr["transform_matrix"] for fr in tj["frames"]], np.float32)
    cam_d = np.linalg.norm(poses[:, :3, 3] - np.asarray(blobs[0][0]), axis=1)
    near, far = 0.05, float(cam_d.max() * 1.8)  # tight, as the JAX test explains
    spread = []
    for fr, p in zip(tj["frames"], poses):
        o, d = get_rays(torch.from_numpy(p), H, W, focal)
        with torch.no_grad():
            img = render_rays(None, field, o.reshape(-1, 3), d.reshape(-1, 3), near, far,
                              64)["rgb"].reshape(H, W, 3).numpy()
        spread.append(img.std())
        (scene / fr["file_path"]).parent.mkdir(parents=True, exist_ok=True)
        write_png(str(scene / fr["file_path"]), (img * 255).astype(np.uint8))
    assert max(spread) > 0.05, "objects not visible from the output poses"

    feat_dir = tmp_path / "features"
    run_nerf.main([
        "--task", "train_extract", "--scene_dir", str(scene), "--scene_id", "scene0",
        "--extract_dir", str(feat_dir), "--ngp_frame", "--steps", "250", "--lr", "5e-4",
        "--ray_batch", "256", "--n_samples", "32", "--n_importance", "0", "--max_res", "16",
        "--near", str(near), "--far", str(far), "--device", "cpu"])
    npz = np.load(feat_dir / "scene0.npz")
    g = npz["rgbsigma"]
    assert list(g.shape[:3]) == list(npz["resolution"]) and g.shape[-1] == 4

    boxes_dir = tmp_path / "boxes"
    boxes_dir.mkdir()
    preprocess_boxes_main(["--annotations", str(tpath), "--features_npz",
                           str(feat_dir / "scene0.npz"), "--output",
                           str(boxes_dir / "scene0.npy"), "--format", "obb"])
    vb = np.load(boxes_dir / "scene0.npy")
    assert vb.shape == (2, 7)
    sig = np.maximum(g[..., 3], 0.0)
    assert sig.max() > 0, "the NeRF reconstructed no positive density"
    occ = np.stack(np.nonzero(sig > sig.max() * 0.5), axis=1) + 0.5
    for bi in range(2):
        near_occ = occ[np.linalg.norm(occ - vb[bi, :3], axis=1)
                       < max(3.0, 0.75 * vb[bi, 3:6].max())]
        assert len(near_occ), f"no density near voxel box {bi}"
        np.testing.assert_allclose(near_occ.mean(0), vb[bi, :3], atol=2.5,
                                   err_msg=f"voxel box {bi} off the density centroid")

    ds = SceneDataset(str(feat_dir), boxes_path=str(boxes_dir))
    assert len(ds) == 1 and ds[0]["boxes"].shape == (2, 7)
    fcos = FCOSConfig(resolution=32, use_obb=True, pre_nms_top_n=32, post_nms_top_n=16,
                      max_gt=4)
    trainer = DetectionTrainer(SWIN_PRESETS["swin_nano"], fcos, TrainConfig(batch_size=1), 10,
                               "cpu", backbone="swin_nano", compute_dtype="float32",
                               remat=False)
    batch = next(detection_batch_iterator(ds, 1, 32, max_gt=4, shuffle=False, loop=False))
    state = trainer.init(0)
    state, m = trainer.train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert np.isfinite(float(m["loss"])), m
    assert float(m["num_pos"]) > 0, "no FCOS positives matched the gt boxes"
