"""A trained NeRF queried on a regular lattice -> the rgbsigma grid npz
contract (counterpart of nerf_mae_tpu/nerf/extract.py).

(reference: data/scannet/run_nerf.py:1918-1975 extract_nerf.) The
resolution per axis is scaled so the longest bbox edge gets max_res; rgb is
sigmoid(raw) averaged over the training view directions; density stays
raw; (W, L, H, 4) float32 with resolution / bbox / scale / offset metadata.

Density and the trunk do not depend on the view, so each lattice chunk runs
the trunk once; per view only the colour head's direction term changes, and
a view has one direction, so it is a bias of color_fc: the product of the
trunk's features with color_fc's feature columns is made once per chunk,
and a view adds its bias, the ReLU, the rgb layer and the sigmoid. The same
function as evaluating the whole network at every (point, view), with the
cam latent zero as there.
"""

from __future__ import annotations

import numpy as np
import torch

from nerf_mae_torch.nerf.model import NeRFMLP, positional_encoding


def lattice(bbox_min, bbox_max, max_res: int):
    """(points [rx * ry * rz, 3] float32 in (x, y, z) C order, res [3])."""
    bbox_min = np.asarray(bbox_min, np.float32)
    bbox_max = np.asarray(bbox_max, np.float32)
    res = (bbox_max - bbox_min) / (bbox_max - bbox_min).max() * max_res
    res = np.round(res).astype(int)
    rx, ry, rz = (int(r) for r in res)
    xs = np.linspace(bbox_min[0], bbox_max[0], rx)
    ys = np.linspace(bbox_min[1], bbox_max[1], ry)
    zs = np.linspace(bbox_min[2], bbox_max[2], rz)
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    return np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float32), res


def view_directions(train_poses: np.ndarray) -> np.ndarray:
    """Unit view directions [V, 3]: each pose's R @ (0, 0, -1)."""
    viewdirs = np.stack([p[:3, :3] @ np.array([0, 0, -1.0], np.float32) for p in train_poses])
    return viewdirs / np.linalg.norm(viewdirs, axis=1, keepdims=True)


@torch.no_grad()
def extract_rgbsigma_grid(model: NeRFMLP, bbox_min, bbox_max, train_poses: np.ndarray,
                          max_res: int = 160, chunk: int = 65536,
                          scene_scale: float = 1.0) -> dict:
    """The grid of `model` (the fine network when hierarchical) over
    [bbox_min, bbox_max] in world units (positions divided by scene_scale
    before the encoding, as in training), rgb averaged over the directions
    of train_poses [V, 4, 4]. Runs where the model's parameters are."""
    pts, res = lattice(bbox_min, bbox_max, max_res)
    viewdirs = view_directions(train_poses)
    dev = model.rgb.weight.device
    w = model.width
    wf = model.color_fc.weight[:, :w]  # the feature columns
    d_enc = positional_encoding(torch.from_numpy(viewdirs.astype(np.float32)).to(dev),
                                model.dir_freqs)
    wd = model.color_fc.weight[:, w:w + d_enc.shape[1]]
    view_bias = d_enc @ wd.T + model.color_fc.bias  # [V, width // 2]

    n = pts.shape[0]
    rgb_sum = torch.empty((n, 3), device=dev)
    sigma_out = torch.empty((n,), device=dev)
    pts_t = torch.from_numpy(pts).to(dev)
    for s in range(0, n, chunk):
        sigma, feat = model.trunk(pts_t[s:s + chunk] / scene_scale)
        pre = feat @ wf.T
        acc = torch.zeros((pre.shape[0], 3), device=dev)
        for v in range(view_bias.shape[0]):
            acc += torch.sigmoid(model.rgb(torch.relu(pre + view_bias[v])))
        rgb_sum[s:s + chunk] = acc
        sigma_out[s:s + chunk] = sigma
    rgb_mean = (rgb_sum / len(viewdirs)).cpu().numpy()

    rgbsigma = np.concatenate([rgb_mean, sigma_out.cpu().numpy()[:, None]], axis=1)
    rgbsigma = rgbsigma.reshape(*(int(r) for r in res), 4)  # (W, L, H, 4)
    return {
        "rgbsigma": rgbsigma.astype(np.float32),
        "resolution": res,
        "bbox_min": np.asarray(bbox_min, np.float32),
        "bbox_max": np.asarray(bbox_max, np.float32),
        "scale": 1.0,
        "offset": 0.0,
        "from_mitsuba": False,
    }
