"""Per-scene NeRF training and rgbsigma grid extraction, the L0 data
production (the port's counterpart of scripts/run_nerf.py; reference:
data/scannet/run_nerf.py --task {train,extract}). Reads an instant-ngp
transforms.json with its PNG frames (and 16-bit depth maps), trains a NeRF
and writes the (W, L, H, 4) rgbsigma grid npz every downstream task reads.

  python -m nerf_mae_torch.run_nerf --task train_extract --scene_dir scene \\
      --ngp_frame --max_res 160 --extract_dir features --scene_id scene0000

Runs on the CUDA card unless --device cpu. --params_out saves (train) the
trained parameters as a torch state dict; extract loads such a file or the
pickle that scripts/run_nerf.py's --params_out writes (its numpy parameter
tree, read by a restricted unpickler that admits only dicts, lists, tuples,
numpy arrays and dtypes, and mapped by convert.nerf_params_from_jax).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import pickle
import zipfile
from typing import Dict

import numpy as np
import torch

from nerf_mae_torch.common import setup_logging
from nerf_mae_torch.convert import nerf_params_from_jax
from nerf_mae_torch.inference import resolve_device
from nerf_mae_torch.nerf.extract import extract_rgbsigma_grid
from nerf_mae_torch.nerf.images import read_png, resize
from nerf_mae_torch.nerf.train import NeRFTrainer

log = logging.getLogger("run_nerf")


class TreeUnpickler(pickle.Unpickler):
    """Unpickles a numpy parameter tree and nothing else: dicts, lists and
    tuples (pickle's own opcodes), numpy arrays and dtypes (the globals
    below; `_frombuffer` is how protocol 5 rebuilds a contiguous array). Any other class is refused with its name before it is
    imported, so no jax or flax module loads."""

    ALLOWED = {("numpy", "ndarray"), ("numpy", "dtype"),
               ("numpy.core.multiarray", "_reconstruct"),
               ("numpy._core.multiarray", "_reconstruct"),
               ("numpy.core.numeric", "_frombuffer"),
               ("numpy._core.numeric", "_frombuffer")}

    def find_class(self, module, name):
        if (module, name) not in self.ALLOWED:
            raise pickle.UnpicklingError(
                f"{module}.{name} is not part of a numpy parameter tree; refused")
        return super().find_class(module, name)


def load_params(path: str, params) -> Dict[str, torch.Tensor]:
    """The state dict of --params_out for the NeRFParams `params`: a torch
    state dict (what --task train writes), or the JAX driver's pickle
    (TreeUnpickler, then convert.nerf_params_from_jax)."""
    if zipfile.is_zipfile(path):  # torch.save's format
        return torch.load(path, map_location="cpu", weights_only=True)
    with open(path, "rb") as f:
        tree = TreeUnpickler(f).load()
    return nerf_params_from_jax(tree, params)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a per-scene NeRF + extract grid")
    p.add_argument("--task", default="train_extract",
                   choices=["train", "extract", "train_extract"])
    p.add_argument("--scene_dir", required=True,
                   help="dir containing transforms.json + images")
    p.add_argument("--transforms", default="transforms.json")
    p.add_argument("--scene_id", default="scene")
    p.add_argument("--extract_dir", default="features")
    p.add_argument("--params_out", default=None,
                   help="file to save (train) or load (extract) the NeRF's parameters: a "
                        "torch state dict, or scripts/run_nerf.py's pickle (extract)")
    p.add_argument("--steps", default=20000, type=int)
    p.add_argument("--lr", default=5e-4, type=float)
    p.add_argument("--ray_batch", default=4096, type=int)
    p.add_argument("--n_samples", default=64, type=int)
    p.add_argument("--n_importance", default=64, type=int,
                   help="fine samples/ray; 0 disables the hierarchical path "
                        "(reference: run_nerf.py --N_importance)")
    p.add_argument("--depth_loss_weight", default=0.0, type=float,
                   help="Gaussian-NLL depth supervision weight "
                        "(reference: run_nerf.py --depth_loss_weight)")
    p.add_argument("--depth_guided", action="store_true",
                   help="3-sigma depth-guided sampling (dense-depth-priors "
                        "train path, reference: run_nerf.py:846-902)")
    p.add_argument("--depth_sigma_frac", default=0.03, type=float,
                   help="relative sensor-depth noise for the 3-sigma band")
    p.add_argument("--depth_dir", default=None,
                   help="directory of 16-bit depth PNGs named like the rgb "
                        "frames (used when frames[] lack depth_file_path)")
    p.add_argument("--depth_scale", default=1000.0, type=float,
                   help="depth PNG units per meter (ScanNet mm: 1000)")
    p.add_argument("--cam_embed_dim", default=0, type=int,
                   help="per-view appearance latent size (reference: "
                        "run_nerf.py:298-359); 0 disables")
    p.add_argument("--near", default=0.1, type=float)
    p.add_argument("--far", default=10.0, type=float)
    p.add_argument("--max_res", default=160, type=int)
    p.add_argument("--bbox_min", nargs=3, type=float, default=None)
    p.add_argument("--bbox_max", nargs=3, type=float, default=None)
    p.add_argument("--bbox_json", default=None,
                   help="instance bbox json (reference format) for scene bounds")
    p.add_argument("--ngp_frame", action="store_true",
                   help="extract over the transforms.json room_bbox and stamp "
                        "the npz with instant-ngp-convention metadata (bbox in "
                        "ngp coords = (world*scale+offset) cycled xyz->yzx, "
                        "plus the json's scale/offset) so preprocess_boxes.py "
                        "composes directly")
    p.add_argument("--downscale", default=1, type=int,
                   help="shrink the frames by this factor (needs Pillow)")
    p.add_argument("--white_bkgd", action="store_true")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def load_scene(scene_dir: str, transforms: str, downscale: int,
               depth_dir: str = None, depth_scale: float = 1000.0):
    """instant-ngp transforms.json: camera_angle_x + frames[].file_path /
    transform_matrix. Sensor depth comes from a frame's `depth_file_path`
    or, failing that, `<depth_dir>/<rgb filename>`: 16-bit PNGs in
    1/depth_scale units (ScanNet: millimetres), 0 = invalid; resampled to
    the colour frame's size with nearest neighbour (no interpolation across
    the invalid 0). Returns (images, poses, focal, depths | None, valid |
    None)."""
    with open(os.path.join(scene_dir, transforms)) as f:
        meta = json.load(f)
    images, poses, depths = [], [], []
    for fr in meta["frames"]:
        path = os.path.join(scene_dir, fr["file_path"])
        if not os.path.splitext(path)[1]:
            path += ".png"
        img = read_png(path)
        if downscale > 1:
            img = resize(img, (img.shape[1] // downscale, img.shape[0] // downscale))
        arr = img.astype(np.float32) / 255.0
        if arr.shape[-1] == 4:  # composite alpha over black
            arr = arr[..., :3] * arr[..., 3:]
        images.append(arr)
        poses.append(np.asarray(fr["transform_matrix"], np.float32))
        dpath = fr.get("depth_file_path")
        dpath = os.path.join(scene_dir, dpath) if dpath else (
            os.path.join(depth_dir, os.path.basename(path)) if depth_dir else None)
        if dpath and os.path.exists(dpath):
            dimg = read_png(dpath)
            if dimg.shape[:2] != img.shape[:2]:
                dimg = resize(dimg, (img.shape[1], img.shape[0]), nearest=True)
            depths.append(dimg.astype(np.float32) / depth_scale)
        else:
            depths.append(None)
    images = np.stack(images)
    poses = np.stack(poses)
    h, w = images.shape[1:3]
    focal = 0.5 * w / np.tan(0.5 * meta["camera_angle_x"])
    if any(d is not None for d in depths):
        depths = np.stack([d if d is not None else np.zeros((h, w), np.float32)
                           for d in depths])
        return images, poses, focal, depths, depths > 0
    return images, poses, focal, None, None


def scene_bounds(args, poses):
    if args.bbox_min is not None:
        return np.asarray(args.bbox_min, np.float32), np.asarray(args.bbox_max, np.float32)
    if args.bbox_json:
        with open(args.bbox_json) as f:
            bbox = json.load(f)
        mins = np.asarray([i["min_pt"] for i in bbox["instances"]], np.float32)
        maxs = np.asarray([i["max_pt"] for i in bbox["instances"]], np.float32)
        return mins.min(0), maxs.max(0)
    # fall back to the camera hull padded 20%
    centers = poses[:, :3, 3]
    lo, hi = centers.min(0), centers.max(0)
    pad = 0.2 * (hi - lo + 1e-3)
    return lo - pad, hi + pad


def make_trainer(args, scene_scale: float, device: torch.device) -> NeRFTrainer:
    return NeRFTrainer(
        near=args.near, far=args.far, n_samples=args.n_samples,
        n_importance=0 if args.depth_guided else args.n_importance,
        depth_loss_weight=args.depth_loss_weight, lr=args.lr,
        ray_batch=args.ray_batch, scene_scale=scene_scale,
        white_bkgd=args.white_bkgd, depth_guided=args.depth_guided,
        depth_sigma_frac=args.depth_sigma_frac, cam_embed_dim=args.cam_embed_dim,
        device=device)


def main(argv=None):
    """Returns {"trainer", "params", "psnr" (train), "npz" (extract)}."""
    args = parse_args(argv)
    setup_logging()
    if args.task == "extract" and not args.params_out:
        raise SystemExit("--task extract needs --params_out: the file of trained NeRF "
                         "parameters that --task train wrote")
    device = resolve_device(args.device)

    images, poses, focal, depths, valid_depths = load_scene(
        args.scene_dir, args.transforms, args.downscale,
        depth_dir=args.depth_dir, depth_scale=args.depth_scale)
    log.info("scene: %d views %dx%d focal %.1f depth maps: %s", len(images),
             images.shape[2], images.shape[1], focal,
             "none" if depths is None
             else f"{int((valid_depths.sum(axis=(1, 2)) > 0).sum())} views")
    if depths is None and (args.depth_guided or args.depth_loss_weight > 0):
        log.warning(
            "--depth_guided/--depth_loss_weight requested but no depth maps "
            "were found (frames[].depth_file_path or --depth_dir): sampling "
            "falls back to the predicted-depth band and the depth NLL loss "
            "is inactive")
    ngp_meta = None
    if args.ngp_frame:
        with open(os.path.join(args.scene_dir, args.transforms)) as f:
            ngp_meta = json.load(f)
        for k in ("room_bbox", "scale", "offset"):
            if k not in ngp_meta:
                raise SystemExit(f"--ngp_frame needs '{k}' in {args.transforms} "
                                 "(produce it with scripts/save_transforms.py)")
        bbox_min, bbox_max = (np.asarray(b, np.float32) for b in ngp_meta["room_bbox"])
    else:
        bbox_min, bbox_max = scene_bounds(args, poses)
    scene_scale = float(np.abs(np.concatenate([bbox_min, bbox_max])).max())
    trainer = make_trainer(args, scene_scale, device)
    result = {"trainer": trainer}

    if args.task in ("train", "train_extract"):
        params, psnr = trainer.fit(images, poses, focal, steps=args.steps, seed=args.seed,
                                   depths=depths, valid_depths=valid_depths)
        log.info("trained: final train PSNR %.2f", psnr)
        result["psnr"] = psnr
        if args.params_out:
            torch.save({k: v.cpu() for k, v in params.state_dict().items()}, args.params_out)
            log.info("saved params to %s", args.params_out)
    else:
        params, _ = trainer.init(args.seed, n_views=len(images))
        params.load_state_dict(load_params(args.params_out, params))
    result["params"] = params

    if args.task in ("extract", "train_extract"):
        out = extract_rgbsigma_grid(trainer.fine_params(params), bbox_min, bbox_max, poses,
                                    max_res=args.max_res, scene_scale=scene_scale)
        if ngp_meta is not None:
            # rgbsigma stays in world-axis order; only the metadata moves to
            # the ngp frame: p_ngp = (p * scale + offset)[[1, 2, 0]], which
            # preprocess_boxes undoes with its PERM
            s, off = float(ngp_meta["scale"]), np.asarray(ngp_meta["offset"])
            out["bbox_min"] = (out["bbox_min"] * s + off)[[1, 2, 0]]
            out["bbox_max"] = (out["bbox_max"] * s + off)[[1, 2, 0]]
            out["scale"], out["offset"] = s, off
        os.makedirs(args.extract_dir, exist_ok=True)
        path = os.path.join(args.extract_dir, f"{args.scene_id}.npz")
        np.savez_compressed(path, **out)
        log.info("extracted rgbsigma grid %s -> %s", out["rgbsigma"].shape, path)
        result["npz"] = path
    return result


if __name__ == "__main__":
    main()
