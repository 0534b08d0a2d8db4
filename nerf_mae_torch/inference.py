"""Scene inference: masked reconstruction and feature extraction.

Counterpart of scripts/inference_mae.py, with the same arguments and
outputs: one scene npz (or, with --scene_dir, every scene in a folder) goes
through masked reconstruction; the predicted grid is saved as
<scene>_pred.npz with every non-grid key of the input npz passed through,
beside target / masked / pred PLYs, and --save_features adds the 4-scale
encoder pyramid as <scene>_features.npz. Each scene is one batch of 1, as
in the JAX script, and every scene gets the mask drawn from --seed.

Weights: --mae_checkpoint takes what the JAX script's flag takes, the
checkpoint directory of the port's run_mae_pretrain (its newest step), or
a step's state.pt, a .pt state dict or a .npz of the flattened JAX
parameter tree (common.load_mae_params; a JAX orbax directory goes through
tools.orbax_to_npz first); --params takes the .npz or a .pt state dict of
the port or of the reference; --init_seed builds random weights instead.
Runs on the CUDA card unless --device cpu.

    python -m nerf_mae_torch.inference --scene_dir scenes/ \
        --mae_checkpoint checkpoints/mae --backbone_type swin_b --out_dir out/ \
        --save_features
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

from nerf_mae_torch.common import load_mae_params
from nerf_mae_torch.config import SWIN_PRESETS, MAEConfig
from nerf_mae_torch.convert import load_weights, load_weights_file
from nerf_mae_torch.data import density_to_alpha, scannet_density_to_alpha
from nerf_mae_torch.models.mae import (
    SwinMAE3D,
    init_weights,
    mae_loss,
    pad_grids_to_batch,
)
from nerf_mae_torch.viz import save_masked_recon

log = logging.getLogger("nerf_mae_torch.inference")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="NeRF-MAE scene inference (PyTorch)")
    p.add_argument("--scene_npz", default=None,
                   help="single scene npz (rgbsigma [+ metadata])")
    p.add_argument("--scene_dir", default=None,
                   help="batch over every .npz in this folder, passing each "
                        "file's metadata keys through to the output npz")
    w = p.add_mutually_exclusive_group(required=True)
    w.add_argument("--mae_checkpoint", default=None,
                   help="run_mae_pretrain checkpoint dir (newest step), a step's "
                        "state.pt, a .pt state dict or a flat JAX .npz")
    w.add_argument("--params", default=None,
                   help=".npz of the flattened JAX params, or a .pt state dict")
    w.add_argument("--init_seed", default=None, type=int,
                   help="random weights from this seed (smoke runs)")
    p.add_argument("--backbone_type", default="swin_s")
    p.add_argument("--resolution", default=160, type=int)
    p.add_argument("--masking_prob", default=0.75, type=float)
    p.add_argument("--dataset", default="front3d")
    p.add_argument("--out_dir", default="inference_out")
    p.add_argument("--save_features", action="store_true",
                   help="also dump the 4-scale encoder pyramid")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--compute_dtype", default="bfloat16")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def resolve_device(name: str) -> torch.device:
    """The requested device; asking for cuda without a card raises."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but no CUDA device is "
                           "available (pass --device cpu to run on the CPU)")
    return torch.device(name)


def build_model(args, device: torch.device) -> SwinMAE3D:
    cfg = MAEConfig(
        swin=SWIN_PRESETS[args.backbone_type],
        resolution=args.resolution,
        masking_prob=args.masking_prob,
        compute_dtype=args.compute_dtype,
    )
    model = SwinMAE3D(cfg, device=device)
    if args.mae_checkpoint:
        load_weights(model, load_mae_params(args.mae_checkpoint, cfg))
    elif args.params:
        load_weights_file(model, args.params)
    else:
        init_weights(model, args.init_seed)
    return model.eval()


@torch.inference_mode()
def run(model: SwinMAE3D, args, device: torch.device):
    """Serves every scene of the request; returns one summary dict per scene
    (loss terms and milliseconds)."""
    cfg = model.cfg
    alpha_fn = (
        scannet_density_to_alpha if args.dataset == "scannet" else density_to_alpha
    )
    os.makedirs(args.out_dir, exist_ok=True)
    if args.scene_dir:
        paths = sorted(
            os.path.join(args.scene_dir, f)
            for f in os.listdir(args.scene_dir) if f.endswith(".npz")
        )
        log.info("batch mode: %d scenes in %s", len(paths), args.scene_dir)
    else:
        paths = [args.scene_npz]

    results = []
    for path in paths:
        t0 = time.perf_counter()
        with np.load(path, allow_pickle=False) as f:
            rgbsigma = np.array(f["rgbsigma"])
            meta = {k: np.array(f[k]) for k in f.files if k != "rgbsigma"}
        if rgbsigma.dtype == np.uint8:
            rgbsigma = rgbsigma.astype(np.float32) / 255.0
        rgbsigma = rgbsigma.astype(np.float32)
        rgbsigma[..., -1] = alpha_fn(rgbsigma[..., -1])

        batch, sizes = pad_grids_to_batch([rgbsigma], cfg.resolution,
                                          channel_first=False)
        grids = torch.from_numpy(batch).to(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed)
        t_fwd = time.perf_counter()
        pred, token_mask = model(grids, generator=gen)
        loss, aux = mae_loss(pred, grids, token_mask,
                             torch.from_numpy(sizes).to(device), cfg)
        pred_np = pred[0].cpu().numpy()
        mask_np = token_mask[0].cpu().numpy()
        scene = os.path.splitext(os.path.basename(path))[0]
        summary = {"scene": scene, "loss": float(loss),
                   "loss_rgb": float(aux["loss_rgb"]),
                   "loss_alpha": float(aux["loss_alpha"]),
                   # forward + loss + the prediction's copy to the host
                   "forward_ms": (time.perf_counter() - t_fwd) * 1e3}
        log.info("%s: loss %.4f (rgb %.4f alpha %.4f)", scene, summary["loss"],
                 summary["loss_rgb"], summary["loss_alpha"])

        np.savez_compressed(
            os.path.join(args.out_dir, f"{scene}_pred.npz"),
            rgbsigma=pred_np, token_mask=mask_np, valid_size=sizes[0], **meta,
        )
        save_masked_recon(os.path.join(args.out_dir, scene), batch[0], pred_np,
                          mask_np, patch=cfg.swin.patch_size[0])

        if args.save_features:
            feats = model.encode(grids)
            np.savez_compressed(
                os.path.join(args.out_dir, f"{scene}_features.npz"),
                **{f"level{i}": f[0].float().cpu().numpy()
                   for i, f in enumerate(feats)},
                valid_size=sizes[0], **meta,
            )
            summary["features_finite"] = all(
                bool(torch.isfinite(f).all()) for f in feats)
            log.info("saved feature pyramid: %s",
                     [tuple(f.shape[1:]) for f in feats])
        summary["pred_finite"] = bool(np.isfinite(pred_np).all())
        summary["ms"] = (time.perf_counter() - t0) * 1e3  # the whole scene
        results.append(summary)
    log.info("saved predictions + PLYs to %s", args.out_dir)
    return results


def main(argv=None):
    """CLI entry; returns run()'s per-scene summaries."""
    args = parse_args(argv)
    if not args.scene_npz and not args.scene_dir:
        raise SystemExit("pass --scene_npz or --scene_dir")
    device = resolve_device(args.device)
    return run(build_model(args, device), args, device)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    main()
