"""Per-scene NeRF trainer (counterpart of nerf_mae_tpu/nerf/train.py).

(reference: data/scannet/run_nerf.py:1188-1480 train_nerf: ray batches, an
MSE photometric loss, Adam; coarse + fine networks when n_importance > 0
(:939-981); optional Gaussian-NLL depth supervision (:1316-1324).)

The rays, targets and sensor depths of every view are made and uploaded to
the device once; a step sends only its ray indices (np.random.RandomState
(seed).randint, the JAX trainer's selection) and gathers its batch there.
A step's random draws come from a generator seeded from (seed, step).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch
from torch import nn

from nerf_mae_torch.nerf.model import NeRFMLP
from nerf_mae_torch.nerf.render import (
    depth_nll_loss,
    get_rays,
    render_rays,
    render_rays_depth_guided,
    render_rays_hierarchical,
)
from nerf_mae_torch.train.trainer import stream_seed

logger = logging.getLogger(__name__)


class NeRFParams(nn.Module):
    """What a NeRF trainer optimises (the JAX trainer's params dict):
    `coarse`, `fine` (hierarchical only) and the per-view latent table `cam`
    [n_views, cam_embed_dim] (cam_embed_dim > 0 only)."""

    def __init__(self, coarse: NeRFMLP, fine: Optional[NeRFMLP] = None, n_views: int = 0,
                 cam_embed_dim: int = 0):
        super().__init__()
        self.coarse = coarse
        self.fine = fine
        self.cam = nn.Parameter(torch.zeros(n_views, cam_embed_dim)) if cam_embed_dim else None


@dataclasses.dataclass
class NeRFTrainer:
    near: float
    far: float
    n_samples: int = 64
    n_importance: int = 0  # > 0: the coarse / fine hierarchical path
    depth_loss_weight: float = 0.0
    # depth-guided 3-sigma sampling (reference: data/scannet/run_nerf.py:846-902);
    # excludes n_importance
    depth_guided: bool = False
    # relative sensor noise: the 3-sigma band is depth * (1 +- 3 * depth_sigma_frac)
    depth_sigma_frac: float = 0.03
    # > 0: per-training-view appearance latents, optimised in params.cam
    # (reference: data/scannet/run_nerf.py:298-359); renders without a view
    # use a zero latent
    cam_embed_dim: int = 0
    lr: float = 5e-4
    ray_batch: int = 4096
    scene_scale: float = 1.0  # divides xyz before the encoding
    white_bkgd: bool = False
    model: Optional[NeRFMLP] = None  # the network's shape (its hparams); its weights are unused
    device: str = "cuda"

    def __post_init__(self):
        if self.model is None:
            self.model = NeRFMLP(cam_embed_dim=self.cam_embed_dim)
        if self.depth_guided and self.hierarchical:
            raise ValueError("depth_guided replaces hierarchical sampling "
                             "(reference uses one or the other)")
        self.device = torch.device(self.device)
        self.history = []  # fit's (step, loss, img_loss) every log_every steps

    @property
    def hierarchical(self) -> bool:
        return self.n_importance > 0

    def apply(self, net: NeRFMLP, pts: torch.Tensor, viewdir: torch.Tensor, cam=None):
        """The field at world points: positions divided by scene_scale."""
        return net(pts / self.scene_scale, viewdir, cam)

    def init(self, seed: int, n_views: int = 0):
        """(params, optimizer): networks drawn in order coarse, fine from a
        CPU generator seeded with `seed` (the same weights on any device),
        a zero latent table, torch.optim.Adam(lr) (optax.adam's b1, b2, eps)."""
        if self.cam_embed_dim and n_views <= 0:
            raise ValueError("cam_embed_dim > 0 requires n_views")
        gen = torch.Generator().manual_seed(seed)
        new = lambda: NeRFMLP(**self.model.hparams).reset_parameters(gen)
        coarse = new()
        fine = new() if self.hierarchical else None
        params = NeRFParams(coarse, fine, n_views, self.cam_embed_dim).to(self.device)
        opt = torch.optim.Adam(params.parameters(), lr=self.lr, betas=(0.9, 0.999), eps=1e-8)
        return params, opt

    def _make_apply(self, cam: Optional[torch.Tensor]):
        """model_apply conditioning the colour head on per-ray latents [N, E]."""
        if cam is None:
            return self.apply
        return lambda net, pts, viewdir: self.apply(net, pts, viewdir, cam[:, None, :])

    def render(self, params: NeRFParams, rays_o, rays_d, generator=None, target_depth=None,
               valid_depth=None, cam=None, u=None):
        apply = self._make_apply(cam)
        if self.depth_guided and target_depth is not None:
            band = 3.0 * self.depth_sigma_frac * target_depth
            return render_rays_depth_guided(
                params.coarse, apply, rays_o, rays_d, self.near, self.far, target_depth,
                target_depth - band, target_depth + band, valid_depth, self.n_samples,
                generator, self.white_bkgd, u=u)
        if self.hierarchical:
            return render_rays_hierarchical(
                params.coarse, params.fine, apply, rays_o, rays_d, self.near, self.far,
                self.n_samples, self.n_importance, generator, self.white_bkgd, u=u)
        return render_rays(params.coarse, apply, rays_o, rays_d, self.near, self.far,
                           self.n_samples, generator, self.white_bkgd, u=u)

    def train_step(self, params: NeRFParams, opt: torch.optim.Optimizer, rays_o, rays_d,
                   target_rgb, target_depth, valid_depth, view_idx, generator=None, u=None):
        """One Adam step in place on the photometric MSE, plus the coarse MSE
        when hierarchical (reference :1326-1328), plus depth_loss_weight x
        the depth NLL. Returns (params, opt, loss, img_loss), the losses as
        detached device scalars (no host sync)."""
        cam = params.cam[view_idx] if self.cam_embed_dim else None
        out = self.render(params, rays_o, rays_d, generator, target_depth, valid_depth, cam, u)
        img_loss = ((out["rgb"] - target_rgb) ** 2).mean()
        loss = img_loss
        if self.hierarchical:
            loss = loss + ((out["rgb0"] - target_rgb) ** 2).mean()
        if self.depth_loss_weight > 0.0:
            loss = loss + self.depth_loss_weight * depth_nll_loss(
                out["depth"], out["z_vals"], out["weights"], target_depth, valid_depth)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        for p in params.parameters():  # optax updates every leaf; a missing grad is 0
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        opt.step()
        return params, opt, loss.detach(), img_loss.detach()

    @torch.no_grad()
    def render_chunk(self, params: NeRFParams, rays_o, rays_d):
        """Deterministic render of a ray chunk (zero latent)."""
        return self.render(params, rays_o, rays_d)

    def fine_params(self, params: NeRFParams) -> NeRFMLP:
        """The network used at extraction time (fine when hierarchical)."""
        return params.fine if self.hierarchical else params.coarse

    def upload_rays(self, images: np.ndarray, poses: np.ndarray, focal: float,
                    depths: Optional[np.ndarray] = None,
                    valid_depths: Optional[np.ndarray] = None):
        """Every view's rays, targets and sensor depths on the device, flat
        in (view, row, column) order: {rays_o, rays_d, rgb, depth, valid}."""
        v, h, w, _ = images.shape
        dev = self.device
        poses_t = torch.from_numpy(np.asarray(poses, np.float32)).to(dev)
        rays_o = torch.empty((v * h * w, 3), device=dev)
        rays_d = torch.empty((v * h * w, 3), device=dev)
        for i in range(v):
            o, d = get_rays(poses_t[i], h, w, focal)
            rays_o[i * h * w:(i + 1) * h * w] = o.reshape(-1, 3)
            rays_d[i * h * w:(i + 1) * h * w] = d.reshape(-1, 3)
        n = rays_o.shape[0]
        if depths is not None:
            depth = torch.from_numpy(depths.reshape(-1).astype(np.float32))
            valid = (torch.from_numpy(valid_depths.reshape(-1).astype(bool))
                     if valid_depths is not None else depth > 0)
        else:
            depth, valid = torch.zeros(n), torch.zeros(n, dtype=torch.bool)
        rgb = torch.from_numpy(images.reshape(-1, 3).astype(np.float32))
        return {"rays_o": rays_o, "rays_d": rays_d, "rgb": rgb.to(dev),
                "depth": depth.to(dev), "valid": valid.to(dev)}

    def batch(self, rays, sel: np.ndarray, hw: int):
        """The step's batch of the uploaded rays at host indices `sel`."""
        idx = torch.from_numpy(sel).to(self.device, non_blocking=True)
        return (rays["rays_o"][idx], rays["rays_d"][idx], rays["rgb"][idx], rays["depth"][idx],
                rays["valid"][idx], torch.div(idx, hw, rounding_mode="floor"))

    def step_generator(self, seed: int, step: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(stream_seed(seed, step, 0))
        return gen

    def fit(self, images: np.ndarray, poses: np.ndarray, focal: float, steps: int = 2000,
            seed: int = 0, log_every: int = 200, depths: Optional[np.ndarray] = None,
            valid_depths: Optional[np.ndarray] = None):
        """Train on random ray batches of images [V, H, W, 3] in [0, 1] seen
        from camera-to-world poses [V, 4, 4]; depths [V, H, W] metric.
        Returns (params, final train PSNR); `self.history` holds (step,
        loss, img_loss) every log_every steps."""
        v, h, w, _ = images.shape
        rays = self.upload_rays(images, poses, focal, depths, valid_depths)
        params, opt = self.init(seed, n_views=v)
        rs = np.random.RandomState(seed)
        n = v * h * w
        self.history = []
        img_loss = None
        for step in range(1, steps + 1):
            sel = rs.randint(0, n, self.ray_batch)
            params, opt, loss, img_loss = self.train_step(
                params, opt, *self.batch(rays, sel, h * w),
                generator=self.step_generator(seed, step))
            if step % log_every == 0:
                loss_f, img_f = float(loss), float(img_loss)
                self.history.append((step, loss_f, img_f))
                logger.info("nerf step %d/%d loss %.5f psnr %.2f", step, steps, loss_f,
                            -10 * np.log10(max(img_f, 1e-10)))
        final = float(img_loss) if img_loss is not None else np.inf
        return params, -10 * np.log10(max(final, 1e-10))
