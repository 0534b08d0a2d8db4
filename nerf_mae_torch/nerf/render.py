"""Ray generation and volume rendering (counterpart of
nerf_mae_tpu/nerf/render.py), batched static-shape tensor code.

(reference: data/scannet/run_nerf.py:664-1180.) `model_apply(params, pts
[N, S, 3], viewdir [N, 1, 3]) -> (rgb_logits, sigma_raw)` evaluates the
field. Random draws come from a `torch.Generator`, or are passed in as `u`
(uniform [0, 1) tensors of the shapes noted at each function), which is how
the tests feed the JAX package's draws through both. Evenly spaced depths
come from torch.linspace, which can differ from jnp.linspace in the last
ulp.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

Draws = Optional[Tuple[torch.Tensor, torch.Tensor]]


def _uniform(generator: Optional[torch.Generator], shape, device) -> Optional[torch.Tensor]:
    if generator is None:
        return None
    return torch.rand(shape, generator=generator, device=device)


def get_rays(pose: torch.Tensor, h: int, w: int,
             focal: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(origins [H, W, 3], directions [H, W, 3]) in world space of a
    camera-to-world pose [4, 4] (OpenGL: the camera looks down -z)."""
    pose = torch.as_tensor(pose, dtype=torch.float32)
    dev = pose.device
    j, i = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                          torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    focal = float(focal)
    dirs = torch.stack([(i - w * 0.5 + 0.5) / focal, -(j - h * 0.5 + 0.5) / focal,
                        -torch.ones_like(i)], dim=-1)
    rays_d = dirs @ pose[:3, :3].T
    rays_o = pose[:3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def _composite(t: torch.Tensor, rgb_logits: torch.Tensor, sigma_raw: torch.Tensor,
               rays_d: torch.Tensor, white_bkgd: bool):
    """Alpha compositing of sorted samples t [N, S] (raw2outputs,
    reference: data/scannet/run_nerf.py:664-706)."""
    n = t.shape[0]
    delta = torch.diff(t, dim=1)
    delta = torch.cat([delta, delta.new_full((n, 1), 1e10)], dim=1)
    delta = delta * torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-torch.relu(sigma_raw) * delta)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=1)
    trans = torch.cat([trans.new_ones((n, 1)), trans[:, :-1]], dim=1)
    weights = alpha * trans  # [N, S]
    rgb = torch.sigmoid(rgb_logits)
    comp_rgb = (weights[..., None] * rgb).sum(dim=1)
    depth = (weights * t).sum(dim=1)
    acc = weights.sum(dim=1)
    if white_bkgd:
        comp_rgb = comp_rgb + (1.0 - acc[..., None])
    return {"rgb": comp_rgb, "depth": depth, "acc": acc, "weights": weights, "z_vals": t}


def _stratified(near: float, far: float, n: int, n_samples: int,
                u: Optional[torch.Tensor], device) -> torch.Tensor:
    """Depths [N, n_samples]: evenly spaced, jittered within their strata by
    u [N, n_samples] when given."""
    t = torch.linspace(near, far, n_samples, device=device).expand(n, n_samples)
    if u is not None:
        mids = (t[:, 1:] + t[:, :-1]) / 2
        lo = torch.cat([t[:, :1], mids], dim=1)
        hi = torch.cat([mids, t[:, -1:]], dim=1)
        t = lo + u * (hi - lo)
    return t


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               generator: Optional[torch.Generator] = None, *,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-CDF sampling of n_samples per ray from the piecewise-constant
    pdf of weights [N, B] over ascending bin edges [N, B+1] (reference: the
    dense-depth-priors sample_pdf, data/scannet/run_nerf.py:950-957). Draws:
    u [N, n_samples], else the generator's, else the strata's midpoints."""
    n, b = weights.shape
    weights = weights + 1e-5
    pdf = weights / weights.sum(dim=1, keepdim=True)
    cdf = torch.cat([pdf.new_zeros((n, 1)), torch.cumsum(pdf, dim=1)], dim=1)  # [N, B+1]
    if u is None:
        u = _uniform(generator, (n, n_samples), weights.device)
    if u is None:
        u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                           device=weights.device).expand(n, n_samples)
    u = u.contiguous()
    idx = torch.searchsorted(cdf.contiguous(), u, right=True)
    lo = torch.clamp(idx - 1, 0, b)
    hi = torch.clamp(idx, 0, b)
    cdf_lo, cdf_hi = torch.gather(cdf, 1, lo), torch.gather(cdf, 1, hi)
    bin_lo, bin_hi = torch.gather(bins, 1, lo), torch.gather(bins, 1, hi)
    gap = cdf_hi - cdf_lo
    denom = torch.where(gap < 1e-5, torch.ones_like(gap), gap)
    frac = (u - cdf_lo) / denom
    return bin_lo + frac * (bin_hi - bin_lo)


def render_rays(params, model_apply, rays_o: torch.Tensor, rays_d: torch.Tensor,
                near: float, far: float, n_samples: int = 64,
                generator: Optional[torch.Generator] = None, white_bkgd: bool = False, *,
                u: Optional[torch.Tensor] = None):
    """Single-level stratified volume rendering of rays [N, 3]; u [N,
    n_samples] jitters the samples. {rgb [N, 3], depth [N], acc [N],
    weights, z_vals}."""
    n = rays_o.shape[0]
    if u is None:
        u = _uniform(generator, (n, n_samples), rays_o.device)
    t = _stratified(near, far, n, n_samples, u, rays_o.device)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]  # [N, S, 3]
    viewdir = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    rgb_logits, sigma_raw = model_apply(params, pts, viewdir[:, None, :])
    return _composite(t, rgb_logits, sigma_raw, rays_d, white_bkgd)


def render_rays_hierarchical(params_coarse, params_fine, model_apply, rays_o: torch.Tensor,
                             rays_d: torch.Tensor, near: float, far: float,
                             n_coarse: int = 64, n_importance: int = 64,
                             generator: Optional[torch.Generator] = None,
                             white_bkgd: bool = False, *, u: Draws = None):
    """Two-level rendering (reference: data/scannet/run_nerf.py:939-981): the
    fine samples come from the coarse weights' pdf over the depth midpoints,
    merged and sorted with the coarse ones and evaluated by the fine
    network. The fine outputs plus rgb0 / depth0 / acc0 of the coarse pass.
    u = (coarse jitter [N, n_coarse], pdf draws [N, n_importance])."""
    n, dev = rays_o.shape[0], rays_o.device
    if u is None:
        u = (_uniform(generator, (n, n_coarse), dev), _uniform(generator, (n, n_importance), dev))
    u_c, u_f = u
    t = _stratified(near, far, n, n_coarse, u_c, dev)
    viewdir = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
    rgb_logits, sigma_raw = model_apply(params_coarse, pts, viewdir[:, None, :])
    coarse = _composite(t, rgb_logits, sigma_raw, rays_d, white_bkgd)

    t_mid = 0.5 * (t[:, 1:] + t[:, :-1])
    t_fine = sample_pdf(t_mid, coarse["weights"][:, 1:-1].detach(), n_importance, u=u_f)
    t_all = torch.sort(torch.cat([t, t_fine.detach()], dim=1), dim=1).values
    pts = rays_o[:, None, :] + rays_d[:, None, :] * t_all[..., None]
    rgb_logits, sigma_raw = model_apply(params_fine, pts, viewdir[:, None, :])
    out = _composite(t_all, rgb_logits, sigma_raw, rays_d, white_bkgd)
    out["rgb0"] = coarse["rgb"]
    out["depth0"] = coarse["depth"]
    out["acc0"] = coarse["acc"]
    return out


def sample_3sigma(low: torch.Tensor, high: torch.Tensor, n_samples: int, near: float,
                  far: float, generator: Optional[torch.Generator] = None, *,
                  u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Samples [N, n_samples] from a truncated Gaussian whose +-3 sigma is
    [low, high] [N], clamped to [near, far] (reference:
    data/scannet/run_nerf.py:708-719). u [N, n_samples]."""
    dev = low.device
    t_vals = torch.linspace(0.0, 1.0, n_samples, device=dev)
    step = (high - low) / (n_samples - 1)
    edges = torch.clamp(low[:, None] * (1.0 - t_vals) + high[:, None] * t_vals, near, far)
    factor = torch.diff(edges, dim=1) / torch.clamp(step[:, None], min=1e-10)
    x = torch.linspace(-3.0, 3.0, n_samples - 1, device=dev)
    gauss = torch.exp(-0.5 * x ** 2) / torch.sqrt(
        torch.tensor(2.0 * math.pi, dtype=torch.float32, device=dev))
    return sample_pdf(edges, factor * gauss, n_samples, generator, u=u)


def depth_and_std(t: torch.Tensor, weights: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expected depth and std of a ray's weights (reference:
    data/scannet/run_nerf.py:664-668)."""
    depth = (weights * t).sum(dim=1)
    var = ((t - depth[:, None]) ** 2 * weights).sum(dim=1)
    return depth, torch.sqrt(torch.clamp(var, min=0.0))


def render_rays_depth_guided(params, model_apply, rays_o: torch.Tensor, rays_d: torch.Tensor,
                             near: float, far: float, target_depth: torch.Tensor,
                             depth_low: torch.Tensor, depth_high: torch.Tensor,
                             valid_depth: torch.Tensor, n_samples: int = 64,
                             generator: Optional[torch.Generator] = None,
                             white_bkgd: bool = False, *, u: Draws = None):
    """Depth-guided two-pass sampling (reference:
    data/scannet/run_nerf.py:741-902): half the samples along the whole
    ray, half in a 3-sigma band around the sensor depth where it is valid,
    else around pass 1's predicted depth (std floored at its spacing); both
    sets merged by a stable sort and composited together. The guide
    samples carry no gradient. u = (pass-1 jitter [N, n/2], band draws
    [N, n/2])."""
    n, dev = rays_o.shape[0], rays_o.device
    half = n_samples // 2
    if u is None:
        u = (_uniform(generator, (n, half), dev), _uniform(generator, (n, half), dev))
    u_a, u_b = u

    t1 = _stratified(near, far, n, half, u_a, dev)
    viewdir = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * t1[..., None]
    rgb1, sig1 = model_apply(params, pts, viewdir[:, None, :])
    coarse = _composite(t1, rgb1, sig1, rays_d, white_bkgd)

    with torch.no_grad():  # the band (reference :758-760) carries no gradient
        pred_depth, pred_std = depth_and_std(t1, coarse["weights"])
        pred_std = torch.clamp(pred_std, min=(far - near) / max(half - 1, 1))
        lo = torch.where(valid_depth, depth_low, pred_depth - 3.0 * pred_std)
        hi = torch.where(valid_depth, depth_high, pred_depth + 3.0 * pred_std)
        t2 = sample_3sigma(lo, hi, half, near, far, u=u_b)

    pts2 = rays_o[:, None, :] + rays_d[:, None, :] * t2[..., None]
    rgb2, sig2 = model_apply(params, pts2, viewdir[:, None, :])

    t_all = torch.cat([t1, t2], dim=1)
    order = torch.argsort(t_all, dim=1, stable=True)
    t_all = torch.gather(t_all, 1, order)
    rgb = torch.gather(torch.cat([rgb1, rgb2], dim=1), 1, order[..., None].expand(-1, -1, 3))
    sig = torch.gather(torch.cat([sig1, sig2], dim=1), 1, order)
    out = _composite(t_all, rgb, sig, rays_d, white_bkgd)
    out["depth0"] = coarse["depth"]
    out["acc0"] = coarse["acc"]
    return out


def depth_nll_loss(depth: torch.Tensor, z_vals: torch.Tensor, weights: torch.Tensor,
                   target_depth: torch.Tensor, valid_depth: torch.Tensor,
                   eps: float = 1e-3) -> torch.Tensor:
    """Gaussian NLL of the sensor depth under the ray's weight distribution,
    over the valid rays (reference: data/scannet/run_nerf.py:1316-1324)."""
    var = ((z_vals - depth[:, None]) ** 2 * weights).sum(dim=1)
    var = torch.clamp(var, min=eps)
    nll = 0.5 * (torch.log(var) + (depth - target_depth) ** 2 / var)
    m = valid_depth.to(torch.float32)
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
