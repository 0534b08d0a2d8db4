"""Per-scene NeRF training and rgbsigma grid extraction, the L0 data
production (counterpart of nerf_mae_tpu/nerf/)."""

from nerf_mae_torch.nerf.model import NeRFMLP
from nerf_mae_torch.nerf.render import (
    depth_and_std,
    depth_nll_loss,
    get_rays,
    render_rays,
    render_rays_depth_guided,
    render_rays_hierarchical,
    sample_3sigma,
    sample_pdf,
)
from nerf_mae_torch.nerf.train import NeRFTrainer
from nerf_mae_torch.nerf.extract import extract_rgbsigma_grid

__all__ = [
    "NeRFMLP",
    "get_rays",
    "render_rays",
    "render_rays_depth_guided",
    "render_rays_hierarchical",
    "sample_3sigma",
    "sample_pdf",
    "depth_and_std",
    "depth_nll_loss",
    "NeRFTrainer",
    "extract_rgbsigma_grid",
]
