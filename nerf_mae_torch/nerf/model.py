"""The per-scene NeRF radiance field MLP (counterpart of
nerf_mae_tpu/nerf/model.py): frequency-encoded position, 8x256 with a skip,
a density head and a view-conditioned colour head.

(reference: data/scannet/run_nerf.py:546-1180, the dense-depth-prior NeRF's
standard core.) Layer names and shapes are the flax module's (`fc0` ..
`fc{depth-1}`, `sigma`, `feat`, `color_fc`, `rgb`), so a flax tree maps onto
the state dict by transposing each kernel (convert.nerf_params_from_jax).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn


def positional_encoding(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """[..., D] -> [..., D * 2 * n_freqs]: sin and cos at octave
    frequencies, frequency-major ([sin f0 x, cos f0 x, sin f1 x, ...])."""
    freqs = 2.0 ** torch.arange(n_freqs, dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * freqs[:, None]  # [..., F, D]
    enc = torch.cat([torch.sin(xb), torch.cos(xb)], dim=-1)
    return enc.reshape(*x.shape[:-1], -1)


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's default Dense kernel init (lecun_normal: a normal truncated at
    two standard deviations, scaled to variance 1 / fan_in)."""
    std = math.sqrt(1.0 / weight.shape[1]) / 0.87962566103423978
    return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)


class NeRFMLP(nn.Module):
    """(rgb_logits [..., 3] before the sigmoid, sigma_raw [...] before the
    ReLU) of normalised positions [..., 3] and unit view directions [..., 3].
    cam_embed_dim > 0 conditions the colour head on a per-image latent too
    (reference: data/scannet/run_nerf.py:298-359); without one it is zero."""

    def __init__(self, depth: int = 8, width: int = 256, skip_at: int = 4,
                 pos_freqs: int = 10, dir_freqs: int = 4, cam_embed_dim: int = 0):
        super().__init__()
        self.hparams = dict(depth=depth, width=width, skip_at=skip_at, pos_freqs=pos_freqs,
                            dir_freqs=dir_freqs, cam_embed_dim=cam_embed_dim)
        self.depth, self.width, self.skip_at = depth, width, skip_at
        self.pos_freqs, self.dir_freqs, self.cam_embed_dim = pos_freqs, dir_freqs, cam_embed_dim
        enc = 6 * pos_freqs
        d_in = enc
        for i in range(depth):
            self.add_module(f"fc{i}", nn.Linear(d_in, width))
            d_in = width + enc if i == skip_at else width
        self.sigma = nn.Linear(d_in, 1)
        self.feat = nn.Linear(d_in, width)
        self.color_fc = nn.Linear(width + 6 * dir_freqs + cam_embed_dim, width // 2)
        self.rgb = nn.Linear(width // 2, 3)

    def reset_parameters(self, generator: torch.Generator) -> "NeRFMLP":
        """lecun_normal kernels and zero biases, drawn in layer order."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    lecun_normal_(m.weight, generator)
                    m.bias.zero_()
        return self

    def trunk(self, xyz: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The view-independent part: (sigma_raw [...], feat [..., width])."""
        h = enc = positional_encoding(xyz, self.pos_freqs)
        for i in range(self.depth):
            h = torch.relu(getattr(self, f"fc{i}")(h))
            if i == self.skip_at:
                h = torch.cat([h, enc], dim=-1)
        return self.sigma(h)[..., 0], self.feat(h)

    def color(self, feat: torch.Tensor, viewdir: torch.Tensor,
              cam_embed: Optional[torch.Tensor] = None) -> torch.Tensor:
        """rgb_logits of the colour head's input [feat, dir_enc, cam]."""
        lead = feat.shape[:-1]
        d = positional_encoding(viewdir, self.dir_freqs)
        color_in = [feat, d.expand(*lead, d.shape[-1])]
        if self.cam_embed_dim:
            ce = cam_embed if cam_embed is not None else feat.new_zeros(self.cam_embed_dim)
            color_in.append(ce.expand(*lead, self.cam_embed_dim))
        return self.rgb(torch.relu(self.color_fc(torch.cat(color_in, dim=-1))))

    def forward(self, xyz: torch.Tensor, viewdir: torch.Tensor,
                cam_embed: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        sigma, feat = self.trunk(xyz)
        return self.color(feat, viewdir, cam_embed), sigma
