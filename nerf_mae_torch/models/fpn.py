"""3D feature pyramid neck, channel-last (counterpart of
nerf_mae_tpu/models/fpn.py).

The reference FPN (reference: nerf_rpn/model/fpn.py:8-185): lateral 1x1
convs, nearest-neighbour top-down adds, 3^3 smoothing convs, and optional
extra levels (stride-2 3^3 convs, or a stride-2 subsample). Parameters are
named `lateral{i}`, `smooth{i}`, `extra{i}` after the JAX modules.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from nerf_mae_torch.models.unetr import Conv3d


def nearest_upsample_3d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """[B, W, L, H, C] nearest-neighbour upsample by an integer factor."""
    b, w, l, h, c = x.shape
    x = x[:, :, None, :, None, :, None, :].expand(b, w, factor, l, factor, h, factor, c)
    return x.reshape(b, w * factor, l * factor, h * factor, c)


class FPN3D(nn.Module):
    """Features [B, Si, Si, Si, Ci] (finest first) -> `num_outs` levels of
    `out_channels` in the compute dtype."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 4, extra_convs: bool = False,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.dtype, self.num_outs, self.extra_convs = dtype, num_outs, extra_convs
        n_in = len(in_channels)
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral{i}", Conv3d(c, out_channels, 1, device=device))
            self.add_module(f"smooth{i}", Conv3d(out_channels, out_channels, 3, device=device))
        if extra_convs:
            for i in range(n_in, num_outs):
                self.add_module(f"extra{i}", Conv3d(out_channels, out_channels, 3,
                                                    device=device))
        self.n_in = n_in

    def forward(self, features: List[torch.Tensor]) -> List[torch.Tensor]:
        dt = self.dtype
        laterals = [getattr(self, f"lateral{i}")(f.to(dt), dt) for i, f in enumerate(features)]
        for i in range(self.n_in - 1, 0, -1):
            up = nearest_upsample_3d(laterals[i], laterals[i - 1].shape[1] // laterals[i].shape[1])
            laterals[i - 1] = laterals[i - 1] + up
        outs = [getattr(self, f"smooth{i}")(laterals[i], dt) for i in range(self.n_in)]
        for i in range(self.n_in, self.num_outs):
            if self.extra_convs:
                outs.append(getattr(self, f"extra{i}")(outs[-1], dt, stride=2))
            else:  # flax max_pool over a 1^3 window at stride 2
                outs.append(outs[-1][:, ::2, ::2, ::2])
        return outs
