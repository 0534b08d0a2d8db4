"""Detection backbones, channel-last (counterpart of
nerf_mae_tpu/models/backbones.py): Swin-FPN (from scratch or from a
pretrained MAE trunk), ResNet-FPN and VGG-FPN.

(reference: nerf_rpn/model/feature_extractor.py:107-1290)

  * SwinFPN: the MAE's trunk (patch embed, float32 LayerNorm, sincos
    position embedding, SwinEncoder3D) and FPN3D. Its parameters carry the
    MAE's names, `patch_partition.*` and `stages.*`, so a MAE state dict
    grafts by prefix (train/checkpoint.py extract_trunk / load_trunk_into);
    the stages run the fused Swin-block kernels as in the MAE.
  * ResNetFPN: stride-4 7^3 stem and four GroupNorm bottleneck stages.
  * VGGFPN: conv-GN-ReLU chains with 2^3 max pools (configs AF / EF).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from nerf_mae_torch.config import SwinConfig
from nerf_mae_torch.models.fpn import FPN3D
from nerf_mae_torch.models.mae import init_weights as init_trunk_weights
from nerf_mae_torch.models.mae import patch_embed, pos_embed_tensor
from nerf_mae_torch.models.swin import Norm, SwinEncoder3D, flax_layer_norm
from nerf_mae_torch.models.unetr import Conv3d, group_norm


class SwinFPN(nn.Module):
    """grids [B, R, R, R, 4] -> FPN levels [B, R/4/2^i, ..., out_channels]."""

    def __init__(self, swin: SwinConfig, input_channels: int = 4, out_channels: int = 256,
                 dtype: torch.dtype = torch.bfloat16, remat: bool = True, device=None):
        super().__init__()
        self.swin, self.dtype = swin, dtype
        self.patch_partition = nn.ModuleDict({
            "0": Conv3d(input_channels, swin.embed_dim, swin.patch_size[0], device=device),
            "2": Norm(swin.embed_dim, device=device),
        })
        self.stages = SwinEncoder3D(swin, dtype=dtype, device=device,
                                    remat_stages=(remat,) * len(swin.depths))
        self.fpn = FPN3D(swin.stage_dims, out_channels, num_outs=len(swin.depths),
                         dtype=dtype, device=device)

    def forward(self, grids: torch.Tensor, deterministic: bool = True,
                droppath_generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        conv, norm = self.patch_partition["0"], self.patch_partition["2"]
        x = patch_embed(grids, conv.weight, conv.bias, self.dtype)
        x = flax_layer_norm(x, norm.weight, norm.bias, self.swin.norm_eps).to(self.dtype)
        x = x + pos_embed_tensor(self.swin.embed_dim, x.shape[1], x.device, self.dtype)
        return self.fpn(self.stages(x, deterministic, droppath_generator))


class _Bottleneck(nn.Module):
    """1x1 -> 3^3 (stride) -> 1x1 residual bottleneck with GroupNorm(32)
    (the reference uses BatchNorm, feature_extractor.py:62-105)."""

    def __init__(self, in_ch: int, channels: int, stride: int = 1, expansion: int = 4,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        out_ch = channels * expansion
        self.channels, self.stride, self.dtype = channels, stride, dtype
        self.conv1 = Conv3d(in_ch, channels, 1, device=device)
        self.n1 = Norm(channels, device=device)
        self.conv2 = Conv3d(channels, channels, 3, device=device)
        self.n2 = Norm(channels, device=device)
        self.conv3 = Conv3d(channels, out_ch, 1, device=device)
        self.n3 = Norm(out_ch, device=device)
        self.has_proj = in_ch != out_ch or stride != 1
        if self.has_proj:
            self.proj = Conv3d(in_ch, out_ch, 1, device=device)
            self.np = Norm(out_ch, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g, dt = min(32, self.channels), self.dtype
        h = F.relu(group_norm(self.conv1(x, dt), self.n1.weight, self.n1.bias, g))
        h = F.relu(group_norm(self.conv2(h, dt, stride=self.stride),
                              self.n2.weight, self.n2.bias, g))
        h = group_norm(self.conv3(h, dt), self.n3.weight, self.n3.bias, 32)
        if self.has_proj:
            x = group_norm(self.proj(x, dt, stride=self.stride), self.np.weight, self.np.bias, 32)
        return F.relu(h + x)


class ResNetFPN(nn.Module):
    """ResNet-FPN backbone (reference: feature_extractor.py:107-301,
    ResNet_FPN_64/256): a stride-4 stem, 4 bottleneck stages at strides
    4, 8, 16, 32, FPN on top."""

    def __init__(self, base_channels: int = 64, blocks_per_stage: Sequence[int] = (2, 2, 2, 2),
                 input_channels: int = 4, out_channels: int = 256,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.dtype, self.blocks_per_stage = dtype, tuple(blocks_per_stage)
        self.stem = Conv3d(input_channels, base_channels, 7, device=device)
        self.stem_norm = Norm(base_channels, device=device)
        ch, in_ch, widths = base_channels, base_channels, []
        for i, n_blocks in enumerate(self.blocks_per_stage):
            for j in range(n_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                self.add_module(f"stage{i}_block{j}",
                                _Bottleneck(in_ch, ch, stride, dtype=dtype, device=device))
                in_ch = ch * 4
            widths.append(in_ch)
            ch *= 2
        self.fpn = FPN3D(widths, out_channels, num_outs=len(widths), dtype=dtype, device=device)

    def forward(self, grids: torch.Tensor, deterministic: bool = True,
                droppath_generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        x = self.stem(grids, self.dtype, stride=4)
        x = F.relu(group_norm(x, self.stem_norm.weight, self.stem_norm.bias, 32))
        feats = []
        for i, n_blocks in enumerate(self.blocks_per_stage):
            for j in range(n_blocks):
                x = getattr(self, f"stage{i}_block{j}")(x)
            feats.append(x)
        return self.fpn(feats)


_VGG_CFGS = {
    # channels per stage, convs per stage
    "AF": ((64, 128, 256, 512, 512), (1, 1, 2, 2, 2)),
    "EF": ((64, 128, 256, 512, 512), (2, 2, 4, 4, 4)),
}


class VGGFPN(nn.Module):
    """VGG-style conv backbone + FPN (reference: feature_extractor.py:
    345-549, configs AF (shallow) / EF (deep)): conv-GN-ReLU chains with
    2^3 max pools; the features after every pool but the first (strides 4,
    8, 16, 32)."""

    def __init__(self, config: str = "AF", input_channels: int = 4, out_channels: int = 256,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.chans, self.convs = _VGG_CFGS[config]
        in_ch = input_channels
        for i, (ch, n) in enumerate(zip(self.chans, self.convs)):
            for j in range(n):
                self.add_module(f"stage{i}_conv{j}", Conv3d(in_ch, ch, 3, device=device))
                self.add_module(f"stage{i}_norm{j}", Norm(ch, device=device))
                in_ch = ch
        self.fpn = FPN3D(self.chans[1:], out_channels, num_outs=len(self.chans) - 1,
                         dtype=dtype, device=device)

    def forward(self, grids: torch.Tensor, deterministic: bool = True,
                droppath_generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        x, feats = grids, []
        for i, (ch, n) in enumerate(zip(self.chans, self.convs)):
            for j in range(n):
                norm = getattr(self, f"stage{i}_norm{j}")
                x = getattr(self, f"stage{i}_conv{j}")(x, self.dtype)
                x = F.relu(group_norm(x, norm.weight, norm.bias, min(32, ch)))
            # flax max_pool, 2^3 window, stride 2, VALID
            x = F.max_pool3d(x.permute(0, 4, 1, 2, 3), 2, 2).permute(0, 2, 3, 4, 1)
            if i >= 1:
                feats.append(x)
        return self.fpn(feats)


def make_body(backbone: str, swin: SwinConfig, out_channels: int = 256,
              dtype: torch.dtype = torch.bfloat16, remat: bool = True, device=None) -> nn.Module:
    """"swin_t/s/b/l/nano" (SwinFPN, graftable from a MAE), "resnet",
    "vgg_AF" or "vgg_EF"."""
    if backbone.startswith("swin"):
        return SwinFPN(swin, out_channels=out_channels, dtype=dtype, remat=remat, device=device)
    if backbone == "resnet":
        return ResNetFPN(out_channels=out_channels, dtype=dtype, device=device)
    if backbone.startswith("vgg"):
        return VGGFPN(backbone.split("_")[1], out_channels=out_channels, dtype=dtype,
                      device=device)
    raise ValueError(f"unknown backbone {backbone}")


@torch.no_grad()
def init_body(body: nn.Module, seed: int) -> torch.Generator:
    """Random weights of a detection body from `seed`: a Swin trunk as
    models.mae.init_weights makes it, xavier-uniform FPN kernels, fan-in
    normal kernels in the ResNet / VGG bodies, GroupNorm ones / zeros, zero
    biases. Returns the generator, seeded by `seed` and advanced past the
    body's draws, for the head's initializers."""
    dev = next(body.parameters()).device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if isinstance(body, SwinFPN):
        init_trunk_weights(body, seed)
    for name, p in body.named_parameters():
        if name.startswith(("patch_partition.", "stages.")):
            continue
        if name.startswith("fpn.") and p.ndim == 5:
            fan_in, fan_out = p[0].numel(), p[:, 0].numel()
            lim = (6.0 / (fan_in + fan_out)) ** 0.5
            p.uniform_(-lim, lim, generator=gen)
        elif p.ndim == 5:
            p.normal_(0.0, p[0].numel() ** -0.5, generator=gen)
        else:  # GroupNorm scale / bias, conv biases
            is_scale = name.endswith("weight") and p.ndim == 1
            p.fill_(1.0 if is_scale else 0.0)
    return gen
