"""Typed configuration of the PyTorch port (counterpart of nerf_mae_tpu/config.py).

Same dataclasses, presets, defaults and validation as the JAX package;
`dtype` is a `torch.dtype`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

_ATTENTION_IMPLS = ("auto", "kernel", "plain")
_GELUS = ("tanh", "erf")


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    """3D Swin transformer trunk configuration.

    Named presets mirror the reference's swin_t/s/b/l dicts
    (reference: nerf_mae/run_swin_mae3d.py:378-399).
    """

    embed_dim: int = 96
    depths: Sequence[int] = (2, 2, 18, 2)
    num_heads: Sequence[int] = (3, 6, 12, 24)
    patch_size: Sequence[int] = (4, 4, 4)
    window_size: Sequence[int] = (4, 4, 4)
    mlp_ratio: float = 4.0
    stochastic_depth_prob: float = 0.1
    expand_dim: bool = True
    norm_eps: float = 1e-5
    # Read by kernels.wanted for every layer with a kernel (the Swin blocks,
    # the res blocks' fused norms). "auto": the hand-written CUDA kernels on
    # CUDA tensors, the plain composition on CPU tensors; "kernel" forces the
    # kernel wrappers (whose CPU branch is the kernel's plain version);
    # "plain" forces the plain composition everywhere.
    attention_impl: str = "auto"
    # MLP activation: "tanh" (tanh-approximated gelu, what the fused block
    # kernel implements) or "erf" (exact, torch nn.GELU parity; routes the
    # kernel stages through the fused window-attention kernel instead).
    gelu: str = "tanh"

    def __post_init__(self):
        if self.attention_impl not in _ATTENTION_IMPLS:
            raise ValueError(
                f"attention_impl {self.attention_impl!r} not in {_ATTENTION_IMPLS}"
            )
        if self.gelu not in _GELUS:
            raise ValueError(f"gelu {self.gelu!r} not in {_GELUS}")
        for dim, heads in zip(self.stage_dims, self.num_heads):
            if dim % heads:
                raise ValueError(
                    f"stage dim {dim} not divisible by num_heads {heads}"
                )

    @property
    def stage_dims(self) -> tuple:
        if self.expand_dim:
            return tuple(self.embed_dim * 2**i for i in range(len(self.depths)))
        return tuple(self.embed_dim for _ in self.depths)


SWIN_PRESETS = {
    # test-scale preset for CPU smoke runs (not in the reference)
    "swin_nano": SwinConfig(
        embed_dim=12, depths=(1, 1, 2, 1), num_heads=(3, 6, 12, 24),
        stochastic_depth_prob=0.0,
    ),
    "swin_t": SwinConfig(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24)),
    "swin_s": SwinConfig(embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24)),
    # NOTE: the reference's swin_b dict pairs embed_dim 128 with heads
    # (3, 6, 12, 24) (run_swin_mae3d.py:389-393), which is unusable: 128 is
    # not divisible by 3. The standard Swin-B head counts are used instead.
    "swin_b": SwinConfig(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32)),
    "swin_l": SwinConfig(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48)),
}


@dataclasses.dataclass(frozen=True)
class MAEConfig:
    """Masked-autoencoder model config.

    Mirrors SwinTransformer_MAE3D_New construction
    (reference: nerf_mae/model/mae/swin_mae3d.py:1088-1304).
    """

    swin: SwinConfig = SWIN_PRESETS["swin_s"]
    resolution: int = 160
    input_channels: int = 4
    out_channels: int = 4
    masking_prob: float = 0.75
    masking_strategy: str = "random"  # "random" | "grid"
    # Mask-block edge in tokens; the reference masks 4^3 token blocks.
    mask_block: int = 4
    # False reproduces the reference's one-mask-per-batch quirk.
    per_sample_mask: bool = True
    compute_dtype: str = "bfloat16"  # dtype of matmuls/convs; params stay fp32
    # torch.utils.checkpoint on each Swin block of the stages that remat, in
    # training; blocks that run the fused block kernel never remat (its
    # forward keeps the rows its backward reads).
    remat: bool = True
    # checkpoint the UNETR decoder blocks and the subpixel head too
    decoder_remat: bool = False
    # "nothing" recomputes everything; "dots" keeps the matmul and
    # convolution outputs (less recompute, more memory)
    remat_policy: str = "nothing"
    # per-stage override of `remat` (one bool per stage), or None = `remat`
    # everywhere; the late stages' activations are small
    remat_stages: Optional[Tuple[bool, ...]] = (True, True, False, False)
    # "subpixel": res-block + projection at the token grid, then
    # depth-to-space; "unetr": the reference's ConvTranspose(4x) + full-res
    # res-block, for architecture-parity runs.
    decoder_type: str = "subpixel"

    def __post_init__(self):
        # Every UNETR skip level halves the token grid, so the resolution must
        # be divisible by patch * 2^(n_stages - 1).
        div = self.swin.patch_size[0] * 2 ** (len(self.swin.depths) - 1)
        if self.resolution % div:
            raise ValueError(
                f"resolution {self.resolution} must be a multiple of {div} "
                f"(patch {self.swin.patch_size[0]} x 2^{len(self.swin.depths) - 1} "
                f"patch-merging levels) for UNETR skip alignment"
            )
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"compute_dtype {self.compute_dtype!r} unsupported")
        if self.decoder_type not in ("subpixel", "unetr"):
            raise ValueError(f"decoder_type {self.decoder_type!r} unsupported")
        if self.remat_policy not in ("nothing", "dots"):
            raise ValueError(f"remat_policy {self.remat_policy!r} unsupported")

    @property
    def token_grid(self) -> int:
        return self.resolution // self.swin.patch_size[0]

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization config (reference: nerf_mae/train_mae3d.sh:16-35,
    run_swin_mae3d.py AdamW+OneCycleLR setup)."""

    batch_size: int = 32
    num_epochs: int = 2000
    lr: float = 1e-4
    weight_decay: float = 1e-3
    clip_grad_norm: float = 0.1
    # Zero (do not apply) the gradients of a step whose norm is nan/inf
    # instead of letting the nan reach every parameter through the clip.
    skip_nonfinite_updates: bool = True
    # torch OneCycleLR (anneal_strategy="cos") defaults
    onecycle_pct_start: float = 0.3
    onecycle_div_factor: float = 25.0
    onecycle_final_div_factor: float = 1e4
    seed: int = 0
    log_interval: int = 10
    eval_interval: int = 10
    ckpt_interval: int = 20
    ckpt_dir: str = "checkpoints"
    keep_checkpoints: int = 3
