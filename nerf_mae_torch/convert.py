"""Weight bridge between the JAX package's parameter tree and the port.

The port's parameters carry the reference torch state_dict's names, so
`scripts/convert_torch_checkpoint.py:convert_state_dict` maps a port
state_dict to the JAX tree unchanged. `params_from_jax` is its exact inverse,
plus the subpixel head, which has no reference name and keeps its own
(`subpixel_head.res.conv1.weight`, `subpixel_head.proj.weight`, ...):

  Linear  (I, O)          -> (O, I)
  Conv    (D, H, W, I, O) -> (O, I, D, H, W)
  ConvT   undo the spatial flip, then (D, H, W, I, O) -> (I, O, D, H, W)

`head_params_from_jax` maps the JAX VoxelSR3D / VoxelSemantics3D trees the
same way (`base/...` as the MAE, `encoder1/conv*`, `decoder1/...`,
`voxel_out/conv`, `sem_out/conv`), and `det_params_from_jax`,
`rpn_params_from_jax` and `rcnn_params_from_jax` the FCOS detector, the
anchor RPN and the RCNN stage, and `nerf_params_from_jax` a per-scene
NeRF's {coarse, fine, cam}. `mae_params_to_jax` is the inverse of
`params_from_jax`.

Every leaf mapping is a pure relayout (a transpose or an axis permutation
and flip), one JAX leaf to one port tensor, and `_convert` holds every
mapping to that. So the optax adamw moments, trees shaped like the
parameters, map elementwise through the same family function:
`adamw_state_dict` turns them into a torch.optim.AdamW state dict for any
model family (`adamw_state_from_jax` loads it).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from nerf_mae_torch.config import MAEConfig

# reference buffers that the port computes instead of storing
_DERIVED = re.compile(r"(^pos_embed$|\.relative_position_index$)")


def _lin(w):
    return np.transpose(w, (1, 0))


def _conv(w):
    return np.transpose(w, (4, 3, 0, 1, 2))


def _convT(w):
    return np.transpose(w[::-1, ::-1, ::-1], (3, 4, 0, 1, 2))


# each relayout and its inverse (port layout -> JAX layout)
_RELAYOUTS = {
    _lin: _lin,
    _conv: lambda w: np.transpose(w, (2, 3, 4, 1, 0)),
    _convT: lambda w: np.transpose(w, (2, 3, 4, 0, 1))[::-1, ::-1, ::-1],
}


_BLOCK = {
    "norm1/scale": ("norm1.weight", None), "norm1/bias": ("norm1.bias", None),
    "norm2/scale": ("norm2.weight", None), "norm2/bias": ("norm2.bias", None),
    "qkv_kernel": ("attn.qkv.weight", _lin), "qkv_bias": ("attn.qkv.bias", None),
    "proj_kernel": ("attn.proj.weight", _lin), "proj_bias": ("attn.proj.bias", None),
    "rel_pos_bias_table": ("attn.relative_position_bias_table", None),
    "mlp_fc1/kernel": ("mlp.0.weight", _lin), "mlp_fc1/bias": ("mlp.0.bias", None),
    "mlp_fc2/kernel": ("mlp.3.weight", _lin), "mlp_fc2/bias": ("mlp.3.bias", None),
}
_MERGE = {
    "norm/scale": ("norm.weight", None), "norm/bias": ("norm.bias", None),
    "reduction/kernel": ("reduction.weight", _lin),
}
_TOP = {
    "patch_embed/kernel": ("patch_partition.0.weight", _conv),
    "patch_embed/bias": ("patch_partition.0.bias", None),
    "patch_norm/scale": ("patch_partition.2.weight", None),
    "patch_norm/bias": ("patch_partition.2.bias", None),
    "mask_token": ("mask_token", None),
    "out_head/conv/kernel": ("out.conv.weight", _conv),
    "out_head/conv/bias": ("out.conv.bias", None),
}


def _decoder_leaf(rest: str, res_prefix: str):
    """Leaf of an up block or the subpixel head."""
    if rest == "up/kernel":
        return "transp_conv.weight", _convT
    if rest == "up/bias":
        return "transp_conv.bias", None
    if rest == "proj/kernel":
        return "proj.weight", _conv
    if rest == "proj/bias":
        return "proj.bias", None
    m = re.fullmatch(r"res/(conv\d)/(kernel|bias)", rest)
    if m:
        leaf = "weight" if m.group(2) == "kernel" else "bias"
        return f"{res_prefix}.{m.group(1)}.{leaf}", _conv if leaf == "weight" else None
    raise KeyError(rest)


def _map_key(path: str) -> Tuple[str, Optional[Callable]]:
    if path in _TOP:
        return _TOP[path]
    m = re.fullmatch(r"encoder/stage(\d+)_block(\d+)/(.+)", path)
    if m:
        s, b = int(m.group(1)), int(m.group(2))
        name, fn = _BLOCK[m.group(3)]
        return f"stages.{s}.{b + (1 if s > 0 else 0)}.{name}", fn
    m = re.fullmatch(r"encoder/merge(\d+)/(.+)", path)
    if m:
        name, fn = _MERGE[m.group(2)]
        return f"stages.{m.group(1)}.0.{name}", fn
    m = re.fullmatch(r"(decoder\d)/(.+)", path)
    if m:
        name, fn = _decoder_leaf(m.group(2), "conv_block")
        return f"{m.group(1)}.{name}", fn
    m = re.fullmatch(r"subpixel_head/(.+)", path)
    if m:
        name, fn = _decoder_leaf(m.group(1), "res")
        return f"subpixel_head.{name}", fn
    raise KeyError(path)


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested flax tree -> {"a/b/c": array}; a flat dict passes through."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(flatten_tree(v, key + "/"))
        else:
            flat[key] = np.asarray(v)
    return flat


def expected_keys(cfg: MAEConfig) -> set:
    """The port's state_dict keys for `cfg` (built on the meta device)."""
    from nerf_mae_torch.models.mae import SwinMAE3D

    return set(SwinMAE3D(cfg, device="meta").state_dict().keys())


def _convert(tree_or_flat: Mapping, map_key, want: set) -> Dict[str, torch.Tensor]:
    """Map every leaf; raises on an unknown leaf, a missing or unexpected
    port key, and on a mapping that is not a pure relayout of one leaf
    (which could not carry the optimizer's moments)."""
    flat = flatten_tree(tree_or_flat)
    sd = {}
    for path, value in flat.items():
        path = path[len("params/"):] if path.startswith("params/") else path
        try:
            name, fn = map_key(path)
        except KeyError:
            raise KeyError(f"unknown JAX parameter {path!r}") from None
        if fn is not None and fn not in _RELAYOUTS:
            raise ValueError(f"{path!r} -> {name!r} is not a relayout")
        if name in sd:
            raise ValueError(f"two JAX leaves map to {name!r} (the second: {path!r})")
        value = np.asarray(value, np.float32)
        # C order: np.array would keep a relayout's strides, and the AdamW
        # step takes a slower path on moments laid out unlike their parameter
        sd[name] = torch.from_numpy(np.ascontiguousarray(fn(value) if fn else value))
    _check_keys(sd, want)
    return sd


def params_from_jax(tree_or_flat: Mapping, cfg: MAEConfig) -> Dict[str, torch.Tensor]:
    """JAX SwinMAE3D params (nested flax tree or the "/"-joined flat form,
    with or without a leading "params" level) -> the port's state_dict
    (CPU float32 tensors). Raises on a missing or unknown parameter."""
    return _convert(tree_or_flat, _map_key, expected_keys(cfg))


def _unmap_decoder_leaf(rest: str, res_prefix: str) -> Tuple[str, Optional[Callable]]:
    """_decoder_leaf's inverse: a port up block or subpixel head leaf ->
    (its JAX path under the block, the relayout it went through)."""
    m = re.fullmatch(r"(transp_conv|proj)\.(weight|bias)", rest)
    if m:
        leaf = "kernel" if m.group(2) == "weight" else "bias"
        fn = (_convT if m.group(1) == "transp_conv" else _conv) if leaf == "kernel" else None
        return f"{'up' if m.group(1) == 'transp_conv' else 'proj'}/{leaf}", fn
    m = re.fullmatch(re.escape(res_prefix) + r"\.(conv\d)\.(weight|bias)", rest)
    if m:
        if m.group(2) == "weight":
            return f"res/{m.group(1)}/kernel", _conv
        return f"res/{m.group(1)}/bias", None
    raise KeyError(rest)


def _unmap_key(name: str) -> Tuple[str, Optional[Callable]]:
    """_map_key's inverse: a port SwinMAE3D key -> (JAX path, relayout)."""
    top = {port: (path, fn) for path, (port, fn) in _TOP.items()}
    if name in top:
        return top[name]
    m = re.fullmatch(r"stages\.(\d+)\.(\d+)\.(.+)", name)
    if m:
        s, j, leaf = int(m.group(1)), int(m.group(2)), m.group(3)
        if s > 0 and j == 0:
            path, fn = {port: (p, f) for p, (port, f) in _MERGE.items()}[leaf]
            return f"encoder/merge{s}/{path}", fn
        path, fn = {port: (p, f) for p, (port, f) in _BLOCK.items()}[leaf]
        return f"encoder/stage{s}_block{j - (1 if s > 0 else 0)}/{path}", fn
    m = re.fullmatch(r"(decoder\d)\.(.+)", name)
    if m:
        path, fn = _unmap_decoder_leaf(m.group(2), "conv_block")
        return f"{m.group(1)}/{path}", fn
    m = re.fullmatch(r"subpixel_head\.(.+)", name)
    if m:
        path, fn = _unmap_decoder_leaf(m.group(1), "res")
        return f"subpixel_head/{path}", fn
    raise KeyError(name)


def mae_params_to_jax(state_dict: Mapping, cfg: MAEConfig) -> Dict[str, np.ndarray]:
    """params_from_jax's inverse: a port SwinMAE3D state dict (or a dict of
    tensors shaped like it, such as AdamW's moments) -> the "/"-flat JAX
    tree (float32 numpy, no leading "params"). Raises on a missing or
    unknown key."""
    _check_keys({k: None for k in state_dict if not _DERIVED.search(k)}, expected_keys(cfg))
    flat = {}
    for name, value in state_dict.items():
        if _DERIVED.search(name):
            continue
        path, fn = _unmap_key(name)
        value = np.asarray(torch.as_tensor(value).detach().cpu().float().numpy())
        flat[path] = np.ascontiguousarray(_RELAYOUTS[fn](value) if fn else value)
    return flat


def _map_head_key(path: str) -> Tuple[str, Optional[Callable]]:
    """A VoxelSR3D / VoxelSemantics3D leaf: `base/` holds the MAE's names;
    encoder1 is a bare res block (no `res/` level), decoder1 an up block."""
    if path.startswith("base/"):
        name, fn = _map_key(path[len("base/"):])
        return f"base.{name}", fn
    m = re.fullmatch(r"encoder1/(conv\d)/(kernel|bias)", path)
    if m:
        if m.group(2) == "kernel":
            return f"encoder1.{m.group(1)}.weight", _conv
        return f"encoder1.{m.group(1)}.bias", None
    m = re.fullmatch(r"decoder1/(.+)", path)
    if m:
        name, fn = _decoder_leaf(m.group(1), "conv_block")
        return f"decoder1.{name}", fn
    m = re.fullmatch(r"(voxel_out|sem_out)/conv/(kernel|bias)", path)
    if m:
        if m.group(2) == "kernel":
            return f"{m.group(1)}.conv.weight", _conv
        return f"{m.group(1)}.conv.bias", None
    raise KeyError(path)


def head_model(cfg: MAEConfig, kind: str, device="cuda", **kw):
    """VoxelSR3D (kind "sr") or VoxelSemantics3D ("semantics") for `cfg`."""
    from nerf_mae_torch.models.heads import VoxelSemantics3D, VoxelSR3D

    if kind == "sr":
        return VoxelSR3D(cfg, device=device, **kw)
    if kind == "semantics":
        return VoxelSemantics3D(cfg, device=device, **kw)
    raise ValueError(f"kind {kind!r} not in ('sr', 'semantics')")


def head_params_from_jax(tree_or_flat: Mapping, cfg: MAEConfig,
                         kind: str) -> Dict[str, torch.Tensor]:
    """JAX VoxelSR3D (kind "sr") or VoxelSemantics3D ("semantics") params,
    nested or "/"-flat, -> the port head's state_dict (CPU float32
    tensors). Raises on a missing or unknown parameter."""
    want = set(head_model(cfg, kind, device="meta").state_dict().keys())
    return _convert(tree_or_flat, _map_head_key, want)


def _map_det_key(path: str, swin_body: bool) -> Tuple[str, Optional[Callable]]:
    """A FCOSDetector or NeRFRPN leaf: a Swin body's trunk keeps the MAE's names
    (patch_embed, patch_norm, encoder -> patch_partition, stages); every
    other leaf is a conv (`kernel` -> `weight`), a GroupNorm (`scale` ->
    `weight`), a bias, or the head's per-level `scales`, under its module
    path with "." for "/"."""
    if swin_body and path.startswith(("body/patch_", "body/encoder/")):
        name, fn = _map_key(path[len("body/"):])
        return f"body.{name}", fn
    m = re.fullmatch(r"((?:body|head)(?:/\w+)*)/(kernel|scale|bias)", path)
    if m:
        prefix = m.group(1).replace("/", ".")
        if m.group(2) == "kernel":
            return f"{prefix}.weight", _conv
        return f"{prefix}.{'weight' if m.group(2) == 'scale' else 'bias'}", None
    if path == "head/scales":
        return "head.scales", None
    raise KeyError(path)


def det_params_from_jax(tree_or_flat: Mapping, swin, fcos, backbone: str = "swin_s",
                        out_channels: int = 256) -> Dict[str, torch.Tensor]:
    """JAX FCOSDetector params (nested flax tree or "/"-flat, as numpy) for
    (swin, fcos, backbone) -> the port detector's state_dict (CPU float32
    tensors): the FPN, the towers, GroupNorm scale/bias -> weight/bias, the
    three output convs and `scales`. Raises on a missing or unknown
    parameter."""
    from nerf_mae_torch.models.detector import FCOSDetector

    want = set(FCOSDetector(swin, fcos, backbone, out_channels, device="meta")
               .state_dict().keys())
    swin_body = backbone.startswith("swin")
    return _convert(tree_or_flat, lambda p: _map_det_key(p, swin_body), want)


def rpn_params_from_jax(tree_or_flat: Mapping, swin, rpn, backbone: str = "swin_s",
                        out_channels: int = 256) -> Dict[str, torch.Tensor]:
    """JAX NeRFRPN params (nested or "/"-flat, as numpy) for (swin, rpn,
    backbone) -> the port RPN's state_dict (CPU float32 tensors): the body
    as det_params_from_jax maps it, the head's convs (`head/conv{i}`,
    `cls_logits`, `bbox_pred`). Raises on a missing or unknown parameter."""
    from nerf_mae_torch.models.rpn import NeRFRPN

    want = set(NeRFRPN(swin, rpn, backbone, out_channels, device="meta").state_dict().keys())
    swin_body = backbone.startswith("swin")
    return _convert(tree_or_flat, lambda p: _map_det_key(p, swin_body), want)


def _map_rcnn_key(path: str) -> Tuple[str, Optional[Callable]]:
    """An RCNNStage leaf: head/conv{i} convs, head/bbox_pred and
    head/cls_score dense layers (kernel [in, out] -> weight [out, in]; the
    inputs are the channel-last flatten on both sides)."""
    m = re.fullmatch(r"head/(conv\d+|bbox_pred|cls_score)/(kernel|bias)", path)
    if not m:
        raise KeyError(path)
    if m.group(2) == "bias":
        return f"head.{m.group(1)}.bias", None
    return f"head.{m.group(1)}.weight", _conv if m.group(1).startswith("conv") else _lin


def rcnn_params_from_jax(tree_or_flat: Mapping, cfg, in_channels: int = 256
                         ) -> Dict[str, torch.Tensor]:
    """JAX RCNNStage params (nested or "/"-flat, as numpy) for RCNNConfig
    `cfg` -> the port stage's state_dict (CPU float32 tensors). Raises on a
    missing or unknown parameter."""
    from nerf_mae_torch.models.rcnn import RCNNStage

    want = set(RCNNStage(cfg, in_channels, device="meta").state_dict().keys())
    return _convert(tree_or_flat, _map_rcnn_key, want)


def _map_nerf_key(path: str) -> Tuple[str, Optional[Callable]]:
    """A NeRFTrainer leaf: {coarse, fine}/<Dense>/{kernel, bias} (kernel
    [in, out] -> weight [out, in]) or the latent table `cam`."""
    if path == "cam":
        return "cam", None
    m = re.fullmatch(r"(coarse|fine)/(fc\d+|sigma|feat|color_fc|rgb)/(kernel|bias)", path)
    if not m:
        raise KeyError(path)
    if m.group(3) == "bias":
        return f"{m.group(1)}.{m.group(2)}.bias", None
    return f"{m.group(1)}.{m.group(2)}.weight", _lin


def nerf_params_from_jax(tree_or_flat: Mapping, params) -> Dict[str, torch.Tensor]:
    """A JAX NeRFTrainer's params {coarse, fine?, cam?} (nested or
    "/"-flat, as numpy) -> the state dict of the port's NeRFParams
    `params` (CPU float32 tensors). Raises on a missing or unknown
    parameter."""
    return _convert(tree_or_flat, _map_nerf_key, set(params.state_dict().keys()))


def _check_keys(sd: Mapping, want: set) -> None:
    missing, extra = want - set(sd), set(sd) - want
    if missing or extra:
        raise KeyError(f"state_dict mismatch: missing {sorted(missing)[:8]}, "
                       f"unexpected {sorted(extra)[:8]}")


def load_weights(model, weights) -> None:
    """Load a state dict (the port's, or a reference NeRF-MAE one: its
    `pos_embed` and `*.relative_position_index` buffers are derived here and
    dropped) into `model`, strictly otherwise."""
    sd = {k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v
          for k, v in weights.items() if not _DERIVED.search(k)}
    model.load_state_dict(sd, strict=True)


def state_dict_of(payload: Mapping) -> Mapping:
    """The state dict in what torch.load gave: a checkpoint's `params` (a
    step of run_mae_pretrain, {"step", "params"[, "opt_state"]}), a
    reference checkpoint's "state_dict", or the payload itself (a bare
    state dict)."""
    if "params" in payload and "step" in payload:
        return payload["params"]
    return payload.get("state_dict", payload)


def read_npz(path: str) -> Dict[str, np.ndarray]:
    """Every array of an .npz (no pickles)."""
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


def jax_params(flat: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The parameter tree in a tools.orbax_to_npz .npz: the `params/` part
    of a state .npz (--state), or the whole of a params .npz."""
    if "step" not in flat:
        return dict(flat)
    return {k[len("params/"):]: v for k, v in flat.items() if k.startswith("params/")}


def load_weights_file(model, path: str) -> None:
    """`.npz`: the flattened JAX parameter tree (tools.orbax_to_npz, with or
    without --state), through params_from_jax; `.pt`/`.pth`: a state dict
    of the port or of the reference, or a checkpoint holding one
    (state_dict_of)."""
    if path.endswith(".npz"):
        load_weights(model, params_from_jax(jax_params(read_npz(path)), model.cfg))
        return
    load_weights(model, state_dict_of(torch.load(path, map_location="cpu",
                                                 weights_only=True)))


def adamw_state_dict(mu: Mapping, nu: Mapping, count: int, model, optimizer,
                     from_jax: Optional[Callable[[Mapping], Mapping]] = None) -> Dict:
    """An optax adamw state as a state dict of `optimizer` (a
    torch.optim.AdamW over parameters of `model`), ready for its
    load_state_dict: `mu` / `nu` are the ScaleByAdamState trees (nested or
    "/"-flat, as numpy) and `count` its update count, which becomes each
    parameter's step. `from_jax` is the model family's parameter mapping
    (params_from_jax for the MAE by default; head_, det_, rpn_ or
    rcnn_params_from_jax with their configs bound); each moment maps
    through it as its parameter does (a relayout, so elementwise).

    Every parameter the optimizer holds gets its moments; a parameter of
    `model` outside the optimizer (a frozen one) gets none. A missing or
    left-over moment, or one of another shape, raises and names it."""
    if from_jax is None:
        from_jax = lambda tree: params_from_jax(tree, model.cfg)  # noqa: E731
    moments = {}
    for what, tree in (("mu", mu), ("nu", nu)):
        try:
            moments[what] = from_jax(tree)
        except KeyError as e:
            raise KeyError(f"opt_state {what}: {e.args[0]}") from None
    names = {id(p): n for n, p in model.named_parameters()}
    held = {names.get(id(p)) for g in optimizer.param_groups for p in g["params"]}
    if None in held:
        raise ValueError("the optimizer holds a parameter that is not the model's")
    for what, m in moments.items():
        left = sorted(set(m) - held)
        if left:
            raise KeyError(f"opt_state {what}: moments of {left[:8]}, which the "
                           "optimizer does not hold")
    packed = optimizer.state_dict()
    state = {}
    for group, packed_group in zip(optimizer.param_groups, packed["param_groups"]):
        for p, index in zip(group["params"], packed_group["params"]):
            name = names[id(p)]
            for what in ("mu", "nu"):
                if tuple(moments[what][name].shape) != tuple(p.shape):
                    raise ValueError(f"opt_state {what} {name!r}: shape "
                                     f"{tuple(moments[what][name].shape)}, the "
                                     f"parameter's {tuple(p.shape)}")
            state[index] = {"step": torch.tensor(float(count), dtype=torch.float32),
                            "exp_avg": moments["mu"][name],
                            "exp_avg_sq": moments["nu"][name]}
    return {"state": state, "param_groups": packed["param_groups"]}


def adamw_state_from_jax(mu: Mapping, nu: Mapping, count: int, model, optimizer,
                         from_jax: Optional[Callable[[Mapping], Mapping]] = None) -> None:
    """Load an optax adamw state into `optimizer` (adamw_state_dict)."""
    optimizer.load_state_dict(adamw_state_dict(mu, nu, count, model, optimizer, from_jax))
