"""Checkpoints and trunk surgery (counterpart of
nerf_mae_tpu/train/checkpoint.py).

One directory per step under the checkpoint directory: `state.pt` holds the
step, the parameters (the model's state_dict) and, for a resumable run, the
optimizer's state_dict (torch.save; read back with weights_only=True);
`extra.json` holds the optional metrics. Only the newest `keep` steps stay.
The trunk is the parameters under the port's trunk names; `graft_mae`
copies it with the MAE's decoder4/3/2 into a downstream head's `base`.

A run of the JAX package resumes from its state .npz
(`python -m nerf_mae_torch.tools.orbax_to_npz <ckpt_dir> --state --out
state.npz`, run where the orbax checkpoints are): `load_jax_state` gives
what `restore_checkpoint` gives, the optimizer state as a ready AdamW state
dict, so both end in the same load_state_dict calls.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Callable, Dict, List, Optional

import torch

from nerf_mae_torch.convert import adamw_state_dict, jax_params, read_npz

# the pretrained trunk (loadable into a downstream backbone): the patch
# embedding and the Swin stages; the mask token, decoders and head are not
TRUNK_KEYS = ("patch_partition", "stages")


def checkpoint_steps(ckpt_dir: str) -> List[int]:
    """The steps saved under ckpt_dir, oldest first."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(n) for n in os.listdir(ckpt_dir)
                  if n.isdigit() and os.path.isfile(os.path.join(ckpt_dir, n, "state.pt")))


def save_checkpoint(ckpt_dir: str, step: int, params: Dict[str, torch.Tensor],
                    opt_state: Optional[Dict[str, Any]] = None,
                    extra: Optional[Dict] = None, keep: int = 3) -> str:
    """Write step `step` (replacing one of the same step) and remove all but
    the newest `keep` steps. Returns the step's directory."""
    path = os.path.join(ckpt_dir, str(step))
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    payload = {"step": step, "params": params}
    if opt_state is not None:
        payload["opt_state"] = opt_state
    torch.save(payload, os.path.join(tmp, "state.pt"))
    if extra:
        with open(os.path.join(tmp, "extra.json"), "w") as f:
            json.dump(extra, f)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    for old in checkpoint_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, str(old)))
    return path


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None) -> Dict:
    """{"step", "params"[, "opt_state"][, "extra"]} of the newest (or the
    given) step, tensors on the CPU."""
    steps = checkpoint_steps(ckpt_dir)
    if step is None:
        if not steps:
            raise FileNotFoundError(f"no checkpoint found in {ckpt_dir}")
        step = steps[-1]
    path = os.path.join(ckpt_dir, str(step))
    out = torch.load(os.path.join(path, "state.pt"), map_location="cpu",
                     weights_only=True)
    extra = os.path.join(path, "extra.json")
    if os.path.exists(extra):
        with open(extra) as f:
            out["extra"] = json.load(f)
    return out


def load_jax_state(path: str, model, optimizer, from_jax: Callable) -> Dict:
    """{"step", "params", "opt_state"[, "extra"]} of a JAX state .npz
    (orbax_to_npz --state), as restore_checkpoint gives them: the step
    directory's number, `from_jax` of the parameters (the family's mapping,
    e.g. a trainer's params_from_jax; CPU tensors), a torch.optim.AdamW
    state dict of `optimizer` over `model`'s parameters made from the
    moments and the update count (convert.adamw_state_dict; it keeps the
    optimizer's own flags, and load_state_dict moves the moments to each
    parameter's device), and the step's metrics. Raises on a params-only
    .npz and on an update count that differs from the schedule's."""
    flat = read_npz(path)
    missing = [k for k in ("step", "opt_state/count", "schedule_count") if k not in flat]
    if missing:
        raise ValueError(
            f"{path} holds no training state ({', '.join(missing)} missing): write it with "
            "`python -m nerf_mae_torch.tools.orbax_to_npz <ckpt_dir> --state --out state.npz`")
    count, schedule = int(flat["opt_state/count"]), int(flat["schedule_count"])
    if count != schedule:
        raise ValueError(f"{path}: AdamW count {count} and schedule count {schedule} differ")
    part = lambda prefix: {k[len(prefix):]: v for k, v in flat.items()  # noqa: E731
                           if k.startswith(prefix)}
    out = {"step": int(flat["step"]), "params": from_jax(jax_params(flat)),
           "opt_state": adamw_state_dict(part("opt_state/mu/"), part("opt_state/nu/"), count,
                                         model, optimizer, from_jax)}
    if "extra" in flat:
        out["extra"] = json.loads(flat["extra"].tobytes().decode())
    return out


def extract_trunk(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """MAE parameters -> the pretrained trunk (decoders, head and mask token
    dropped): the reference's `del model.decoder4 ...` surgery."""
    return {k: v for k, v in params.items() if k.split(".")[0] in TRUNK_KEYS}


def load_trunk_into(params: Dict[str, torch.Tensor],
                    trunk: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Graft a pretrained trunk into a freshly initialized parameter dict,
    leaving everything else untouched. Shapes are checked entry by entry."""
    out = dict(params)
    for k, v in trunk.items():
        if k not in out:
            raise KeyError(f"target params have no trunk entry '{k}'")
        if tuple(out[k].shape) != tuple(v.shape):
            raise ValueError(f"trunk entry '{k}' shape mismatch: "
                             f"{tuple(v.shape)} vs {tuple(out[k].shape)}")
        out[k] = v
    return out


def graft_mae(head_params: Dict[str, torch.Tensor],
              mae_params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Copy the pretrained MAE trunk AND decoder4/3/2 (models.heads
    SR_TRUNK_KEYS) into a VoxelSR3D / VoxelSemantics3D state dict's `base`
    (reference: feature_extractor.py:2008-2012, only decoder1 / out / mask
    token are re-initialized). Every `base` entry must come from the MAE
    (KeyError otherwise, or for a MAE entry the head lacks) with its shape
    (ValueError)."""
    from nerf_mae_torch.models.heads import SR_TRUNK_KEYS

    trunk = {f"base.{k}": v for k, v in mae_params.items()
             if k.split(".")[0] in SR_TRUNK_KEYS}
    missing = sorted(k for k in head_params if k.startswith("base.") and k not in trunk)
    if missing:
        raise KeyError(f"the MAE parameters lack {missing[:8]}")
    return load_trunk_into(head_params, trunk)
