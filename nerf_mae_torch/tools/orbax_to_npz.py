"""A JAX (orbax) checkpoint -> the flat .npz of its parameter tree, which
the port's loaders read (`--params` / `--mae_checkpoint` of inference, the
drivers' `--mae_checkpoint`, every `convert.*_params_from_jax`), or with
--state of its whole training state, which every training driver's
`--checkpoint` resumes.

    python -m nerf_mae_torch.tools.orbax_to_npz <ckpt_dir> --out params.npz [--step N]
    python -m nerf_mae_torch.tools.orbax_to_npz <ckpt_dir> --state --out state.npz

`<ckpt_dir>` is what nerf_mae_tpu.train.checkpoint.save_checkpoint writes:
one directory per step, each holding `state/` (the {params[, opt_state]}
tree). The tool takes the newest step, or --step, reads the tree's
metadata (`state/_METADATA`: JSON, a key list per leaf, and how the leaves
are stored: `use_ocdbt`, one OCDBT key-value store for the whole tree or a
directory per leaf; `use_zarr3`, zarr v3 or v2 arrays) and reads each leaf
under `params` with tensorstore. The .npz holds them under their "/"-joined
keys without the leading `params` (`encoder/stage0_block0/qkv_kernel`),
bfloat16 leaves as float32.

With --state the .npz holds the step's whole state: `params/<key>`, the
AdamW moments `opt_state/mu/<key>` and `opt_state/nu/<key>`, the update
count `opt_state/count`, the schedule's `schedule_count` and `step` (the
step directory's number), and `extra`, the step's metrics JSON as uint8
bytes, so that the file opens with allow_pickle=False. The optimizer state
must be the chain(clip, adamw) of nerf_mae_tpu/train/optim.py's
make_optimizer: `opt_state/0` the clip's empty state,
`opt_state/1/0/{count, mu, nu}` optax's ScaleByAdamState, `opt_state/1/1`
the weight decay's empty state and `opt_state/1/2/count` the schedule's;
any other layout, or two counts that differ, is refused with the leaves
found. Moments that JAX kept in bfloat16 are written as float32, so the
port resumes them in float32.

It reads the files with tensorstore alone, imported when it runs, and
imports neither jax nor orbax: it runs where the JAX checkpoints are
(tensorstore comes with orbax there), and its .npz travels to the card.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np


def checkpoint_steps(ckpt_dir: str) -> List[int]:
    """The steps saved under ckpt_dir (those with `state/_METADATA`),
    oldest first."""
    if not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(f"no checkpoint directory {ckpt_dir}")
    return sorted(int(n) for n in os.listdir(ckpt_dir) if n.isdigit() and os.path.isfile(
        os.path.join(ckpt_dir, n, "state", "_METADATA")))


def leaf_spec(state_dir: str, name: str, use_ocdbt: bool, use_zarr3: bool) -> Dict:
    """The tensorstore spec of the leaf stored as `name` (its keys joined
    with ".") under a step's `state/` directory."""
    state_dir = os.path.abspath(state_dir)
    if use_ocdbt:
        kvstore = {"driver": "ocdbt", "base": f"file://{state_dir}/", "path": name}
    else:
        kvstore = {"driver": "file", "path": os.path.join(state_dir, name) + "/"}
    return {"driver": "zarr3" if use_zarr3 else "zarr", "kvstore": kvstore}


def param_leaves(metadata: Dict) -> List[Tuple[str, str]]:
    """(stored name, flat key) of every leaf under `params` in a tree's
    _METADATA, in its order."""
    out = []
    for entry in metadata["tree_metadata"].values():
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        if keys[0] == "params" and len(keys) > 1:
            out.append((".".join(keys), "/".join(keys[1:])))
    return out


# make_optimizer's chain(clip, adamw): the array leaves outside the moments
# (-> their --state key) and the empty states
_COUNTS = {"opt_state/1/0/count": "opt_state/count", "opt_state/1/2/count": "schedule_count"}
_EMPTY = ("opt_state/0", "opt_state/1/1")


def state_leaves(metadata: Dict) -> List[Tuple[str, str]]:
    """(stored name, --state .npz key) of every array leaf of a tree's
    _METADATA, in its order. Raises, listing the optimizer leaves found,
    unless the optimizer state is make_optimizer's chain(clip, adamw) over
    the parameters."""
    out, found, layout_ok = [], [], True
    for entry in metadata["tree_metadata"].values():
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        path = "/".join(keys)
        empty = entry.get("value_metadata", {}).get("value_type") == "None"
        moment = keys[:3] == ["opt_state", "1", "0"] and keys[3:4] in (["mu"], ["nu"])
        if keys[0] == "params" and len(keys) > 1 and not empty:
            out.append((".".join(keys), path))
        elif moment and len(keys) > 4 and not empty:
            out.append((".".join(keys), "opt_state/" + "/".join(keys[3:])))
        elif path in _COUNTS and not empty:
            out.append((".".join(keys), _COUNTS[path]))
            found.append(path)
        else:
            found.append(path + (" (empty)" if empty else ""))
            layout_ok &= path in _EMPTY and empty
    keys = [k for _, k in out]
    params, mu, nu = ({k[len(p) + 1:] for k in keys if k.startswith(p + "/")}
                      for p in ("params", "opt_state/mu", "opt_state/nu"))
    if not (layout_ok and set(_COUNTS.values()) <= set(keys) and params and mu == params
            and nu == params):
        raise ValueError(
            "the optimizer state is not nerf_mae_tpu/train/optim.py's chain(clip, adamw) over "
            f"the params: found {', '.join(found) or 'no optimizer leaf'}, and {len(mu)} mu / "
            f"{len(nu)} nu leaves for {len(params)} params")
    return out


def read_leaves(step_dir: str, state: bool = False) -> Dict[str, np.ndarray]:
    """{key: array} of the leaves saved in a step directory: the parameter
    tree's (param_leaves), or with `state` the whole training state's
    (state_leaves). Raises, naming the key, on a leaf that cannot be
    read."""
    import tensorstore as ts  # only where the tool runs

    state_dir = os.path.join(step_dir, "state")
    with open(os.path.join(state_dir, "_METADATA")) as f:
        metadata = json.load(f)
    use_ocdbt = bool(metadata.get("use_ocdbt", True))
    use_zarr3 = bool(metadata.get("use_zarr3", False))
    leaves = state_leaves(metadata) if state else param_leaves(metadata)
    if not leaves:
        raise ValueError(f"{state_dir} holds no leaf under 'params'")
    flat = {}
    for name, key in leaves:
        try:
            store = ts.open(leaf_spec(state_dir, name, use_ocdbt, use_zarr3), open=True).result()
            value = np.asarray(store.read().result())
        except (ValueError, OSError) as e:  # tensorstore reports as ValueError
            raise ValueError(f"cannot read the leaf {key!r} ({name} under {state_dir}): "
                             f"{e}") from None
        if value.dtype.kind == "V":  # bfloat16 (ml_dtypes): no npz dtype
            value = value.astype(np.float32)
        flat[key] = value
    return flat


def read_state(step_dir: str) -> Dict[str, np.ndarray]:
    """The --state .npz's arrays of a step directory: read_leaves(state=
    True), `step` and the step's `extra` metrics JSON as uint8 bytes.
    Raises when the AdamW and schedule counts differ."""
    flat = read_leaves(step_dir, state=True)
    count, schedule = int(flat["opt_state/count"]), int(flat["schedule_count"])
    if count != schedule:
        raise ValueError(f"{step_dir}: opt_state/1/0/count {count} and opt_state/1/2/count "
                         f"{schedule} differ")
    flat["step"] = np.asarray(int(os.path.basename(os.path.normpath(step_dir))), np.int64)
    extra = os.path.join(step_dir, "extra", "metadata")
    if os.path.isfile(extra):
        with open(extra, "rb") as f:
            flat["extra"] = np.frombuffer(f.read(), np.uint8)
    return flat


def convert(ckpt_dir: str, out: str, step: Optional[int] = None,
            state: bool = False) -> Tuple[int, int]:
    """Write the params (with `state`, read_state's training state) of
    `step` (the newest when None) of ckpt_dir to the .npz `out`. Returns
    (step, arrays written)."""
    steps = checkpoint_steps(ckpt_dir)
    if step is None:
        if not steps:
            raise FileNotFoundError(f"no orbax checkpoint step in {ckpt_dir}")
        step = steps[-1]
    elif step not in steps:
        raise FileNotFoundError(f"step {step} not in {ckpt_dir} (steps: {steps})")
    step_dir = os.path.join(ckpt_dir, str(step))
    flat = read_state(step_dir) if state else read_leaves(step_dir)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez(out, **flat)
    return step, len(flat)


def main(argv=None):
    p = argparse.ArgumentParser(description="JAX (orbax) checkpoint -> flat params (or "
                                            "--state: training state) .npz")
    p.add_argument("ckpt_dir", help="a checkpoint directory of the JAX trainers")
    p.add_argument("--out", required=True, help="the .npz to write")
    p.add_argument("--step", default=None, type=int, help="the step (default: the newest)")
    p.add_argument("--state", action="store_true",
                   help="write the whole training state (params, AdamW moments and count, "
                        "schedule count, step, metrics), which --checkpoint resumes")
    args = p.parse_args(argv)
    step, n = convert(args.ckpt_dir, args.out, args.step, args.state)
    print(f"step {step}: {n} {'state arrays' if args.state else 'parameter leaves'} -> "
          f"{args.out}")
    return args.out


if __name__ == "__main__":
    main()
