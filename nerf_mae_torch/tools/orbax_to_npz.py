"""A JAX (orbax) checkpoint -> the flat .npz of its parameter tree, which
the port's loaders read (`--params` / `--mae_checkpoint` of inference, the
drivers' `--mae_checkpoint`, every `convert.*_params_from_jax`).

    python -m nerf_mae_torch.tools.orbax_to_npz <ckpt_dir> --out params.npz [--step N]

`<ckpt_dir>` is what nerf_mae_tpu.train.checkpoint.save_checkpoint writes:
one directory per step, each holding `state/` (the {params[, opt_state]}
tree). The tool takes the newest step, or --step, reads the tree's
metadata (`state/_METADATA`: JSON, a key list per leaf, and how the leaves
are stored: `use_ocdbt`, one OCDBT key-value store for the whole tree or a
directory per leaf; `use_zarr3`, zarr v3 or v2 arrays) and reads each leaf
under `params` with tensorstore. The .npz holds them under their "/"-joined
keys without the leading `params` (`encoder/stage0_block0/qkv_kernel`),
bfloat16 leaves as float32.

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


def read_params(step_dir: str) -> Dict[str, np.ndarray]:
    """{flat key: array} of the parameter tree saved in a step directory.
    Raises, naming the key, on a leaf that cannot be read."""
    import tensorstore as ts  # only where the tool runs

    state_dir = os.path.join(step_dir, "state")
    with open(os.path.join(state_dir, "_METADATA")) as f:
        metadata = json.load(f)
    use_ocdbt = bool(metadata.get("use_ocdbt", True))
    use_zarr3 = bool(metadata.get("use_zarr3", False))
    leaves = param_leaves(metadata)
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


def convert(ckpt_dir: str, out: str, step: Optional[int] = None) -> Tuple[int, int]:
    """Write the params of `step` (the newest when None) of ckpt_dir to the
    .npz `out`. Returns (step, leaves written)."""
    steps = checkpoint_steps(ckpt_dir)
    if step is None:
        if not steps:
            raise FileNotFoundError(f"no orbax checkpoint step in {ckpt_dir}")
        step = steps[-1]
    elif step not in steps:
        raise FileNotFoundError(f"step {step} not in {ckpt_dir} (steps: {steps})")
    flat = read_params(os.path.join(ckpt_dir, str(step)))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez(out, **flat)
    return step, len(flat)


def main(argv=None):
    p = argparse.ArgumentParser(description="JAX (orbax) checkpoint -> flat params .npz")
    p.add_argument("ckpt_dir", help="a checkpoint directory of the JAX trainers")
    p.add_argument("--out", required=True, help="the .npz to write")
    p.add_argument("--step", default=None, type=int, help="the step (default: the newest)")
    args = p.parse_args(argv)
    step, n = convert(args.ckpt_dir, args.out, args.step)
    print(f"step {step}: {n} parameter leaves -> {args.out}")
    return args.out


if __name__ == "__main__":
    main()
