"""The yardstick's arithmetic for the dense heads (the voxel semantics
step), beside counts.py and as frozen: the model FLOPs of a step
(registered as counts.FLOPS_PER_GRID["semantics"], which `mfu` reads),
and the operations and bytes of the full-resolution stack, encoder1 and
decoder1, that `full_res_roofline` reads.

Model FLOPs follow counts.py: 2*M*N*K per product of one forward per grid,
a training step 3x the forward, no recompute, no elementwise, norm or loss
work (nerf_mae_torch/flops.py's dense_head_flops_per_grid counts the
same).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from perfbench import counts


def full_res_convs(cfg: dict) -> List[Tuple[str, int, int, int, int, int, bool]]:
    """The convolutions of encoder1 and decoder1 for one grid: (name, input
    voxels, output voxels, input channels, output channels, taps, whether
    the input takes a gradient). decoder1's transposed conv (k = s = p)
    reads one input voxel per output voxel; encoder1's convs read the grid,
    which takes none."""
    e, half, cin = cfg["embed_dim"], cfg["embed_dim"] // 2, cfg["input_channels"]
    n = cfg["resolution"] ** 3
    coarse = n // cfg["patch_size"] ** 3
    return [("encoder1.conv1", n, n, cin, half, 27, False),
            ("encoder1.conv2", n, n, half, half, 27, True),
            ("encoder1.conv3", n, n, cin, half, 1, False),
            ("decoder1.transp_conv", coarse, n, e, half, 1, True),
            ("decoder1.conv1", n, n, 2 * half, half, 27, True),
            ("decoder1.conv2", n, n, half, half, 27, True),
            ("decoder1.conv3", n, n, 2 * half, half, 1, True)]


def full_res_work(cfg: dict, batch: int) -> Tuple[float, float]:
    """(FLOPs, bytes) that a training step's forward and backward of
    encoder1 and decoder1 need, without recompute. FLOPs: 2 * output voxels
    * taps * Cin * Cout a conv forward; its backward the weight gradient
    and, where the input takes one, the input gradient, each as many.
    Bytes, in the compute dtype: a forward reads each conv's input and
    weights and writes its output; a backward reads its input, weights and
    output gradient and writes its input gradient (where taken) and its
    weight gradient (float32). The instance norms, activations, concat and
    residual adds are taken as fused into the convs, so they add no bytes:
    a lower bound."""
    e = counts.BYTES[cfg["compute_dtype"]]
    flops = nbytes = 0.0
    for _, n_in, n_out, cin, cout, taps, grad_in in full_res_convs(cfg):
        fwd = 2.0 * batch * n_out * taps * cin * cout
        w = taps * cin * cout
        act_in, act_out = batch * n_in * cin, batch * n_out * cout
        flops += fwd * (3.0 if grad_in else 2.0)
        nbytes += e * (act_in + act_out + w)
        nbytes += e * (act_in + act_out + w + (act_in if grad_in else 0)) + 4 * w
    return flops, nbytes


def full_res_bound_s(cfg: dict, batch: int) -> float:
    return counts.bound_s(*full_res_work(cfg, batch), cfg["compute_dtype"])


def semantics_flops_per_grid(cfg: dict) -> Dict[str, float]:
    """The voxel semantics model's forward FLOPs per grid by part: the
    trunk, decoders 4/3/2, encoder1 and decoder1 at R^3 and the 1x1 head to
    num_classes; with fwd_total and train_total."""
    out = counts.trunk_flops(cfg)
    mae = counts.mae_flops_per_grid({**cfg, "out_channels": 0})  # the same decoders 4/3/2
    out.update({f"decoder{k}": mae[f"decoder{k}"] for k in (4, 3, 2)})
    for name, _, n_out, cin, cout, taps, _ in full_res_convs(cfg):
        part = name.split(".")[0]
        out[part] = out.get(part, 0.0) + 2.0 * n_out * taps * cin * cout
    out["head"] = 2.0 * cfg["resolution"] ** 3 * (cfg["embed_dim"] // 2) * cfg["num_classes"]
    fwd = sum(out.values())
    return {**out, "fwd_total": fwd, "train_total": 3.0 * fwd}


counts.FLOPS_PER_GRID.setdefault("semantics", semantics_flops_per_grid)
