"""The port's [data, space] grid sharding (parallel/spatial.py) on the CPU,
against one process (tests/test_torch_spatial_jax.py holds it against JAX).

One launch of 4 gloo ranks (parallel.dryrun.launch) runs every case, each
on a mesh made in the same process group:
- the collectives on a (2 x 2) and a (1 x 4) mesh, in float64, against the
  unsharded ops (zero padding and slicing, torch.roll, a sum, the nearest
  resize) and their gradients: a halo of 1 and 2 planes (from a
  neighbour's neighbour, beside an empty slab), a relayout with and
  without a cyclic offset, space_sum, an unaligned resize;
- the replicated-operand cotangent of tests/test_spatial.py:80-135: an
  operand every rank holds, added to a vector and fed to two chained
  strided up blocks; its gradient and the blocks', summed over the ranks,
  equal one process's (the JAX package's Shardy partitioner counted it S
  times);
- the MAE (2 steps), SR and semantics (1 step each) trainers and an eval
  of each: at S=2 on a (2 data x 2 space) mesh, R=48 with 2^3 patches (a
  24^3 token grid: stage 1's windows cross the slab boundary, and every
  shifted stage-0 window does), dense grids, remat on; at S=4 on (1 x 4),
  R=64, patch-major grids: uneven window ownership and empty slabs (stage
  1 on two ranks, stages 2-3 on one). In float32: losses within rel 1e-5
  and the other metrics within 1e-4 (test_torch_parallel_train's), the
  parameters after within rtol 1e-4 / atol 1e-5, the replicas equal, and
  the gradients before the clip within rel L2 1e-4 per parameter group, or
  within twice the one-process step's own float32 error where that is
  larger. That error is the larger distance of two reruns of the step:
  at another thread count (another summation order in the convolutions'
  weight gradients: 1.0-2.0e-4 in the heads' full-resolution encoder1 and
  decoder1), and row by row (the data-parallel split: at the random
  initial weights, where stochastic depth drops a branch of a sample, the
  trunk's gradients move by up to 5e-3 from the whole batch's). The
  one-process references run in the same launch, a few a rank, each step
  from the sharded run's weights and optimizer state before it (after a
  step the weights differ by rounding, which the next step's gradients
  amplify, as in chip_smoke.py's phase 18);
- the drivers: run_voxel_sr --mesh_space 2 and run_voxel_semantics
  --mesh_space 4 (train one step, then --mode eval) against one process;
- the dry run's spatial leg (dryrun.multichip_rank at n = 4).
"""

import copy
import dataclasses
import hashlib
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nerf_mae_torch import run_voxel_semantics, run_voxel_sr
from nerf_mae_torch.config import SWIN_PRESETS, MAEConfig, SwinConfig, TrainConfig
from nerf_mae_torch.models.heads import nearest_resize
from nerf_mae_torch.models.mae import init_weights
from nerf_mae_torch.models.unetr import UnetrUpBlock3D
from nerf_mae_torch.ops.patchify import patchify_np
from nerf_mae_torch.parallel import (
    DataMesh,
    batch_rows,
    check_token_grid,
    dryrun,
    grid_slab,
    make_mesh,
    prepare_spatial_config,
    shard_batch,
)
from nerf_mae_torch.parallel import spatial as sp
from nerf_mae_torch.train.head_trainer import VoxelSemanticsTrainer, VoxelSRTrainer
from nerf_mae_torch.ops.draws import batch_generator
from nerf_mae_torch.train.trainer import _DROPPATH, _MASK, MAETrainer, stream_seed

torch.set_num_threads(1)

MODULE = "test_torch_spatial"  # the ranks import this module by name
WORLD = 4
LR, TOTAL = 1e-4, 10
# (data, space, resolution, patch, global batch, SR output, input layout)
CASES = {"s2": (2, 2, 48, 2, 4, 72, "dense"), "s4": (1, 4, 64, 4, 2, 96, "patch_major")}
KINDS = ("mae", "sr", "semantics")
STEPS = {"mae": 2, "sr": 1, "semantics": 1}
PRIM_N = 9  # planes of the collectives' test grid
OPS = ("halo1", "halo2", "relayout", "roll", "space_sum", "resize")
DRIVERS = {  # kind: (module, --mesh_space, extra flags)
    "sr": (run_voxel_sr, 2, ["--out_resolution", "48"]),
    "semantics": (run_voxel_semantics, 4, ["--num_classes", "5"]),
}
TINY = ["--dataset", "synthetic", "--backbone_type", "swin_nano", "--resolution", "32",
        "--batch_size", "2", "--n_synthetic", "4", "--n_synthetic_val", "4",
        "--compute_dtype", "float32", "--device", "cpu", "--workers", "0", "--prefetch", "0",
        "--log_interval", "1", "--seed", "3", "--eval_interval", "1000", "--ckpt_interval",
        "1000"]


# --------------------------------------------------------------- the cases

def _mae_cfg(case):
    _, _, res, patch, _, _, _ = CASES[case]
    swin = dataclasses.replace(SWIN_PRESETS["swin_nano"], stochastic_depth_prob=0.2,
                               patch_size=(patch,) * 3)
    if case == "s2":  # remat on: a recompute runs its collectives again
        return MAEConfig(swin=swin, resolution=res, compute_dtype="float32")
    return MAEConfig(swin=swin, resolution=res, compute_dtype="float32", remat=False,
                     remat_stages=None)


def make_trainer(case, kind, mesh=None):
    cfg, tcfg = _mae_cfg(case), TrainConfig(lr=LR)
    if kind == "mae":
        return MAETrainer(cfg, tcfg, TOTAL, "cpu", mesh)
    if kind == "sr":
        return VoxelSRTrainer(cfg, tcfg, TOTAL, "cpu", out_resolution=CASES[case][5], mesh=mesh)
    weights = np.array([0.0, 1.0, 2.0, 0.5, 1.5], np.float32)
    return VoxelSemanticsTrainer(cfg, tcfg, TOTAL, "cpu", num_classes=5,
                                 class_weights=weights, mesh=mesh)


def global_batch(case, kind):
    """The global batch of a case (numpy), its rows' counts different."""
    _, _, r, patch, n, out, layout = CASES[case]
    rs = np.random.RandomState(11)
    alive = np.linspace(0.2, 0.8, n)[:, None, None, None]
    grids = rs.rand(n, r, r, r, 4).astype(np.float32)
    grids[..., 3] *= rs.rand(n, r, r, r) > alive
    if kind == "mae":
        sizes = np.array([[r, r - 3, r - 1], [r - 5, r, r], [r, r, r - 9],
                          [r - 7, r - 2, r]], np.int32)[:n]
        return {"grids": patchify_np(grids, patch) if layout == "patch_major" else grids,
                "sizes": sizes}
    if kind == "sr":
        hi = rs.rand(n, out, out, out, 4).astype(np.float32)
        hi[..., 3] *= rs.rand(n, out, out, out) > alive
        return {"grids": grids, "out_grids": hi}
    sem = rs.randint(0, 5, (n, r, r, r)).astype(np.int32)
    sem *= rs.rand(n, r, r, r) > alive
    return {"grids": grids, "semantics": sem}


def group_of(name):
    """A parameter's group: stage, decoder or head module."""
    parts = name.split(".")
    if parts[0] == "base":
        parts = parts[1:]
    return ".".join(parts[:2]) if parts[0] == "stages" else parts[0]


def group_rels(got, want):
    """{group: rel L2} of two [{name: gradient}] step lists, worst step."""
    out = {}
    for g, w in zip(got, want):
        for group in {group_of(n) for n in w}:
            names = [n for n in w if group_of(n) == group]
            a = np.concatenate([g[n].ravel() for n in names])
            b = np.concatenate([w[n].ravel() for n in names])
            rel = float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
            out[group] = max(out.get(group, 0.0), rel)
    return out


def microbatch_grads(case, kind, starts):
    """The gradients of one process that computes each row of the batch on
    its own (a batch of one, gradients accumulated: the data-parallel
    split), step k from starts[k]; a loss's counts are the whole batch's,
    call by call."""
    trainer = make_trainer(case, kind)
    state = trainer.init(0)
    model = state.model
    host = {k: torch.from_numpy(v) for k, v in global_batch(case, kind).items()}
    n = len(host["grids"])
    out = []
    for step in range(STEPS[kind]):
        model.load_state_dict(starts[step][0])
        model.train()
        gens = {s: (lambda r, s=s: batch_generator("cpu", stream_seed(0, step, s), r, n))
                for s in (_MASK, _DROPPATH)}

        def loss_of(rows, count_sum):
            trainer.count_sum = count_sum
            batch = {k: v[rows] for k, v in host.items()}
            if kind == "mae":
                return trainer._losses(model, batch, False, gens[_MASK](rows.start),
                                       gens[_DROPPATH](rows.start))[0]
            pred = model(batch["grids"], False, droppath_generator=gens[_DROPPATH](rows.start))
            return trainer._loss(pred, batch)[0]

        counts = []
        with torch.no_grad():
            loss_of(slice(0, n), lambda t: counts.append(t.detach().clone()) or t)
        model.zero_grad(set_to_none=True)
        for r in range(n):
            calls = iter(counts)
            loss_of(slice(r, r + 1), lambda t: next(calls)).backward()
        out.append({name: p.grad.detach().clone().numpy() if p.grad is not None
                    else np.zeros(p.shape, np.float32) for name, p in model.named_parameters()})
    return out


def reference(case, kind, starts):
    """One process's run_case from the sharded run's `starts`, and its
    gradients' float32 error by group: the larger distance of the same step
    at another thread count and computed row by row."""
    ref = run_case(case, kind, starts=starts)
    threads = torch.get_num_threads()
    torch.set_num_threads(threads + 1)
    try:
        again = run_case(case, kind, starts=starts)
    finally:
        torch.set_num_threads(threads)
    noise = [group_rels(g, ref["grads"])
             for g in (again["grads"], microbatch_grads(case, kind, starts))]
    ref["noise"] = {g: max(n[g] for n in noise) for g in noise[0]}
    return ref


def run_case(case, kind, mesh=None, starts=None):
    """init(0), STEPS[kind] steps and an eval of `kind` on the case's batch
    (this rank's rows and slabs on a mesh): the metrics, the gradients
    before each clip, the parameters after, a digest of them, and the
    state (weights, optimizer) before each step. Given `starts`, step k
    begins from starts[k] (another run's weights: a step's rounding moves
    the weights, and the next step's gradients amplify it)."""
    trainer = make_trainer(case, kind, mesh)
    state = trainer.init(0)
    names = [n for n, _ in state.model.named_parameters()]
    grads = []
    clip = trainer.clip

    def recorded(gs, max_norm):
        grads.append({n: g.detach().clone().numpy() for n, g in zip(names, gs)})
        return clip(gs, max_norm)

    trainer.clip = recorded
    host = global_batch(case, kind)
    batch = (shard_batch(host, mesh) if mesh is not None
             else {k: torch.from_numpy(v) for k, v in host.items()})
    metrics, begun = [], []
    for k in range(STEPS[kind]):
        if starts is not None:
            state.model.load_state_dict(starts[k][0])
            state.optimizer.load_state_dict(copy.deepcopy(starts[k][1]))
        begun.append(({n: v.clone() for n, v in state.model.state_dict().items()},
                      copy.deepcopy(state.optimizer.state_dict())))
        state, m = trainer.train_step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    ev = {k: float(v) for k, v in trainer.eval_step(state, batch).items() if v.ndim == 0}
    params = {k: v.detach().numpy().copy() for k, v in state.model.state_dict().items()}
    digest = hashlib.sha256(b"".join(p.tobytes() for p in params.values())).hexdigest()
    main = mesh is None or mesh.rank == 0
    return {"metrics": metrics, "eval": ev, "digest": digest,
            "grads": grads if main else None, "params": params if main else None,
            "attention_impl": trainer.mae_cfg.swin.attention_impl, "starts": begun}


# ----------------------------------------------------------- the collectives

def _prim_input():
    rs = np.random.RandomState(5)
    return rs.randn(2, PRIM_N, PRIM_N, 4, 2)


def _weight(shape, rank):
    return np.random.RandomState(100 + rank).randn(*shape)


def _prim_layouts(op, s):
    """(source layout, destination ranges) of `op` over s ranks."""
    even = sp.even_bounds(PRIM_N, s)
    if op.startswith("halo"):
        k = int(op[-1])
        return even, tuple((lo - k, hi + k) if hi > lo else (lo, lo) for lo, hi in even)
    if op == "relayout":
        return even, sp.window_bounds(PRIM_N, 4, s)[0]
    if op == "roll":
        padded = sp.window_bounds(PRIM_N, 4, s)[1]
        return padded, padded
    if op == "resize":
        return even, sp.even_bounds(13, s)
    return even, even


def primitive(op, mesh):
    """This rank's output slab of `op` on its input slab, and the input
    slab's gradient of sum(output * weight) (float64)."""
    s = mesh.space
    src, dst = _prim_layouts(op, s)
    lo, hi = src[mesh.space_rank]
    full = _prim_input()
    if op == "roll":
        full = np.concatenate([full, np.zeros((2, 12 - PRIM_N) + full.shape[2:])], 1)
    x = torch.tensor(full[:, lo:hi], requires_grad=True)
    if op.startswith("halo"):
        y = sp.halo(x, int(op[-1]), mesh)
    elif op == "relayout":
        y = sp.relayout(x, src, dst, mesh)
    elif op == "roll":
        y = sp.relayout(x, src, dst, mesh, offset=2)
    elif op == "resize":
        y = nearest_resize(x, 13, mesh)
    else:
        y = sp.space_sum(x.sum(1), mesh)
    # space_sum's result is replicated: every rank applies the same weight
    w = _weight(y.shape, 0 if op == "space_sum" else mesh.space_rank)
    (y * torch.from_numpy(w)).sum().backward()
    return {"y": y.detach().numpy(), "grad": x.grad.numpy(), "src": src, "dst": dst}


def reference_primitive(op, ranks):
    """The unsharded op on the whole input: each rank's output range and
    the input's gradient of the sum over the ranks of sum(output * weight)."""
    full = _prim_input()
    if op == "roll":  # the zero pad planes are inputs of the slabs too
        full = np.concatenate([full, np.zeros((2, 12 - PRIM_N) + full.shape[2:])], 1)
    x = torch.tensor(full, requires_grad=True)
    src, dst = ranks[0]["src"], ranks[0]["dst"]
    if op.startswith("halo"):
        k = int(op[-1])
        xp = F.pad(x, (0, 0, 0, 0, 0, 0, k, k))
        ys = [xp[:, a + k:b + k] for a, b in dst]
    elif op == "relayout":
        ys = [x[:, a:b] for a, b in dst]
    elif op == "roll":
        rolled = torch.roll(x, -2, dims=1)
        ys = [rolled[:, a:b] for a, b in dst]
    elif op == "resize":
        full = nearest_resize(x, 13)
        ys = [full[:, a:b] for a, b in dst]
    else:
        ys = [x.sum(1) for _ in dst]
    if op == "space_sum":  # a replicated result: its gradient counted once
        loss = (ys[0] * torch.from_numpy(_weight(ys[0].shape, 0))).sum()
    else:
        loss = sum((y * torch.from_numpy(_weight(y.shape, r))).sum() for r, y in enumerate(ys))
    loss.backward()
    return [y.detach().numpy() for y in ys], [x.grad.numpy()[:, lo:hi] for lo, hi in src]


def replicated_operand(mesh=None):
    """tests/test_spatial.py:80-135 in the port: x (held whole by every
    rank of a data row) + v through two chained strided up blocks with
    space-sharded skips; the mean of the square, v's and the blocks'
    gradients (a rank's partial sums on a mesh)."""
    e = 12
    rs = np.random.RandomState(0)
    x = rs.rand(2, 2, 2, 2, 4 * e).astype(np.float32)
    s1 = rs.rand(2, 4, 4, 4, 2 * e).astype(np.float32)
    s0 = rs.rand(2, 8, 8, 8, e).astype(np.float32)
    v = torch.tensor(rs.rand(4 * e).astype(np.float32), requires_grad=True)
    blocks = torch.nn.ModuleDict({
        "d3": UnetrUpBlock3D(4 * e, 2 * e, dtype=torch.float32, device="cpu"),
        "d2": UnetrUpBlock3D(2 * e, e, dtype=torch.float32, device="cpu")})
    init_weights(blocks, 0)
    rows = slice(0, 2)
    if mesh is not None:
        sp.set_spatial(blocks, mesh)
        rows = batch_rows(2, mesh.data_rank, mesh.data_world)
    h = sp.take_slab(torch.from_numpy(x[rows]) + v, mesh)
    d = blocks["d3"](h, sp.take_slab(torch.from_numpy(s1[rows]), mesh))
    d = blocks["d2"](d, sp.take_slab(torch.from_numpy(s0[rows]), mesh))
    loss = (d.float() ** 2).sum() / (2 * 8 ** 3 * e)
    loss.backward()
    return {"loss": float(loss.detach()), "v": v.grad.numpy(),
            "params": {n: p.grad.numpy() for n, p in blocks.named_parameters()}}


# ------------------------------------------------------------------ drivers

def driver_argv(kind, ckpt, mode, space=1):
    module, _, extra = DRIVERS[kind]
    argv = ["--mode", mode, *TINY, *extra, "--mesh_space", str(space)]
    if mode == "train":
        return argv + ["--steps", "1", "--checkpoint_dir", ckpt]
    return argv + ["--checkpoint", ckpt]


def run_driver(kind, ckpt, space=1):
    """One train step of the driver, then its eval from the checkpoint."""
    module = DRIVERS[kind][0]
    train = module.main(driver_argv(kind, ckpt, "train", space))
    return {"history": train["history"], "eval": module.main(driver_argv(kind, ckpt, "eval",
                                                                          space))}


# ------------------------------------------------------------------ the launch

def spatial_rank(workdir):
    """A launch target: every case on 4 gloo ranks (module doc), then this
    rank's share of the one-process references."""
    out = {"refs": {}}
    with make_mesh(WORLD, device="cpu") as world:
        for s in (2, 4):
            mesh = make_mesh(WORLD, device="cpu", n_space=s)
            out[("layout", s)] = (mesh.data_rank, mesh.space_rank, mesh.data_world)
            for op in OPS:
                out[(op, s)] = primitive(op, mesh)
            out[("replicated", s)] = replicated_operand(mesh)
        starts = {}
        for case, spec in CASES.items():
            mesh = make_mesh(WORLD, device="cpu", n_space=spec[1])
            for kind in KINDS:
                out[(case, kind)] = run_case(case, kind, mesh)
                starts[(case, kind)] = out[(case, kind)].pop("starts")
        for kind, (_, space, _) in DRIVERS.items():
            out[("driver", kind)] = run_driver(kind, os.path.join(workdir, kind), space)
        out["dryrun"] = dryrun.multichip_rank(WORLD, os.path.join(workdir, "dryrun"))
        jobs = [(case, kind) for case in CASES for kind in KINDS]
        for i, (case, kind) in enumerate(jobs):
            if i % WORLD == world.rank:  # from the replicas' states: every rank has them
                ref = out["refs"][(case, kind)] = reference(case, kind, starts[(case, kind)])
                del ref["starts"]
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("spatial"))
    out = dryrun.launch(f"{MODULE}:spatial_rank", WORLD, {"workdir": workdir})
    refs = {k: v for o in out for k, v in o["refs"].items()}
    return out, refs


# ------------------------------------------------------------------ the mesh

def test_mesh_layout_is_make_mesh_2d_row_major(ranks):
    out, _ = ranks
    assert [o[("layout", 2)] for o in out] == [(0, 0, 2), (0, 1, 2), (1, 0, 2), (1, 1, 2)]
    assert [o[("layout", 4)] for o in out] == [(0, r, 1) for r in range(4)]


def test_bounds_and_slabs():
    assert sp.even_bounds(5, 4) == ((0, 2), (2, 4), (4, 5), (5, 5))
    assert sp.window_bounds(10, 4, 4) == (((0, 4), (4, 8), (8, 10), (10, 10)),
                                          ((0, 4), (4, 8), (8, 12), (12, 12)))
    assert sp.halve_bounds(((0, 4), (4, 5))) == ((0, 2), (2, 3))
    mesh = DataMesh(3, 4, 0, torch.device("cpu"), space=2)
    assert (mesh.data_rank, mesh.space_rank, mesh.data_world) == (1, 1, 2)
    assert grid_slab(160, mesh) == slice(80, 160)
    assert grid_slab(160, None) == slice(0, 160)


def test_make_mesh_refuses_a_space_axis_that_does_not_divide_the_world():
    with pytest.raises(ValueError, match="does not divide a world of 1"):
        make_mesh(device="cpu", n_space=2)
    with pytest.raises(ValueError, match="n_space must be >= 1"):
        make_mesh(device="cpu", n_space=0)


def test_spatial_config_refuses_the_kernels_and_an_indivisible_token_grid():
    """attention_impl "kernel" raises with JAX's words, "auto" becomes
    "plain" (no kernel runs on a slab), "plain" stays; a token grid the
    space axis does not divide is refused."""
    mesh = DataMesh(0, 4, 0, torch.device("cpu"), space=4)
    with pytest.raises(ValueError, match="spatial sharding"):
        prepare_spatial_config(mesh, SwinConfig(attention_impl="kernel"))
    assert prepare_spatial_config(mesh, SwinConfig()).attention_impl == "plain"
    assert prepare_spatial_config(None, SwinConfig()).attention_impl == "auto"
    with pytest.raises(ValueError, match="token grid 10"):
        check_token_grid(mesh, 10)
    with pytest.raises(ValueError, match="spatial sharding"):
        MAETrainer(MAEConfig(swin=SwinConfig(attention_impl="kernel")), TrainConfig(), 1,
                   "cpu", mesh)


# --------------------------------------------------------- the collectives

@pytest.mark.parametrize("s", (2, 4))
@pytest.mark.parametrize("op", OPS)
def test_collectives_match_the_unsharded_ops(ranks, op, s):
    out, _ = ranks
    got = [o[(op, s)] for o in out][:s]  # the first data row's ranks
    ys, grads = reference_primitive(op, got)
    for r, g in enumerate(got):
        np.testing.assert_allclose(g["y"], ys[r], rtol=1e-12, atol=1e-12, err_msg=f"rank {r}")
        np.testing.assert_allclose(g["grad"], grads[r], rtol=1e-12, atol=1e-12,
                                   err_msg=f"rank {r} gradient")


@pytest.mark.parametrize("s", (2, 4))
def test_replicated_operand_cotangent_is_counted_once(ranks, s):
    out, _ = ranks
    want = replicated_operand()
    got = [o[("replicated", s)] for o in out]  # every rank's share of the sums
    np.testing.assert_allclose(sum(g["loss"] for g in got), want["loss"], rtol=1e-5)
    np.testing.assert_allclose(sum(g["v"] for g in got), want["v"], rtol=1e-4, atol=1e-7)
    # a conv bias before an instance norm has a zero gradient in exact
    # arithmetic: float32 noise on both sides, held against the largest
    atol = 1e-5 * max(float(np.abs(w).max()) for w in want["params"].values())
    for name, w in want["params"].items():
        np.testing.assert_allclose(sum(g["params"][name] for g in got), w, rtol=1e-4,
                                   atol=atol, err_msg=name)


# --------------------------------------------------------------- the steps

@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kind", KINDS)
def test_spatial_step_equals_one_process(ranks, case, kind):
    out, refs = ranks
    want, r0 = refs[(case, kind)], out[0][(case, kind)]
    assert r0["attention_impl"] == "plain" and want["attention_impl"] == "auto"
    assert len({o[(case, kind)]["digest"] for o in out}) == 1  # the replicas
    for step, (got, ref) in enumerate(zip(r0["metrics"], want["metrics"])):
        assert got.keys() == ref.keys()
        assert all(o[(case, kind)]["metrics"][step] == got for o in out)
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5, err_msg=f"step {step}")
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {step} {k}")
    rels = group_rels(r0["grads"], want["grads"])
    for group, rel in rels.items():
        tol = max(1e-4, 2 * want["noise"][group])
        assert rel <= tol, (group, rel, tol, want["noise"])
    for name, p in want["params"].items():
        np.testing.assert_allclose(r0["params"][name], p, rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kind", KINDS)
def test_spatial_eval_equals_one_process(ranks, case, kind):
    out, refs = ranks
    want = refs[(case, kind)]["eval"]
    for o in out:
        got = o[(case, kind)]["eval"]
        assert got.keys() == want.keys()
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)


# ------------------------------------------------------------- the drivers

@pytest.mark.parametrize("kind", DRIVERS)
def test_drivers_on_a_space_axis_equal_one_process(ranks, kind, tmp_path):
    out, _ = ranks
    want = run_driver(kind, str(tmp_path))
    for o in out:
        got = o[("driver", kind)]
        np.testing.assert_allclose(got["history"][0]["loss"], want["history"][0]["loss"],
                                   rtol=1e-5)
        assert got["eval"].keys() == want["eval"].keys()
        np.testing.assert_allclose(got["eval"]["loss"], want["eval"]["loss"], rtol=1e-5)
        for k in want["eval"]:
            np.testing.assert_allclose(got["eval"][k], want["eval"][k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)


def test_dryrun_spatial_leg(ranks):
    """dryrun.multichip_rank at n = 4: the data-parallel legs, then the
    (2 x 2) spatial step within 1e-3 of the data-parallel loss."""
    out, _ = ranks
    for o in out:
        d = o["dryrun"]
        assert d["replicas_equal"] and d["psnr"] == d["psnr_restored"]
        assert abs(d["spatial_loss"] - d["loss"]) < 1e-3 * max(abs(d["loss"]), 1.0)


# ------------------------------------------------ the JAX case's rank code

def jax_case_rank(state_dict, grids, sizes, token_mask, cfg):
    """A launch target of tests/test_torch_spatial_jax.py: one MAE step of
    the port on a (1 x 2) mesh from `state_dict`, given the global batch
    and token mask; the loss and the reduced gradients before the clip."""
    with make_mesh(2, device="cpu", n_space=2) as mesh:
        trainer = MAETrainer(cfg, TrainConfig(lr=1e-3), 10, "cpu", mesh)
        state = trainer.init(0)
        state.model.load_state_dict(state_dict)
        grads = {}
        clip = trainer.clip

        def recorded(gs, max_norm):
            grads.update({n: g.clone().numpy() for (n, _), g in
                          zip(state.model.named_parameters(), gs)})
            return clip(gs, max_norm)

        trainer.clip = recorded
        batch = shard_batch({"grids": grids, "sizes": sizes, "mask": token_mask}, mesh)
        mask = batch.pop("mask")  # this rank's slab of the token mask
        _, m = trainer.train_step(state, batch, token_mask=mask)
        return {"loss": float(m["loss"]), "grads": grads,
                "attention_impl": trainer.mae_cfg.swin.attention_impl}
