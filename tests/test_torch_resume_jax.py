"""Taking over a run of the JAX package in the port, on the CPU.

For each model family (the MAE, SR, semantics, FCOS, the anchor RPN and the
RCNN) the optimizer of the JAX trainers (nerf_mae_tpu/train/optim.py
make_optimizer: the clip, AdamW, OneCycle) takes two updates from numpy
gradients (a compiled JAX train step would take ~50 s a model; the updates
run on the raveled tree, raveled_step), and the JAX
save_checkpoint writes the state at step directory 1: a JAX run resumed
once writes such a step, since its loop restarts while its schedule's count
goes on. `tools.orbax_to_npz --state` converts it and the port's driver
restores it through its own restore path (`--checkpoint state.npz`, train
mode; the parameters and state are taken where restore_state returns). The
parameters and AdamW moments arrive bitwise, each moment laid out as its
parameter, the step is 1 and the optimizer's count 2. Then both sides take one more update from the same
numpy gradients: the lr is JAX's schedule at count 2, and the parameters
and moments match to rtol 1e-5 / atol 1e-7 (float32). The restored model's
loss matches JAX's forward of the same parameters at the golden loss
tolerance (rtol 1e-3).

Also: the tool's refusals and its imports, the moments mapping's refusals,
an orbax directory refused by --checkpoint and --mae_checkpoint with the
tool named, mae_params_to_jax against the JAX tree, and run_nerf --task
extract from the JAX driver's pickle, with a foreign class refused. Tiny
config: swin_nano, 32^3, float32, batch 2, 10 steps in all; the FCOS
towers one 3^3 conv deep.
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_mae_tpu.config import SWIN_PRESETS as JPRESETS
from nerf_mae_tpu.config import MAEConfig as JMAEConfig
from nerf_mae_tpu.config import TrainConfig as JTrainConfig
from nerf_mae_tpu.data import datasets as jdata
from nerf_mae_tpu.models import fcos as jfcos
from nerf_mae_tpu.models import mae as jmae
from nerf_mae_tpu.models import rcnn as jrcnn
from nerf_mae_tpu.models import rpn as jrpn
from nerf_mae_tpu.train.checkpoint import save_checkpoint
from nerf_mae_tpu.train.det_trainer import DetectionTrainer as JDetectionTrainer
from nerf_mae_tpu.train.head_trainer import VoxelSemanticsTrainer as JSemTrainer
from nerf_mae_tpu.train.head_trainer import VoxelSRTrainer as JSRTrainer
from nerf_mae_tpu.train.optim import make_optimizer, make_schedule
from nerf_mae_tpu.train.rpn_trainer import RPNTrainer as JRPNTrainer
from nerf_mae_tpu.train.trainer import TrainState as JTrainState
from nerf_mae_torch import (common, run_fcos, run_mae_pretrain, run_nerf, run_rpn,
                            run_rpn_detect, run_voxel_semantics, run_voxel_sr)
from nerf_mae_torch.config import SWIN_PRESETS, MAEConfig, TrainConfig
from nerf_mae_torch.convert import (mae_params_to_jax, nerf_params_from_jax, params_from_jax,
                                    read_npz)
from nerf_mae_torch.models.mae import SwinMAE3D, init_weights
from nerf_mae_torch.tools import orbax_to_npz
from nerf_mae_torch.train.checkpoint import load_jax_state, restore_checkpoint
from nerf_mae_torch.train.optim import update_count
from nerf_mae_torch.train.rpn_trainer import RPNTrainer

from test_torch_heads import fill_params
from test_torch_rpn import _n_anchors, jax_draws
from test_torch_run_nerf import _jax_params as nerf_jax_params
from test_torch_run_nerf import _npz, write_scene

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR, TOTAL = 1e-3, 10
TRAIN = JTrainConfig(lr=LR, weight_decay=1e-3, clip_grad_norm=0.1)
JCFG = JMAEConfig(swin=JPRESETS["swin_nano"], resolution=32, compute_dtype="float32",
                  remat=False)
COMMON = ["--mode", "train", "--backbone_type", "swin_nano", "--resolution", "32",
          "--batch_size", "2", "--steps", str(TOTAL), "--lr", str(LR), "--weight_decay", "1e-3",
          "--clip_grad_norm", "0.1", "--compute_dtype", "float32", "--device", "cpu",
          "--dataset", "synthetic", "--n_synthetic", "2", "--workers", "0", "--prefetch", "0"]
DET = ["--max_gt", "8"]
FLAGS = {
    "mae": (run_mae_pretrain, []),
    "sr": (run_voxel_sr, ["--out_resolution", "48"]),
    "semantics": (run_voxel_semantics, ["--num_classes", "5"]),
    "fcos": (run_fcos, DET + ["--rotated_bbox", "--iou_loss_type", "iou", "--pre_nms_top_n",
                              "60", "--fpn_post_nms_top_n", "40", "--num_convs", "1"]),
    "rpn": (run_rpn, DET + ["--rpn_pre_nms_top_n", "64", "--rpn_post_nms_top_n", "32",
                            "--rpn_batch_size_per_mesh", "64"]),
    "rcnn": (run_rpn_detect, DET + ["--proposals_per_scene", "32", "--rois_per_scene", "8"]),
}
J = jnp.asarray


class _DS:
    def __init__(self, scenes):
        self.scenes = scenes

    def __len__(self):
        return len(self.scenes)

    def __getitem__(self, i):
        return self.scenes[i]


def det_batch(obb):
    scenes = jdata.synthetic_detection_scenes(2, 32, seed=0, min_size=24, obb=obb)
    return next(jdata.detection_batch_iterator(_DS(scenes), 2, 32, max_gt=8, shuffle=False,
                                               loop=False))


def dense_batch(kind):
    rs = np.random.RandomState(0)
    grids = rs.rand(2, 32, 32, 32, 4).astype(np.float32)
    grids[..., 3] *= rs.rand(2, 32, 32, 32) > 0.5
    if kind == "sr":
        out = rs.rand(2, 48, 48, 48, 4).astype(np.float32)
        out[..., 3] *= rs.rand(2, 48, 48, 48) > 0.5
        return {"grids": grids, "out_grids": out}
    if kind == "semantics":
        return {"grids": grids, "semantics": rs.randint(0, 5, (2, 32, 32, 32)).astype(np.int32)}
    return {"grids": grids, "sizes": np.array([[32, 32, 32], [29, 31, 17]], np.int32),
            "mask": rs.rand(2, 8, 8, 8) < 0.6}


def rcnn_inputs():
    """Random FPN features (256 wide, the driver's), GT boxes and proposals
    jittered around them (AABB), and the sampler's key."""
    rs = np.random.RandomState(5)
    feats = [rs.rand(2, s, s, s, 256).astype(np.float32) for s in (8, 4, 2, 1)]
    lo = rs.uniform(2, 16, (2, 4, 3))
    gt = np.concatenate([lo, lo + rs.uniform(5, 12, lo.shape)], -1).astype(np.float32)
    gv = np.ones((2, 4), bool)
    props = gt[:, rs.randint(0, 4, 24)] + rs.uniform(-1.5, 1.5, (2, 24, 6))
    return feats, gt, gv, props.astype(np.float32), np.ones((2, 24), bool)


class Family:
    """A JAX model of one family, its parameter tree from a seed, and its
    loss on a fixed batch (jitted: one compile), with the port's loss of
    the same batch from a restored state."""

    def __init__(self, name, args):
        self.name, self.args = name, args
        init_rngs = {"params": jax.random.PRNGKey(0), "droppath": jax.random.PRNGKey(1)}
        if name == "mae":
            self.model = jmae.SwinMAE3D(JCFG)
            init = lambda: self.model.init(  # noqa: E731
                {**init_rngs, "mask": jax.random.PRNGKey(2)}, jnp.zeros((1, 32, 32, 32, 4)),
                True)
        elif name in ("sr", "semantics"):
            kw = ({"out_resolution": 48} if name == "sr" else {"num_classes": 5})
            self.trainer = (JSRTrainer if name == "sr" else JSemTrainer)(
                JCFG, TRAIN, TOTAL, None, **kw)
            self.model = self.trainer.model
            init = lambda: self.model.init(init_rngs, jnp.zeros((1, 32, 32, 32, 4)), True)  # noqa
        elif name in ("fcos", "rpn"):
            b = det_batch(obb=name == "fcos")  # its box width
            if name == "fcos":
                cfg = jfcos.FCOSConfig(**dataclasses.asdict(run_fcos.fcos_config(args)))
                trainer = JDetectionTrainer(JPRESETS["swin_nano"], cfg, TRAIN, TOTAL, None,
                                            backbone="swin_nano", compute_dtype="float32",
                                            remat=False)
                extra = ()
            else:
                cfg = jrpn.RPNConfig(**dataclasses.asdict(run_rpn.rpn_config(args)))
                trainer = JRPNTrainer(JPRESETS["swin_nano"], cfg, TRAIN, TOTAL, None,
                                      backbone="swin_nano", compute_dtype="float32",
                                      remat=False)
                extra = (jax.random.PRNGKey(2),)
            self.model = trainer.model
            init = lambda: self.model.init(  # noqa: E731
                init_rngs, jnp.zeros((1, 32, 32, 32, 4)), jnp.full((1, 3), 32),
                jnp.zeros((1, 8, b["gt_boxes"].shape[-1])), jnp.zeros((1, 8), bool), True,
                True, *extra)
        else:
            self.model = jrcnn.RCNNStage(jrcnn.RCNNConfig(
                **dataclasses.asdict(run_rpn_detect.rcnn_config(args))))
            feats, gt, gv, props, pv = rcnn_inputs()
            key = jax.random.PRNGKey(3)
            init = lambda: self.model.init(  # noqa: E731
                {"params": key}, [J(f) for f in feats], J(props), J(pv), J(gt), J(gv), key,
                True)
        shapes = jax.eval_shape(init)["params"]
        self.params = fill_params(shapes, 3)
        if name == "fcos":
            self.params["head"]["scales"] = np.float32(1) + 0.1 * np.arange(4, dtype=np.float32)

    def jax_loss(self, params):
        m = self.model
        if self.name == "mae":
            b = dense_batch("mae")

            @jax.jit
            def loss(p):
                pred, _ = m.apply({"params": p}, J(b["grids"]), True, token_mask=J(b["mask"]))
                return jmae.mae_loss(pred, J(b["grids"]), J(b["mask"]), J(b["sizes"]), JCFG)[0]

            return float(loss(params))
        if self.name in ("sr", "semantics"):
            b = {k: J(v) for k, v in dense_batch(self.name).items()}
            state = JTrainState(step=0, params=params, opt_state=None, rng=None)
            return float(self.trainer.eval_step(state, b)["loss"])
        if self.name in ("fcos", "rpn"):
            b = det_batch(obb=self.name == "fcos")
            extra = (jax.random.PRNGKey(11),) if self.name == "rpn" else ()
            loss = jax.jit(lambda p: m.apply({"params": p}, J(b["grids"]), J(b["sizes"]),
                                             J(b["gt_boxes"]), J(b["gt_valid"]), True, True,
                                             *extra)[0])
            return float(loss(params))
        feats, gt, gv, props, pv = rcnn_inputs()
        return float(jax.jit(lambda p: m.apply(
            {"params": p}, [J(f) for f in feats], J(props), J(pv), J(gt), J(gv),
            jax.random.PRNGKey(3), True)[0])(params))

    @torch.no_grad()
    def port_loss(self, trainer, state):
        t = torch.from_numpy
        model = state.model
        if self.name == "mae":
            b = dense_batch("mae")
            batch = {"grids": t(b["grids"]), "sizes": t(b["sizes"])}
            return float(trainer._losses(model, batch, True, None, None, t(b["mask"]))[0])
        if self.name in ("sr", "semantics"):
            batch = {k: t(v) for k, v in dense_batch(self.name).items()}
            return float(trainer.eval_step(state, batch)["loss"])
        if self.name in ("fcos", "rpn"):
            b = {k: t(v) for k, v in det_batch(obb=self.name == "fcos").items()}
            kw = {}
            if self.name == "rpn":
                kw["sample_draws"] = t(jax_draws(jax.random.PRNGKey(11), 2, _n_anchors()))
            return float(model(b["grids"], b["sizes"], b["gt_boxes"], b["gt_valid"],
                               deterministic=True, training=True, **kw)[0])
        feats, gt, gv, props, pv = rcnn_inputs()
        draws = np.stack([np.asarray(jax.random.uniform(k, (24,)))
                          for k in jax.random.split(jax.random.PRNGKey(3), 2)])
        return float(model([t(f) for f in feats], t(props), t(pv), t(gt), t(gv),
                           draws=t(draws), training=True)[0])


def numpy_grads(params, seed, norm=0.05):
    """Gradients drawn from a seed, scaled to a global norm under the clip's
    0.1, so that neither side rescales them: under jit on the CPU the JAX
    clip's float32 sum of squares is off by up to 4% for the detection
    models' 256-wide 3^3 convs (2073.4 for 2159.9), while the port's is
    within 5e-5."""
    rs = np.random.RandomState(seed)
    grads = jax.tree.map(lambda p: rs.randn(*np.shape(p)), params)
    scale = norm / np.sqrt(sum(float((g ** 2).sum()) for g in jax.tree.leaves(grads)))
    return jax.tree.map(lambda g: (scale * g).astype(np.float32), grads)


def flat_shapes(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def raveled_step(like):
    """One update of the JAX trainers' optimizer, (params, opt_state, grads)
    -> (params, opt_state) on trees shaped as `like`, taken on the tree
    raveled into one vector: the chain is elementwise but for the clip's
    global norm, which numpy_grads stays under, so every leaf steps as in
    the tree. Jitted on the tree, the update takes ~3.5 s of tracing and
    compiling a model; on one vector, a small fraction of that."""
    tx = make_optimizer(TRAIN, TOTAL)
    leaves, treedef = jax.tree.flatten(like)
    assert {np.asarray(v).dtype for v in leaves} == {np.dtype(np.float32)}
    ends = np.cumsum([np.size(v) for v in leaves])[:-1]

    def ravel(t):
        return jax.tree.map(lambda x: np.concatenate([np.ravel(v) for v in jax.tree.leaves(x)])
                            if isinstance(x, dict) else x, t,
                            is_leaf=lambda x: isinstance(x, dict))

    def unravel(t):
        return jax.tree.map(lambda x: jax.tree.unflatten(treedef, [
            v.reshape(np.shape(w)) for v, w in zip(np.split(x, ends), leaves)])
            if np.ndim(x) else x, jax.device_get(t))

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    def step(params, opt_state, grads):
        return unravel(update(ravel(grads), ravel(opt_state), ravel(params)))

    return step


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Per family, built on first use: the Family, the JAX state after two
    updates (saved at step directory 1, converted with --state) and the
    optimizer."""
    root = tmp_path_factory.mktemp("jax_runs")
    runs = {}

    def get(name):
        if name in runs:
            return runs[name]
        module, flags = FLAGS[name]
        fam = Family(name, module.parse_args(COMMON + flags))
        step = raveled_step(fam.params)
        params, opt_state = fam.params, make_optimizer(TRAIN, TOTAL).init(fam.params)
        for seed in (1, 2):
            params, opt_state = step(params, opt_state, numpy_grads(params, seed))
        ckpt = str(root / f"{name}_ckpt")
        save_checkpoint(ckpt, 1, params, opt_state, extra={"loss": 0.5})
        npz = str(root / f"{name}_state.npz")
        orbax_to_npz.main([ckpt, "--state", "--out", npz])
        runs[name] = dict(fam=fam, step=step, params=params, opt_state=opt_state, ckpt=ckpt,
                          npz=npz)
        return runs[name]

    return get


class _Restored(Exception):
    pass


def restored_by_driver(module, argv, monkeypatch):
    """(trainer, state) as the driver's main restores them: restore_state
    is wrapped to stop the driver right after it returns."""
    real = common.restore_state
    got = {}

    def stop_after(args, trainer, state):
        got.update(trainer=trainer, state=real(args, trainer, state))
        raise _Restored

    monkeypatch.setattr(common, "restore_state", stop_after)
    if hasattr(module, "restore_state"):
        monkeypatch.setattr(module, "restore_state", stop_after)
    with pytest.raises(_Restored):
        module.main(argv)
    return got["trainer"], got["state"]


def _moments(state, what):
    return {n: state.optimizer.state[p][what] for n, p in state.model.named_parameters()}


def _assert_close(got, want, what, **tol):
    assert set(got) == set(want), what
    for k, v in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), v.numpy(), err_msg=f"{what} {k}",
                                   **tol)


@pytest.mark.parametrize("name", list(FLAGS))
def test_a_jax_run_resumes_in_the_drivers(name, jax_runs, monkeypatch):
    run = jax_runs(name)
    module, flags = FLAGS[name]
    if name == "rcnn":  # the frozen first stage from the JAX RPN's state
        flags = flags + ["--rpn_checkpoint", jax_runs("rpn")["npz"]]
    trainer, state = restored_by_driver(module, COMMON + flags + ["--checkpoint", run["npz"]],
                                        monkeypatch)
    adam = run["opt_state"][1][0]
    want_mu, want_nu = trainer.params_from_jax(adam.mu), trainer.params_from_jax(adam.nu)
    for what, got, want in (("params", state.model.state_dict(),
                             trainer.params_from_jax(run["params"])),
                            ("mu", _moments(state, "exp_avg"), want_mu),
                            ("nu", _moments(state, "exp_avg_sq"), want_nu)):
        _assert_close(got, want, what, rtol=0, atol=0)
    assert state.step == 1 and update_count(state.optimizer) == 2 == int(adam.count)
    for n, p in state.model.named_parameters():  # laid out as the parameter, as a fresh step's
        for what in ("exp_avg", "exp_avg_sq"):
            assert state.optimizer.state[p][what].stride() == p.stride(), (n, what)
    assert load_jax_state(run["npz"], state.model, state.optimizer,
                          trainer.params_from_jax)["extra"] == {"loss": 0.5}

    fam = run["fam"]
    np.testing.assert_allclose(fam.port_loss(trainer, state), fam.jax_loss(run["params"]),
                               rtol=1e-3, err_msg="the restored model's loss")

    grads = numpy_grads(run["params"], 3)
    params, opt_state = run["step"](run["params"], run["opt_state"], grads)
    port_grads = trainer.params_from_jax(grads)
    for n, p in state.model.named_parameters():
        p.grad = port_grads[n]
    trainer.apply_gradients(state)
    schedule = make_schedule(TRAIN, TOTAL)
    assert float(schedule(2)) != float(schedule(1))
    np.testing.assert_allclose(state.optimizer.param_groups[0]["lr"], float(schedule(2)),
                               rtol=1e-6)
    assert state.step == 2 and update_count(state.optimizer) == 3
    adam = opt_state[1][0]
    tol = dict(rtol=1e-5, atol=1e-7)
    _assert_close(dict(state.model.named_parameters()), trainer.params_from_jax(params),
                  "params after the update", **tol)
    _assert_close(_moments(state, "exp_avg"), trainer.params_from_jax(adam.mu), "mu", **tol)
    _assert_close(_moments(state, "exp_avg_sq"), trainer.params_from_jax(adam.nu), "nu",
                  **tol)
    if name == "rcnn":  # the first stage holds the JAX RPN's parameters, at its depth 2
        rpn = run_rpn_detect.frozen_rpn(run_rpn_detect.parse_args(COMMON + flags),
                                        torch.device("cpu"))
        rpn_args = run_rpn.parse_args(COMMON + FLAGS["rpn"][1])
        ref = RPNTrainer(SWIN_PRESETS["swin_nano"], run_rpn.rpn_config(rpn_args), TrainConfig(),
                         1, "cpu", backbone="swin_nano")
        assert rpn.model.rpn.conv_depth == 2
        _assert_close(rpn.model.state_dict(), ref.params_from_jax(jax_runs("rpn")["params"]),
                      "frozen RPN", rtol=0, atol=0)


def test_the_state_tool_imports_neither_jax_nor_orbax(jax_runs, tmp_path):
    ckpt = jax_runs("mae")["ckpt"]
    out = str(tmp_path / "s.npz")
    code = (
        "import sys\n"
        "from nerf_mae_torch.tools import orbax_to_npz\n"
        f"orbax_to_npz.main([{ckpt!r}, '--state', '--out', {out!r}])\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules}\n"
        "             & {'jax', 'jaxlib', 'flax', 'optax', 'orbax', 'nerf_mae_tpu'})\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "clean" in res.stdout
    got, want = read_npz(out), read_npz(jax_runs("mae")["npz"])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(got["step"]) == 1 and int(got["opt_state/count"]) == 2
    assert int(got["schedule_count"]) == 2


def test_the_state_tool_refuses_other_optimizers_and_split_counts(tmp_path):
    params = {"w": np.ones((2, 3), np.float32), "b": np.zeros(3, np.float32)}
    sgd = optax.sgd(0.1, momentum=0.9)
    save_checkpoint(str(tmp_path / "sgd"), 1, params, sgd.init(params))
    with pytest.raises(ValueError, match="chain\\(clip, adamw\\).*opt_state"):
        orbax_to_npz.convert(str(tmp_path / "sgd"), str(tmp_path / "s.npz"), state=True)
    tx = make_optimizer(TRAIN, TOTAL)
    clip, (adam, wd, sched) = tx.init(params)
    split = (clip, (adam, wd, sched._replace(count=jnp.asarray(5, jnp.int32))))
    save_checkpoint(str(tmp_path / "split"), 1, params, split)
    with pytest.raises(ValueError, match="count 0 and opt_state/1/2/count 5 differ"):
        orbax_to_npz.convert(str(tmp_path / "split"), str(tmp_path / "s.npz"), state=True)
    save_checkpoint(str(tmp_path / "bare"), 1, params)
    with pytest.raises(ValueError, match="no optimizer leaf"):
        orbax_to_npz.convert(str(tmp_path / "bare"), str(tmp_path / "s.npz"), state=True)
    # without --state the parameters alone, as before
    assert orbax_to_npz.convert(str(tmp_path / "bare"), str(tmp_path / "p.npz")) == (1, 2)


def test_missing_or_left_over_moments_raise_naming_the_key(jax_runs, tmp_path):
    run = jax_runs("mae")
    flat_state = read_npz(run["npz"])
    cfg = MAEConfig(swin=SWIN_PRESETS["swin_nano"], resolution=32, compute_dtype="float32")
    model = SwinMAE3D(cfg, device="cpu")
    opt = torch.optim.AdamW(model.parameters())
    key = "encoder/stage0_block0/qkv_kernel"
    for what, edit, match in (
            ("missing", lambda f: f.pop(f"opt_state/mu/{key}"), "opt_state mu.*attn.qkv.weight"),
            ("left over", lambda f: f.update({"opt_state/nu/encoder/extra": np.ones(3)}),
             "opt_state nu.*encoder/extra")):
        f = dict(flat_state)
        edit(f)
        path = str(tmp_path / f"{what.replace(' ', '_')}.npz")
        np.savez(path, **f)
        with pytest.raises(KeyError, match=match):
            load_jax_state(path, model, opt, lambda t: params_from_jax(t, cfg))
    # a parameter outside the optimizer keeps no state; its moments are left over
    frozen = torch.optim.AdamW([p for n, p in model.named_parameters() if n != "mask_token"])
    with pytest.raises(KeyError, match="mask_token"):
        load_jax_state(run["npz"], model, frozen, lambda t: params_from_jax(t, cfg))


def test_orbax_directories_are_refused_naming_the_tool(jax_runs, tmp_path):
    ckpt = jax_runs("mae")["ckpt"]
    for module, flags in (FLAGS["mae"], FLAGS["sr"]):
        with pytest.raises(ValueError, match="orbax_to_npz .* --state"):
            module.main(COMMON + flags + ["--checkpoint", ckpt])
    with pytest.raises(ValueError, match="orbax_to_npz .* --state"):
        run_voxel_sr.main(COMMON + FLAGS["sr"][1] + ["--mae_checkpoint", ckpt])
    params_only = str(tmp_path / "p.npz")
    orbax_to_npz.main([ckpt, "--out", params_only])
    with pytest.raises(ValueError, match="--state"):
        run_mae_pretrain.main(COMMON + ["--checkpoint", params_only])
    # --mae_checkpoint reads either .npz: the same weights
    cfg = MAEConfig(swin=SWIN_PRESETS["swin_nano"], resolution=32)
    a = common.load_mae_params(params_only, cfg)
    b = common.load_mae_params(jax_runs("mae")["npz"], cfg)
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_mae_params_to_jax_inverts_params_from_jax():
    cfg = MAEConfig(swin=SWIN_PRESETS["swin_nano"], resolution=32, compute_dtype="float32")
    sd = init_weights(SwinMAE3D(cfg, device="cpu"), 0).state_dict()
    tree = mae_params_to_jax(sd, cfg)
    shapes = jax.eval_shape(lambda: jmae.SwinMAE3D(JCFG).init(
        {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
        jnp.zeros((1, 32, 32, 32, 4)), True)["params"])
    want = {k: v.shape for k, v in flat_shapes(shapes).items()}
    assert {k: v.shape for k, v in tree.items()} == want
    back = params_from_jax(tree, cfg)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    with pytest.raises(KeyError, match="unexpected"):
        mae_params_to_jax({**sd, "stages.9.0.norm.weight": torch.ones(1)}, cfg)


class Foreign:
    """A class that no parameter tree holds."""


def test_run_nerf_extracts_from_the_jax_pickle(tmp_path):
    """The pickle of scripts/run_nerf.py --params_out, extracted by the port
    in a process that imports neither jax nor flax, gives the grid of the
    same tree through nerf_params_from_jax, bitwise; the tree pickled at
    protocol 5 (arrays rebuilt by numpy's _frombuffer) loads as at protocol
    4 (_reconstruct); a foreign class in a pickle is refused by name."""
    d = write_scene(str(tmp_path / "scene"), ngp=True)
    jp = nerf_jax_params()
    for protocol in (4, 5):
        with open(tmp_path / f"jax{protocol}.pkl", "wb") as f:
            pickle.dump(jax.device_get(jp), f, protocol=protocol)
    flags = ["--task", "extract", "--scene_dir", d, "--scene_id", "s", "--ngp_frame",
             "--max_res", "8", "--device", "cpu"]
    trainer = run_nerf.make_trainer(run_nerf.parse_args(flags), 1.0, torch.device("cpu"))
    params, _ = trainer.init(0, n_views=3)
    torch.save(nerf_params_from_jax(jp, params), tmp_path / "port.pt")
    run_nerf.main(flags + ["--params_out", str(tmp_path / "port.pt"), "--extract_dir",
                           str(tmp_path / "port")])
    argv = flags + ["--params_out", str(tmp_path / "jax5.pkl"), "--extract_dir",
                    str(tmp_path / "jax")]
    code = ("import sys\n"
            "from nerf_mae_torch import run_nerf\n"
            f"run_nerf.main({argv!r})\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax'})\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    got, want = _npz(tmp_path / "jax" / "s.npz"), _npz(tmp_path / "port" / "s.npz")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    p4, p5 = (run_nerf.load_params(str(tmp_path / f"jax{n}.pkl"), params) for n in (4, 5))
    assert set(p4) == set(p5)
    for k in p4:
        assert torch.equal(p4[k], p5[k]), k

    with open(tmp_path / "bad.pkl", "wb") as f:
        pickle.dump({"coarse": Foreign()}, f)
    with pytest.raises(pickle.UnpicklingError, match="Foreign is not part of a numpy"):
        run_nerf.load_params(str(tmp_path / "bad.pkl"), params)


def test_chip_smokes_jax_layout_state_is_what_the_tool_writes(jax_runs, tmp_path):
    """chip_smoke's phase 20 writes a port checkpoint as a JAX state .npz:
    its keys, shapes and dtypes are those the tool writes of the JAX
    trainer's checkpoint of the same model, and it restores the port's own
    state bitwise."""
    import chip_smoke

    ckpt = str(tmp_path / "ckpt")
    run_mae_pretrain.main(COMMON[:COMMON.index("--steps")] + COMMON[COMMON.index("--lr"):]
                          + ["--steps", "2", "--checkpoint_dir", ckpt])
    npz = str(tmp_path / "state.npz")
    cfg = MAEConfig(swin=SWIN_PRESETS["swin_nano"], resolution=32, compute_dtype="float32")
    assert chip_smoke.write_jax_state(ckpt, npz, cfg) == 2
    got, want = read_npz(npz), read_npz(jax_runs("mae")["npz"])
    assert {k: (v.shape, v.dtype) for k, v in got.items()} == {
        k: (v.shape, v.dtype) for k, v in want.items() if k != "extra"}
    own = restore_checkpoint(ckpt)
    model = SwinMAE3D(cfg, device="cpu")
    opt = torch.optim.AdamW(model.parameters())
    restored = load_jax_state(npz, model, opt, lambda t: params_from_jax(t, cfg))
    assert restored["step"] == own["step"] == 2
    assert all(torch.equal(restored["params"][k], v) for k, v in own["params"].items())
    for i, s in own["opt_state"]["state"].items():
        for k, v in s.items():
            assert torch.equal(restored["opt_state"]["state"][i][k], v), (i, k)
