"""The port's anchor RPN against the JAX package, on the CPU.

NeRFRPN's head outputs, training loss and proposals (AABB and OBB) with the
weights carried across by rpn_params_from_jax; rpn_loss for smooth-L1, iou
and linear_iou on AABB and OBB (with the 2D projection term), values and
gradients w.r.t. the head outputs; rpn_filter_proposals with tied scores;
two RPNTrainer steps from the same weights and draws against the JAX
trainer, then its proposals; the loss falling over steps; and `python -m
nerf_mae_torch.run_rpn` train -> eval -> benchmark on --device cpu. The
samplers' uniforms are JAX's draws, passed in. Tiny config: swin_nano
(embed 12), 32^3 grids, float32. Tolerances: outputs rtol 2e-3 / atol
2e-4, losses rtol 1e-3, selections equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_mae_tpu.config import SWIN_PRESETS as JPRESETS
from nerf_mae_tpu.config import TrainConfig as JTrainConfig
from nerf_mae_tpu.data import datasets as jdata
from nerf_mae_tpu.models import rpn as jrpn
from nerf_mae_tpu.ops import anchors as janchors
from nerf_mae_tpu.train.rpn_trainer import RPNTrainer as JRPNTrainer
from nerf_mae_tpu.train.trainer import TrainState as JTrainState
from nerf_mae_torch import run_mae_pretrain, run_rpn
from nerf_mae_torch.config import SWIN_PRESETS, TrainConfig
from nerf_mae_torch.convert import rpn_params_from_jax
from nerf_mae_torch.models import rpn as trpn
from nerf_mae_torch.ops import anchors
from nerf_mae_torch.train.checkpoint import checkpoint_steps, restore_checkpoint
from nerf_mae_torch.train.rpn_trainer import RPNTrainer

from test_torch_heads import fill_params

torch.set_num_threads(1)

RTOL, ATOL, LOSS_RTOL = 2e-3, 2e-4, 1e-3
WIDTH = 32
NANO = SWIN_PRESETS["swin_nano"]
LR, TOTAL = 1e-4, 10
SMALL = dict(resolution=32, pre_nms_top_n=64, post_nms_top_n=32, max_gt=8,
             batch_size_per_mesh=64)


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol, err_msg=msg)


class _DS:
    def __init__(self, scenes):
        self.scenes = scenes

    def __len__(self):
        return len(self.scenes)

    def __getitem__(self, i):
        return self.scenes[i]


def _batch(obb=False, seed=0):
    scenes = jdata.synthetic_detection_scenes(2, 32, seed=seed, min_size=24, obb=obb)
    return next(jdata.detection_batch_iterator(_DS(scenes), 2, 32, max_gt=8, shuffle=False,
                                               loop=False))


def jax_draws(rng, b, n_anchors):
    """The uniforms rpn_loss draws from `rng`: one vector per scene."""
    return np.stack([np.asarray(jax.random.uniform(k, (n_anchors,)))
                     for k in jax.random.split(rng, b)])


def _n_anchors():
    return anchors.grid_anchors(32, (4, 8, 16, 32))[0].shape[0]


def _models(rotated, reg_loss_type="smooth_l1", seed=3, **kw):
    kw = {**SMALL, "conv_depth": 2, "rotated_bbox": rotated, "reg_loss_type": reg_loss_type,
          **kw}
    jm = jrpn.NeRFRPN(swin=JPRESETS["swin_nano"], rpn=jrpn.RPNConfig(**kw), backbone="swin_nano",
                      out_channels=WIDTH, dtype=jnp.float32, remat=False)
    b = _batch(obb=rotated)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "droppath": jax.random.PRNGKey(1)},
        b["grids"][:1], b["sizes"][:1], b["gt_boxes"][:1], b["gt_valid"][:1], True, True,
        jax.random.PRNGKey(2))["params"])
    params = fill_params(shapes, seed)
    tm = trpn.NeRFRPN(NANO, trpn.RPNConfig(**kw), "swin_nano", WIDTH, dtype=torch.float32,
                      remat=False, device="cpu")
    tm.load_state_dict(rpn_params_from_jax(params, NANO, trpn.RPNConfig(**kw), "swin_nano",
                                           WIDTH))
    return jm, params, tm, b


@pytest.mark.parametrize("rotated", [False, True])
def test_nerf_rpn_matches_jax(rotated):
    """Head outputs; the port's training forward and its proposals against
    JAX's loss (draws passed in) and filter on JAX's head outputs (the
    whole JAX step is held in test_train_steps_and_prediction_match_jax)."""
    jm, params, tm, b = _models(rotated)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    want_obj, want_d = jm.apply({"params": params}, jb["grids"], method=lambda m, g: (
        jrpn._flatten_rpn_outputs(*m.head(m.body(g, True)), m.rpn.delta_dim)))
    with torch.no_grad():
        obj, d = tm.head_outputs(tm.body(t(b["grids"])))
    close(obj, want_obj, msg="objectness")
    close(d, want_d, msg="deltas")

    cfg = jm.rpn
    anc, centers, level_ids, _ = janchors.grid_anchors(32, tuple(cfg.strides))
    av = janchors.anchor_padding_mask(jnp.asarray(centers), jb["sizes"])
    rng = jax.random.PRNGKey(11)
    jol, jrl, jaux = jax.jit(lambda *a: jrpn.rpn_loss(cfg, rng, *a))(
        want_obj, want_d, jnp.asarray(anc), av, jb["gt_boxes"], jb["gt_valid"])
    jtotal = jol + cfg.reg_loss_weight * jrl
    jaux = {"loss_objectness": jol, "loss_reg": jrl, **jaux}
    draws = jax_draws(rng, 2, _n_anchors())
    total, aux = tm(t(b["grids"]), t(b["sizes"]), t(b["gt_boxes"]), t(b["gt_valid"]),
                    training=True, sample_draws=t(draws))
    assert float(aux["num_pos"]) == float(jaux["num_pos"]) > 0
    assert float(aux["num_sampled"]) == float(jaux["num_sampled"])
    for k in ("loss_objectness", "loss_reg"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=LOSS_RTOL)

    want = jax.jit(lambda *a: jrpn.rpn_filter_proposals(cfg, *a[:3], level_ids, *a[3:]))(
        want_obj, want_d, jnp.asarray(anc), av, jb["sizes"])
    with torch.no_grad():
        got = tm(t(b["grids"]), t(b["sizes"]))
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_array_equal(got["levels"].numpy(), np.asarray(want["levels"]))
    close(got["scores"], want["scores"])
    n = int(got["valid"].sum(1).min())
    close(got["boxes"][:, : n // 2, :6], np.asarray(want["boxes"])[:, : n // 2, :6], atol=2e-3)


# a 16^3 grid with two levels keeps the JAX side's eager OBB IoU small
SMALL_GRID = dict(resolution=16, strides=(4, 8), anchor_sizes=((8.0,), (16.0,)))


def _head_outputs(rotated, n_anchors, seed):
    rs = np.random.RandomState(seed)
    obj = rs.randn(2, n_anchors).astype(np.float32)
    deltas = (0.3 * rs.randn(2, n_anchors, 8 if rotated else 6)).astype(np.float32)
    return obj, deltas


def _gt(rotated, seed=8):
    """Boxes in a 16^3 grid (scene 1 cropped, its last box invalid)."""
    rs = np.random.RandomState(seed)
    n = 5
    if rotated:
        gt = np.concatenate([rs.uniform(4, 12, (2, n, 3)), rs.uniform(3, 8, (2, n, 3)),
                             rs.uniform(-1.5, 1.5, (2, n, 1))], -1)
    else:
        lo = rs.uniform(0, 9, (2, n, 3))
        gt = np.concatenate([lo, lo + rs.uniform(3, 7, (2, n, 3))], -1)
    valid = np.ones((2, n), bool)
    valid[1, -1] = False
    sizes = np.array([[16, 16, 16], [14, 15, 13]], np.int32)
    return gt.astype(np.float32), valid, sizes


LOSS_CASES = [(False, "smooth_l1", 0.0), (False, "iou", 0.0), (False, "linear_iou", 0.5),
              (True, "smooth_l1", 0.5), (True, "iou", 0.0), (True, "linear_iou", 0.0)]


@pytest.mark.parametrize("rotated,loss_type,proj2d", LOSS_CASES)
def test_rpn_loss_matches_jax_with_gradients(rotated, loss_type, proj2d):
    kw = dict(**SMALL_GRID, rotated_bbox=rotated, reg_loss_type=loss_type,
              proj2d_loss_weight=proj2d, batch_size_per_mesh=64)
    jcfg, tcfg = jrpn.RPNConfig(**kw), trpn.RPNConfig(**kw)
    anc, centers, _, _ = anchors.grid_anchors(*tcfg.anchor_key())
    obj, deltas = _head_outputs(rotated, anc.shape[0], seed=9)
    gt, gv, sizes = _gt(rotated)
    av = np.asarray(janchors.anchor_padding_mask(jnp.asarray(centers), jnp.asarray(sizes)))
    rng = jax.random.PRNGKey(5)

    def jloss(o, d):
        ol, rl, aux = jrpn.rpn_loss(jcfg, rng, o, d, jnp.asarray(anc), jnp.asarray(av),
                                    jnp.asarray(gt), jnp.asarray(gv))
        return ol + 5.0 * rl, (ol, rl, aux)

    (_, (jol, jrl, jaux)), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(obj), jnp.asarray(deltas))
    to, td = t(obj).requires_grad_(True), t(deltas).requires_grad_(True)
    ol, rl, aux = trpn.rpn_loss(tcfg, to, td, t(anc), t(av), t(gt), t(gv),
                                draws=t(jax_draws(rng, 2, anc.shape[0])))
    (ol + 5.0 * rl).backward()
    assert float(aux["num_pos"]) == float(jaux["num_pos"]) > 0
    assert set(aux) == set(jaux)
    np.testing.assert_allclose(ol.item(), float(jol), rtol=LOSS_RTOL)
    np.testing.assert_allclose(rl.item(), float(jrl), rtol=LOSS_RTOL)
    if proj2d:
        np.testing.assert_allclose(aux["loss_reg_2d"].item(), float(jaux["loss_reg_2d"]),
                                   rtol=LOSS_RTOL)
    for name, x, g in (("objectness", to, jgrads[0]), ("deltas", td, jgrads[1])):
        scale = float(np.abs(np.asarray(g)).max())
        close(x.grad, g, rtol=LOSS_RTOL, atol=1e-4 * scale, msg=f"d{name}")


@pytest.mark.parametrize("rotated", [False, True])
def test_rpn_filter_proposals_matches_jax(rotated):
    kw = dict(**SMALL_GRID, rotated_bbox=rotated, pre_nms_top_n=150, post_nms_top_n=400,
              nms_thresh=0.3)
    anc, centers, level_ids, _ = anchors.grid_anchors(*trpn.RPNConfig(**kw).anchor_key())
    obj, deltas = _head_outputs(rotated, anc.shape[0], seed=10)
    obj[0, 100:140] = 30.0  # saturated scores tie
    _, _, sizes = _gt(rotated)
    av = np.asarray(janchors.anchor_padding_mask(jnp.asarray(centers), jnp.asarray(sizes)))
    want = jax.jit(lambda o, d, a, v, sz: jrpn.rpn_filter_proposals(
        jrpn.RPNConfig(**kw), o, d, a, level_ids, v, sz))(
        jnp.asarray(obj), jnp.asarray(deltas), jnp.asarray(anc), jnp.asarray(av),
        jnp.asarray(sizes))
    got = trpn.rpn_filter_proposals(trpn.RPNConfig(**kw), t(obj), t(deltas), t(anc), t(av),
                                    t(sizes))
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_array_equal(got["levels"].numpy(), np.asarray(want["levels"]))
    close(got["scores"], want["scores"], rtol=1e-5, atol=1e-6)
    wb = np.asarray(want["boxes"])
    close(got["boxes"][..., :6], wb[..., :6], rtol=1e-4, atol=1e-4)
    if rotated:  # a rectangle's angle is defined mod pi
        d = np.abs(got["boxes"][..., 6].numpy() - wb[..., 6]) % np.pi
        assert (np.minimum(d, np.pi - d) < 1e-4).all()
    assert 0 < got["valid"].sum() < got["valid"].numel()


# ---------------------------------------------------------------- trainer


def _jax_trainer_draws(state_rng, step, b, n_anchors):
    """The uniforms the JAX trainer's step `step` draws (its loss rng is
    fold_in(fold_in(rng, step), 7))."""
    return jax_draws(jax.random.fold_in(jax.random.fold_in(state_rng, step), 7), b, n_anchors)


@pytest.fixture(scope="module")
def jax_run():
    cfg = jrpn.RPNConfig(**SMALL, conv_depth=2)
    trainer = JRPNTrainer(JPRESETS["swin_nano"], cfg, JTrainConfig(lr=LR), TOTAL, None,
                          backbone="swin_nano", compute_dtype="float32", remat=False)
    b = _batch()
    shapes = jax.eval_shape(lambda: trainer.model.init(
        {"params": jax.random.PRNGKey(0), "droppath": jax.random.PRNGKey(1)},
        b["grids"][:1], b["sizes"][:1], b["gt_boxes"][:1], b["gt_valid"][:1], True, True,
        jax.random.PRNGKey(2))["params"])
    params = fill_params(shapes, 4)
    rng = jax.random.PRNGKey(0)
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        opt_state=trainer.tx.init(params), rng=rng)
    batch = {k: jnp.asarray(v) for k, v in b.items()}
    steps = []
    for _ in range(2):
        state, m = trainer.train_step(state, batch)
        steps.append({k: float(v) for k, v in m.items()})
    det = {k: np.asarray(v) for k, v in trainer.predict_step(state, batch).items()}
    # the state's key was donated to the step: keep JAX's draws' key by value
    return dict(init=params, steps=steps, params=jax.device_get(state.params), det=det,
                rng=np.asarray(jax.random.PRNGKey(0)))


def _trainer(**kw):
    return RPNTrainer(NANO, trpn.RPNConfig(**{**SMALL, "conv_depth": 2, **kw}),
                      TrainConfig(lr=LR), TOTAL, "cpu", backbone="swin_nano",
                      compute_dtype="float32", remat=False)


def _sd(tree):
    return rpn_params_from_jax(tree, NANO, trpn.RPNConfig(**SMALL, conv_depth=2), "swin_nano")


def test_train_steps_and_prediction_match_jax(jax_run):
    trainer = _trainer()
    state = trainer.init(0)
    state.model.load_state_dict(_sd(jax_run["init"]))
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    for i, want in enumerate(jax_run["steps"]):
        draws = _jax_trainer_draws(jnp.asarray(jax_run["rng"]), i, 2, _n_anchors())
        state, m = trainer.train_step(state, batch, sample_draws=t(draws))
        assert set(m) == set(want)
        assert float(m["num_pos"]) == want["num_pos"] > 0
        for k in want:
            np.testing.assert_allclose(float(m[k]), want[k], rtol=LOSS_RTOL, atol=1e-6,
                                       err_msg=f"step {i} {k}")
    ref = _sd(jax_run["params"])
    for name, prm in state.model.named_parameters():
        close(prm, ref[name].numpy(), rtol=1e-3, atol=2e-4, msg=name)
    det = trainer.predict_step(state, batch)
    want = jax_run["det"]
    np.testing.assert_array_equal(det["valid"].numpy(), want["valid"])
    close(det["scores"], want["scores"])
    n = int(det["valid"].sum(1).min())
    close(det["boxes"][:, : n // 2], want["boxes"][:, : n // 2], atol=2e-3)


@pytest.mark.parametrize("rotated", [False, True])
def test_rpn_trainer_steps_decrease_the_loss(rotated):
    """tests/test_rpn.py's check on the port: 8 steps on one batch."""
    trainer = RPNTrainer(NANO, trpn.RPNConfig(**SMALL, rotated_bbox=rotated), TrainConfig(),
                         20, "cpu", backbone="swin_nano", compute_dtype="float32", remat=False)
    state = trainer.init(0)
    batch = {k: torch.from_numpy(v) for k, v in _batch(obb=rotated).items()}
    losses = []
    for _ in range(8):
        state, m = trainer.train_step(state, batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert float(m["num_pos"]) > 0
    det = trainer.predict_step(state, batch)
    assert tuple(det["boxes"].shape) == (2, 32, 7 if rotated else 6)
    s = det["scores"].numpy()
    assert (s[:, :-1] >= s[:, 1:]).all()


# ------------------------------------------------------------------- CLI

TINY = ["--backbone_type", "swin_nano", "--resolution", "32", "--batch_size", "2",
        "--compute_dtype", "float32", "--device", "cpu", "--max_gt", "8"]
TINY_RPN = [*TINY, "--rpn_pre_nms_top_n", "64", "--rpn_post_nms_top_n", "32",
            "--rpn_batch_size_per_mesh", "64"]


@pytest.fixture(scope="module")
def mae_ckpt(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("mae") / "ckpt")
    run_mae_pretrain.main(["--mode", "train", "--dataset", "synthetic", "--n_synthetic", "2",
                           *TINY[:10], "--steps", "1", "--checkpoint_dir", ckpt])
    return ckpt


@pytest.mark.parametrize("rotated", [False, True])
def test_run_rpn_end_to_end(mae_ckpt, tmp_path, rotated):
    """train (grafted; the best recall50_top2500 checkpoint at the eval) ->
    eval from the checkpoint -> benchmark."""
    common = ["--dataset", "synthetic", "--n_synthetic", "4", *TINY_RPN,
              *(["--rotated_bbox", "--reg_loss_type", "iou"] if rotated else [])]
    ckpt = str(tmp_path / "rpn")
    out = run_rpn.main(["--mode", "train", *common, "--steps", "2", "--mae_checkpoint", mae_ckpt,
                        "--checkpoint_dir", ckpt, "--log_interval", "1", "--eval_interval", "1"])
    assert [h["step"] for h in out["history"]] == [1, 2]
    assert all(np.isfinite(h["loss"]) and h["num_pos"] > 0 for h in out["history"])
    assert checkpoint_steps(ckpt)[-1] == 2
    assert "recall50_top2500" in restore_checkpoint(ckpt, checkpoint_steps(ckpt)[0])["extra"]
    sd = restore_checkpoint(ckpt)["params"]
    assert {k for k in sd if k.startswith("head.conv")} == {
        "head.conv0.weight", "head.conv0.bias", "head.conv1.weight", "head.conv1.bias"}
    agg = run_rpn.main(["--mode", "eval", *common, "--checkpoint", ckpt])
    assert {"recall25_top300", "recall50_top2500", "ar_top1000", "ap25", "ap50", "ap75"} <= set(agg)
    assert all(0 <= v <= 1 for v in agg.values())
    bench = run_rpn.main(["--mode", "benchmark", *common, "--checkpoint", ckpt])
    kind = "obb" if rotated else "aabb"
    assert bench["metric"] == f"predict_ms_rpn_{kind}_swin_nano_32"
    assert bench["ms"] > 0 and 0 < bench["proposals_per_scene"] <= 32


def test_run_rpn_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_rpn.main(["--mode", "train", "--dataset", "synthetic", "--steps", "1",
                      *[a if a != "cpu" else "cuda" for a in TINY_RPN]])
