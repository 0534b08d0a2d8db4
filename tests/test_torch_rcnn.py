"""The port's RCNN second stage against the JAX package, on the CPU.

sample_rois (the case of tests/test_rcnn.py and a batched OBB case with
ties in the draws), RCNNStage's training loss (AABB and OBB, with
degenerate RoIs) and its gradients, and its eval outputs, with the weights
carried across by rcnn_params_from_jax; the loss falling over steps; and
`python -m nerf_mae_torch.run_rpn_detect` train -> eval from a `run_rpn`
checkpoint of head depth 2, whose proposals equal run_rpn's on the same
batch (the JAX driver rebuilds the RPN at depth 1 and drops the trained
conv1), with any other mismatch raising. The samplers' uniforms are JAX's
draws, passed in. Tolerances: outputs rtol 2e-3 / atol 2e-4, losses rtol
1e-3, selections equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_mae_tpu.models import rcnn as jrcnn
from nerf_mae_torch import run_rpn, run_rpn_detect
from nerf_mae_torch.config import TrainConfig
from nerf_mae_torch.convert import rcnn_params_from_jax
from nerf_mae_torch.models import rcnn as trcnn
from nerf_mae_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from nerf_mae_torch.train.rpn_trainer import RCNNTrainer, RPNTrainer

from test_torch_heads import fill_params

torch.set_num_threads(1)

RTOL, ATOL, LOSS_RTOL = 2e-3, 2e-4, 1e-3
C = 16


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=msg)


def _sample_both(cfg_kw, props, pv, gt, gv, draws):
    """JAX's sample_rois per scene on `draws` (its uniform replaced by them)
    against the port's, batched."""
    want = []
    for i in range(props.shape[0]):
        orig = jax.random.uniform
        jax.random.uniform = lambda key, shape: jnp.asarray(draws[i])
        try:
            want.append([np.asarray(x) for x in jrcnn.sample_rois(
                jax.random.PRNGKey(0), jrcnn.RCNNConfig(**cfg_kw), jnp.asarray(props[i]),
                jnp.asarray(pv[i]), jnp.asarray(gt[i]), jnp.asarray(gv[i]))])
        finally:
            jax.random.uniform = orig
    got = trcnn.sample_rois(trcnn.RCNNConfig(**cfg_kw), t(props), t(pv), t(gt), t(gv),
                            draws=t(draws))
    for name, g, w in zip(("sel", "labels", "matched", "sel_valid"), got, zip(*want)):
        np.testing.assert_array_equal(g.numpy(), np.stack(w), err_msg=name)
    return [g.numpy() for g in got]


def test_sample_rois_case_of_the_jax_tests():
    """2 perfect, 2 far, 1 mid-IoU (ignored) and 1 invalid proposal."""
    props = np.array([[0, 0, 0, 10, 10, 10], [0, 0, 0, 10, 10, 10], [45, 45, 45, 55, 55, 55],
                      [55, 55, 55, 65, 65, 65], [3, 3, 3, 13, 13, 13], [0, 0, 0, 10, 10, 10]],
                     np.float32)[None]
    pv = np.array([[True] * 5 + [False]])
    gt = np.array([[[0.0, 0, 0, 10, 10, 10]]], np.float32)
    draws = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (6,)))[None]
    _, labels, _, sel_valid = _sample_both(dict(rois_per_scene=8, fg_threshold=0.5,
                                                bg_threshold=0.2), props, pv, gt,
                                           np.ones((1, 1), bool), draws)
    assert labels[sel_valid].sum() == 2 and sel_valid.sum() == 4


def _obb(rs, shape):
    return np.concatenate([rs.uniform(6, 26, shape + (3,)), rs.uniform(3, 12, shape + (3,)),
                           rs.uniform(-1.5, 1.5, shape + (1,))], -1).astype(np.float32)


def _proposals_near(rs, gt, n, rotated):
    """n proposals a scene: jittered GT boxes (many foreground), random ones,
    and a degenerate one."""
    b, g = gt.shape[:2]
    pick = gt[:, rs.randint(0, g, n)]
    props = pick.copy()
    if rotated:
        props[..., :3] += rs.uniform(-2, 2, props[..., :3].shape)
        props[..., 3:6] *= rs.uniform(0.8, 1.25, props[..., 3:6].shape)
        props[:, n // 2:] = _obb(rs, (b, n - n // 2))
        props[:, -1, 3:6] = 0.0
    else:
        props += rs.uniform(-1.5, 1.5, props.shape)
        lo = rs.uniform(0, 20, (b, n - n // 2, 3))
        props[:, n // 2:] = np.concatenate([lo, lo + rs.uniform(2, 10, lo.shape)], -1)
        props[:, -1, 3:6] = props[:, -1, :3]
    return props.astype(np.float32)


def _gt(rs, rotated, b=2, g=4):
    if rotated:
        gt = _obb(rs, (b, g))
    else:
        lo = rs.uniform(2, 16, (b, g, 3))
        gt = np.concatenate([lo, lo + rs.uniform(5, 12, lo.shape)], -1).astype(np.float32)
    gv = np.ones((b, g), bool)
    gv[1, -1] = False
    return gt, gv


@pytest.mark.parametrize("rotated", [False, True])
def test_sample_rois_batched_with_tied_draws_matches_jax(rotated):
    rs = np.random.RandomState(1)
    gt, gv = _gt(rs, rotated)
    props = _proposals_near(rs, gt, 40, rotated)
    pv = rs.rand(2, 40) > 0.1
    draws = (np.floor(rs.rand(2, 40) * 16) / 16).astype(np.float32)
    _, labels, _, sel_valid = _sample_both(dict(rois_per_scene=16, rotated=rotated), props, pv,
                                           gt, gv, draws)
    assert labels.sum() > 0 and sel_valid.sum() > labels.sum()


def _feats(rs, b=2):
    return [rs.rand(b, s, s, s, C).astype(np.float32) for s in (8, 4, 2, 1)]


@pytest.mark.parametrize("rotated", [False, True])
def test_rcnn_stage_matches_jax(rotated):
    """The training loss and its parameter gradients, then the eval
    outputs, from the same weights, features, proposals and draws."""
    rs = np.random.RandomState(2)
    kw = dict(resolution=32, rois_per_scene=12, output_size=3, rotated=rotated)
    feats = _feats(rs)
    gt, gv = _gt(rs, rotated)
    props = _proposals_near(rs, gt, 24, rotated)
    pv = np.ones((2, 24), bool)
    pv[0, 3] = False
    jm = jrcnn.RCNNStage(jrcnn.RCNNConfig(**kw))
    j = jnp.asarray
    rng = jax.random.PRNGKey(3)
    shapes = jax.eval_shape(lambda: jm.init({"params": rng}, [j(f) for f in feats], j(props),
                                            j(pv), j(gt), j(gv), rng, True)["params"])
    params = fill_params(shapes, 4)

    def jloss(p):
        return jm.apply({"params": p}, [j(f) for f in feats], j(props), j(pv), j(gt), j(gv), rng,
                        True)

    (jtotal, jaux), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    stage = trcnn.RCNNStage(trcnn.RCNNConfig(**kw), C, device="cpu")
    stage.load_state_dict(rcnn_params_from_jax(params, trcnn.RCNNConfig(**kw), C))
    draws = np.stack([np.asarray(jax.random.uniform(k, (24,))) for k in jax.random.split(rng, 2)])
    total, aux = stage([t(f) for f in feats], t(props), t(pv), t(gt), t(gv), draws=t(draws),
                       training=True)
    total.backward()
    assert float(aux["num_pos"]) == float(jaux["num_pos"]) > 0
    for k in ("loss_cls", "loss_reg"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=LOSS_RTOL)
    want_g = rcnn_params_from_jax(jgrads, trcnn.RCNNConfig(**kw), C)
    for name, prm in stage.named_parameters():
        scale = float(want_g[name].abs().max())
        close(prm.grad, want_g[name].numpy(), rtol=LOSS_RTOL, atol=1e-4 * scale, msg=name)

    want = jm.apply({"params": params}, [j(f) for f in feats], j(props), j(pv))
    with torch.no_grad():
        got = stage([t(f) for f in feats], t(props), t(pv))
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    close(got["scores"], want["scores"])
    wb = np.asarray(want["boxes"])
    close(got["boxes"][..., :6], wb[..., :6], atol=2e-3)
    if rotated:
        d = np.abs(got["boxes"][..., 6].numpy() - wb[..., 6]) % np.pi
        assert (np.minimum(d, np.pi - d) < 2e-3).all()


def test_rcnn_trainer_steps_decrease_the_loss():
    """tests/test_rcnn.py's check on the port: 6 steps on one batch."""
    rs = np.random.RandomState(5)
    feats = [t(f) for f in _feats(rs)]
    gt, gv = _gt(rs, False)
    proposals = {"boxes": t(_proposals_near(rs, gt, 24, False)),
                 "valid": torch.ones((2, 24), dtype=torch.bool)}
    batch = {"gt_boxes": t(gt), "gt_valid": t(gv)}
    trainer = RCNNTrainer(trcnn.RCNNConfig(resolution=32, rois_per_scene=8, output_size=3),
                          TrainConfig(lr=1e-3), 6, "cpu", in_channels=C)
    state = trainer.init(0)
    losses = []
    for _ in range(6):
        state, m = trainer.train_step(state, feats, proposals, batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    det = trainer.predict_step(state, feats, proposals)
    assert tuple(det["boxes"].shape) == (2, 24, 6) and tuple(det["scores"].shape) == (2, 24)


# ------------------------------------------------------------------- CLI

TINY = ["--backbone_type", "swin_nano", "--resolution", "32", "--batch_size", "2",
        "--compute_dtype", "float32", "--device", "cpu", "--max_gt", "8", "--dataset",
        "synthetic", "--n_synthetic", "4"]


@pytest.fixture(scope="module")
def rpn_ckpt(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("rpn") / "ckpt")
    run_rpn.main(["--mode", "train", *TINY, "--steps", "2", "--rpn_pre_nms_top_n", "32",
                  "--rpn_post_nms_top_n", "32", "--rpn_batch_size_per_mesh", "64",
                  "--checkpoint_dir", ckpt])
    return ckpt


def test_frozen_rpn_restores_the_checkpoints_head_depth(rpn_ckpt, tmp_path):
    """run_rpn trains at head depth 2: the frozen first stage has both convs
    and gives run_rpn's own proposals on the same batch; a checkpoint with
    any other mismatch raises."""
    args = run_rpn_detect.parse_args([*TINY, "--proposals_per_scene", "32",
                                      "--rpn_checkpoint", rpn_ckpt])
    state = run_rpn_detect.frozen_rpn(args, torch.device("cpu"))
    assert state.model.rpn.conv_depth == 2 and hasattr(state.model.head, "conv1")
    rargs = run_rpn.parse_args([*TINY, "--rpn_pre_nms_top_n", "32", "--rpn_post_nms_top_n",
                                "32"])
    trainer = RPNTrainer(run_rpn.SWIN_PRESETS["swin_nano"], run_rpn.rpn_config(rargs),
                         TrainConfig(), 10, "cpu", backbone="swin_nano", compute_dtype="float32")
    ref = trainer.init(1)
    ref.model.load_state_dict(restore_checkpoint(rpn_ckpt)["params"])
    scenes = run_rpn.build_datasets(rargs)[1]
    batch = {k: torch.from_numpy(v) for k, v in next(run_rpn.batch_iter(scenes, rargs)).items()}
    want = trainer.predict_step(ref, batch)
    _, got = run_rpn_detect.features_and_proposals(state, batch)
    assert int(want["valid"].sum()) > 0
    for k in want:
        assert torch.equal(got[k], want[k]), k
    params = dict(restore_checkpoint(rpn_ckpt)["params"])
    params["head.extra.weight"] = torch.zeros(1)
    bad = str(tmp_path / "bad")
    save_checkpoint(bad, 1, params)
    with pytest.raises(RuntimeError, match="head.extra.weight"):
        run_rpn_detect.frozen_rpn(run_rpn_detect.parse_args([*TINY, "--rpn_checkpoint", bad]),
                                  torch.device("cpu"))


def test_run_rpn_detect_end_to_end(rpn_ckpt, tmp_path):
    common = [*TINY, "--proposals_per_scene", "32", "--rois_per_scene", "8", "--rpn_checkpoint",
              rpn_ckpt]
    ckpt = str(tmp_path / "rcnn")
    out = run_rpn_detect.main(["--mode", "train", *common, "--steps", "3", "--checkpoint_dir",
                               ckpt, "--log_interval", "1", "--roi_path", "unused"])
    assert [h["step"] for h in out["history"]] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert restore_checkpoint(ckpt)["step"] == 3
    agg = run_rpn_detect.main(["--mode", "eval", *common, "--checkpoint", ckpt])
    assert set(agg) == {"recall25_top300", "recall50_top300", "ar_top300", "ap25", "ap50", "ap75"}
    assert all(0 <= v <= 1 for v in agg.values())
    with pytest.raises(SystemExit):
        run_rpn_detect.parse_args([*common, "--mode", "benchmark"])
