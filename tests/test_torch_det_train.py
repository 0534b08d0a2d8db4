"""The port's detection trainer, data and CLI against the JAX package, on
the CPU.

Two DetectionTrainer steps from the same weights against the JAX trainer
(OBB, IoU loss; loss terms, num_pos and grad_norm rtol 1e-3 per step, the
parameters rtol 1e-3 / atol 2e-4 after the second), its prediction step,
graft_mae_trunk against JAX's, the data functions bitwise against JAX
(synthetic_detection_scenes in its three forms, pad_boxes,
detection_batch_iterator), and `python -m nerf_mae_torch.run_fcos` train
-> eval -> benchmark on --device cpu (synthetic OBB from a grafted port MAE
checkpoint with the proposal and objectness dumps; AABB scenes on disk
with augments; the ResNet body). Tiny config: swin_nano (embed 12), 32^3,
float32, stochastic depth 0; the detector is the trainer's, 256 wide. The
JAX trainer is built (and its step compiled) once per module.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_mae_tpu.config import SWIN_PRESETS as JPRESETS
from nerf_mae_tpu.config import MAEConfig as JMAEConfig
from nerf_mae_tpu.config import TrainConfig as JTrainConfig
from nerf_mae_tpu.data import datasets as jdata
from nerf_mae_tpu.models import mae as jmae
from nerf_mae_tpu.models.fcos import FCOSConfig as JFCOSConfig
from nerf_mae_tpu.train.det_trainer import DetectionTrainer as JDetectionTrainer
from nerf_mae_tpu.train.trainer import TrainState as JTrainState
from nerf_mae_torch import data, run_fcos, run_mae_pretrain
from nerf_mae_torch.config import SWIN_PRESETS, MAEConfig, TrainConfig
from nerf_mae_torch.convert import det_params_from_jax, params_from_jax
from nerf_mae_torch.models.fcos import FCOSConfig
from nerf_mae_torch.train.checkpoint import checkpoint_steps, restore_checkpoint
from nerf_mae_torch.train.det_trainer import DetectionTrainer

from test_torch_heads import fill_params

torch.set_num_threads(1)

LR, TOTAL = 1e-4, 10
NANO = SWIN_PRESETS["swin_nano"]
FCOS_KW = dict(resolution=32, use_obb=True, iou_loss_type="iou", max_gt=8,
               pre_nms_top_n=60, post_nms_top_n=40)


class _DS:
    def __init__(self, scenes):
        self.scenes = scenes

    def __len__(self):
        return len(self.scenes)

    def __getitem__(self, i):
        return self.scenes[i]


def _batch(seed=0, obb=True):
    scenes = jdata.synthetic_detection_scenes(2, 32, seed=seed, min_size=24, obb=obb)
    return next(jdata.detection_batch_iterator(_DS(scenes), 2, 32, max_gt=8, shuffle=False,
                                               loop=False))


def _jax_params(trainer, seed):
    shapes = jax.eval_shape(lambda: trainer.model.init(
        {"params": jax.random.PRNGKey(0), "droppath": jax.random.PRNGKey(1)},
        jnp.zeros((1, 32, 32, 32, 4)), jnp.full((1, 3), 32), jnp.zeros((1, 8, 7)),
        jnp.zeros((1, 8), bool), True, True)["params"])
    params = fill_params(shapes, seed)
    params["head"]["scales"] = (1 + 0.1 * np.random.RandomState(seed).randn(4)).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def jax_run():
    """The JAX trainer, its initial parameters, two train steps' metrics, the
    parameters after them, and a prediction step."""
    trainer = JDetectionTrainer(JPRESETS["swin_nano"], JFCOSConfig(**FCOS_KW),
                                JTrainConfig(lr=LR), TOTAL, None, backbone="swin_nano",
                                compute_dtype="float32", remat=False)
    params = _jax_params(trainer, seed=3)
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        opt_state=trainer.tx.init(params), rng=jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    steps = []
    for _ in range(2):
        state, m = trainer.train_step(state, batch)
        steps.append({k: float(v) for k, v in m.items()})
    det = {k: np.asarray(v) for k, v in trainer.predict_step(state, batch).items()}
    return dict(trainer=trainer, init=params, steps=steps, params=jax.device_get(state.params),
                det=det)


def _trainer():
    return DetectionTrainer(NANO, FCOSConfig(**FCOS_KW), TrainConfig(lr=LR), TOTAL, "cpu",
                            backbone="swin_nano", compute_dtype="float32", remat=False)


def _sd(tree):
    return det_params_from_jax(tree, NANO, FCOSConfig(**FCOS_KW), "swin_nano")


def test_train_steps_and_prediction_match_jax(jax_run):
    trainer = _trainer()
    state = trainer.init(0)
    state.model.load_state_dict(_sd(jax_run["init"]))
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    for i, want in enumerate(jax_run["steps"]):
        state, m = trainer.train_step(state, batch)
        assert set(m) == set(want)
        assert float(m["num_pos"]) == want["num_pos"] > 0
        for k in want:
            np.testing.assert_allclose(float(m[k]), want[k], rtol=1e-3, atol=1e-6,
                                       err_msg=f"step {i} {k}")
    assert state.step == 2
    ref = _sd(jax_run["params"])
    for name, prm in state.model.named_parameters():
        np.testing.assert_allclose(prm.detach().numpy(), ref[name].numpy(), rtol=1e-3,
                                   atol=2e-4, err_msg=name)
    det = trainer.predict_step(state, batch)
    want = jax_run["det"]
    assert set(det) == set(want)
    np.testing.assert_array_equal(det["valid"].numpy(), want["valid"])
    np.testing.assert_allclose(det["scores"].numpy(), want["scores"], rtol=2e-3, atol=2e-4)
    n = int(det["valid"].sum(1).min())
    got_b, want_b = det["boxes"][:, : n // 4].numpy(), want["boxes"][:, : n // 4]
    np.testing.assert_allclose(got_b[..., :6], want_b[..., :6], rtol=2e-3, atol=2e-3)
    # a rectangle's angle is defined mod pi: atan2 at a near-zero midpoint
    # component may land on the other branch
    d = np.abs(got_b[..., 6] - want_b[..., 6]) % np.pi
    assert (np.minimum(d, np.pi - d) < 2e-3).all()


def _jax_mae(seed):
    jcfg = JMAEConfig(swin=JPRESETS["swin_nano"], resolution=32, compute_dtype="float32",
                      remat=False)
    shapes = jax.eval_shape(lambda: jmae.SwinMAE3D(jcfg).init(
        {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
        jnp.zeros((1, 32, 32, 32, 4)), True)["params"])
    return fill_params(shapes, seed)


def test_graft_matches_jax(jax_run):
    """The MAE's patch embedding and stages land in the body; the FPN and the
    head keep their weights: equal to JAX's graft_mae_trunk."""
    mae = _jax_mae(seed=5)
    want = jax_run["trainer"].graft_mae_trunk(
        JTrainState(step=0, params=jax_run["init"], opt_state=None, rng=None), mae).params
    trainer = _trainer()
    state = trainer.init(0)
    state.model.load_state_dict(_sd(jax_run["init"]))
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    mae_sd = params_from_jax(mae, MAEConfig(swin=NANO, resolution=32, compute_dtype="float32"))
    state = trainer.graft_mae_trunk(state, mae_sd)
    ref = _sd(want)
    got = state.model.state_dict()
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    grafted = {k for k in got if not torch.equal(got[k], before[k])}
    assert grafted and all(k.startswith(("body.patch_partition.", "body.stages.")) for k in grafted)
    bad = dict(mae_sd)
    bad["stages.1.0.reduction.weight"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="shape"):
        trainer.graft_mae_trunk(state, bad)


@pytest.mark.parametrize("kw", [dict(obb=False), dict(obb=True), dict(obb=True, hard=True)])
def test_data_functions_match_jax_bitwise(kw):
    want = jdata.synthetic_detection_scenes(3, 32, seed=4, **kw)
    got = data.synthetic_detection_scenes(3, 32, seed=4, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["rgbsigma"], w["rgbsigma"])
        np.testing.assert_array_equal(g["boxes"], w["boxes"])
    for max_gt in (2, 8):
        for g, w in zip(data.pad_boxes(got[0]["boxes"], max_gt),
                        jdata.pad_boxes(want[0]["boxes"], max_gt)):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(data.pad_boxes(np.zeros((0, 7)), 4)[0],
                                  jdata.pad_boxes(np.zeros((0, 7)), 4)[0])
    for opts in (dict(shuffle=True, seed=9), dict(shuffle=False, drop_last=False)):
        it_g = data.detection_batch_iterator(got, 2, 32, max_gt=6, loop=False, **opts)
        it_w = jdata.detection_batch_iterator(_DS(want), 2, 32, max_gt=6, loop=False, **opts)
        batches = list(zip(it_g, it_w))
        assert len(batches) == (1 if opts.get("drop_last", True) else 2)
        for bg, bw in batches:
            assert set(bg) == set(bw)
            for k in bw:
                np.testing.assert_array_equal(bg[k], bw[k], err_msg=k)


# ------------------------------------------------------------------- CLI

_TINY = ["--backbone_type", "swin_nano", "--resolution", "32", "--batch_size", "2",
         "--compute_dtype", "float32", "--device", "cpu", "--pre_nms_top_n", "60",
         "--fpn_post_nms_top_n", "40", "--max_gt", "8"]


@pytest.fixture(scope="module")
def mae_ckpt(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("mae") / "ckpt")
    run_mae_pretrain.main(["--mode", "train", "--dataset", "synthetic", "--n_synthetic", "2",
                           *_TINY[:10], "--steps", "1", "--checkpoint_dir", ckpt])
    return ckpt


def test_run_fcos_end_to_end_obb(mae_ckpt, tmp_path):
    """train (grafted, the best-AP50 checkpoint at the eval) -> eval from the
    checkpoint with the proposal and objectness dumps -> benchmark."""
    common = ["--dataset", "synthetic", "--n_synthetic", "4", "--rotated_bbox", *_TINY]
    ckpt = str(tmp_path / "fcos")
    out = run_fcos.main(["--mode", "train", *common, "--steps", "2", "--mae_checkpoint",
                         mae_ckpt, "--checkpoint_dir", ckpt, "--log_interval", "1",
                         "--eval_interval", "1"])
    assert [h["step"] for h in out["history"]] == [1, 2]
    assert all(np.isfinite(h["loss"]) and h["num_pos"] > 0 for h in out["history"])
    assert checkpoint_steps(ckpt)[-1] == 2
    assert "ap50" in restore_checkpoint(ckpt, checkpoint_steps(ckpt)[0]).get("extra", {})
    props, scores = tmp_path / "props", tmp_path / "scores"
    eval_json = tmp_path / "eval.json"
    agg = run_fcos.main(["--mode", "eval", *common, "--checkpoint", ckpt, "--eval_json",
                         str(eval_json), "--output_proposals", str(props),
                         "--output_voxel_scores", str(scores)])
    assert {"ap25", "ap50", "ap75", "recall25_top300", "ar_top2500"} <= set(agg)
    assert all(0 <= v <= 1 for v in agg.values())
    assert json.loads(eval_json.read_text()) == agg
    n_val = 4  # max(n_synthetic // 4, 4) scenes, drawn from seed + 10000
    dump = np.load(props / "scene_0.npz")
    assert dump["boxes"].shape[1] == 7 and len(dump["boxes"]) == len(dump["scores"]) <= 40
    assert len(list(props.iterdir())) == len(list(scores.iterdir())) == n_val
    assert set(np.load(scores / "scene_3.npz").files) == {"0", "1", "2", "3"}
    bench = run_fcos.main(["--mode", "benchmark", *common, "--checkpoint", ckpt])
    assert bench["metric"] == "predict_ms_fcos_obb_swin_nano_32"
    assert bench["ms"] > 0 and bench["grids_per_sec"] > 0 and bench["device"] == "cpu"


def _write_det_scenes(root, n, seed):
    rs = np.random.RandomState(seed)
    (root / "features").mkdir(parents=True)
    (root / "boxes").mkdir()
    for i in range(n):
        size = tuple(int(s) for s in rs.randint(26, 33, 3))
        g = rs.rand(*size, 4).astype(np.float32)
        g[..., 3] = rs.randn(*size) * 3
        np.savez(root / "features" / f"s{i}.npz", rgbsigma=g)
        lo = rs.uniform(2, 14, (3, 3))
        np.save(root / "boxes" / f"s{i}.npy", np.concatenate([lo, lo + rs.uniform(4, 12, (3, 3))],
                                                             1).astype(np.float32))
    return root


@pytest.mark.parametrize("backbone", ["swin_nano", "resnet"])
def test_run_fcos_from_scenes_on_disk(tmp_path, backbone):
    scenes = _write_det_scenes(tmp_path / "scenes", 3, seed=6)
    common = ["--dataset", "front3d", "--features_path", str(scenes / "features"),
              "--boxes_path", str(scenes / "boxes"), "--flip_prob", "0.5", "--rotate_prob",
              "0.5", *_TINY]
    common[common.index("swin_nano")] = backbone
    ckpt = str(tmp_path / "fcos")
    out = run_fcos.main(["--mode", "train", *common, "--steps", "2", "--checkpoint_dir", ckpt,
                         "--log_interval", "1"])
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    agg = run_fcos.main(["--mode", "eval", *common, "--checkpoint", ckpt])
    assert 0 <= agg["ap25"] <= 1
    bench = run_fcos.main(["--mode", "benchmark", *common])
    assert bench["metric"] == f"predict_ms_fcos_aabb_{backbone}_32"


def test_run_fcos_needs_a_card_or_a_features_path(monkeypatch):
    with pytest.raises(SystemExit, match="features_path"):
        run_fcos.main(["--mode", "train", "--dataset", "front3d", *_TINY])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_fcos.main(["--mode", "train", "--dataset", "synthetic", "--steps", "1",
                       *[a if a != "cpu" else "cuda" for a in _TINY]])
