"""The port's downstream trainers and CLIs against the JAX package, on
the CPU.

Three VoxelSR and VoxelSemantics train steps from the same weights against
the JAX trainers (loss and grad_norm rtol 1e-3 per step, parameters rtol
1e-3 / atol 2e-4 after the third) and their eval steps; the MAE graft
against JAX's graft_mae, and its refusals; both CLIs end to end on
--device cpu (synthetic and scenes on disk, train -> eval from the
checkpoint -> benchmark, --mae_checkpoint from a port checkpoint and from a
.npz of the JAX MAE tree, --class_weights), and run_mae_pretrain on a scene
directory. Tiny config: embed 12, depths (1, 1, 1, 1), resolution 32,
float32, stochastic depth 0. The JAX trainers are built (and their steps
compiled) once per module.
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
from nerf_mae_tpu.models import mae as jmae
from nerf_mae_tpu.train.head_trainer import VoxelSemanticsTrainer as JSemTrainer
from nerf_mae_tpu.train.head_trainer import VoxelSRTrainer as JSRTrainer
from nerf_mae_tpu.train.trainer import TrainState as JTrainState
from nerf_mae_torch import run_mae_pretrain, run_voxel_semantics, run_voxel_sr
from nerf_mae_torch.common import load_mae_params
from nerf_mae_torch.config import SWIN_PRESETS, MAEConfig, TrainConfig
from nerf_mae_torch.convert import head_params_from_jax, params_from_jax
from nerf_mae_torch.models.heads import calculate_class_weights
from nerf_mae_torch.train.checkpoint import checkpoint_steps, graft_mae, restore_checkpoint
from nerf_mae_torch.train.head_trainer import VoxelSemanticsTrainer, VoxelSRTrainer

from test_torch_heads import cfgs, fill_params, head_params

torch.set_num_threads(1)

# At lr 1e-3 Adam's normalised step turns a float32-noise difference in a
# near-zero gradient into a 1e-3 move of opposite sign (a few patch-embed
# weights); at 1e-4 such moves stay inside the parameters' atol, and the
# first moments (0.1 x the clipped gradients) are compared directly.
LR, TOTAL = 1e-4, 10


def _batch(kind, seed=0):
    rs = np.random.RandomState(seed)
    grids = rs.rand(2, 32, 32, 32, 4).astype(np.float32)
    grids[..., 3] *= rs.rand(2, 32, 32, 32) > 0.5
    if kind == "sr":
        out = rs.rand(2, 48, 48, 48, 4).astype(np.float32)
        out[..., 3] *= rs.rand(2, 48, 48, 48) > 0.5
        return {"grids": grids, "out_grids": out}
    return {"grids": grids, "semantics": rs.randint(0, 5, (2, 32, 32, 32)).astype(np.int32)}


@pytest.fixture(scope="module")
def jax_runs():
    """Per kind: the JAX trainer, its initial parameters, and the metrics
    and parameters of three train steps and one eval step."""
    jcfg, _ = cfgs()
    out = {}
    weights = calculate_class_weights([_batch("semantics")["semantics"]], 5)
    for kind in ("sr", "semantics"):
        if kind == "sr":
            trainer = JSRTrainer(jcfg, JTrainConfig(lr=LR), TOTAL, None, out_resolution=48)
        else:
            trainer = JSemTrainer(jcfg, JTrainConfig(lr=LR), TOTAL, None, num_classes=5,
                                  class_weights=weights)
        params = head_params(trainer.model, seed=2)
        state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                            opt_state=trainer.tx.init(params), rng=jax.random.PRNGKey(0))
        batch = {k: jnp.asarray(v) for k, v in _batch(kind).items()}
        steps, mu = [], None
        for _ in range(3):
            state, m = trainer.train_step(state, batch)
            steps.append({k: np.asarray(v) for k, v in m.items()})
            mu = mu or jax.device_get(state.opt_state[1][0].mu)
        ev = {k: np.asarray(v) for k, v in trainer.eval_step(state, batch).items()}
        out[kind] = dict(trainer=trainer, init=params, steps=steps, mu=mu,
                         params=jax.device_get(state.params), eval=ev, weights=weights)
    return out


@pytest.mark.parametrize("kind", ["sr", "semantics"])
def test_train_steps_match_jax(jax_runs, kind):
    run = jax_runs[kind]
    _, cfg = cfgs()
    if kind == "sr":
        trainer = VoxelSRTrainer(cfg, TrainConfig(lr=LR), TOTAL, "cpu", out_resolution=48)
    else:
        trainer = VoxelSemanticsTrainer(cfg, TrainConfig(lr=LR), TOTAL, "cpu",
                                        num_classes=5, class_weights=run["weights"])
    state = trainer.init(0)
    state.model.load_state_dict(head_params_from_jax(run["init"], cfg, kind))
    batch = {k: torch.from_numpy(v) for k, v in _batch(kind).items()}
    for i, want in enumerate(run["steps"]):
        state, m = trainer.train_step(state, batch)
        assert set(m) == set(want), i
        for k in want:
            np.testing.assert_allclose(float(m[k]), float(want[k]), rtol=1e-3, atol=1e-6,
                                       err_msg=f"step {i} {k}")
        if i == 0:  # atol 5e-4 of the largest: decoder1's weight gradients sum
            # 2 x 32^3 voxels of the full-resolution convs in float32 (JAX and
            # the autograd instance norm alike differ there by 2.2e-4)
            mu = head_params_from_jax(run["mu"], cfg, kind)
            atol = 5e-4 * max(float(v.abs().max()) for v in mu.values())
            for name, prm in state.model.named_parameters():
                np.testing.assert_allclose(state.optimizer.state[prm]["exp_avg"].numpy(),
                                           mu[name].numpy(), rtol=2e-3, atol=atol,
                                           err_msg=f"mu {name}")
    assert state.step == 3
    ref = head_params_from_jax(run["params"], cfg, kind)
    for name, prm in state.model.named_parameters():
        np.testing.assert_allclose(prm.detach().numpy(), ref[name].numpy(), rtol=1e-3,
                                   atol=2e-4, err_msg=name)
    ev = trainer.eval_step(state, batch)
    assert set(ev) == set(run["eval"])
    for k, v in run["eval"].items():
        if k == "pred_labels":  # argmax of logits equal to ~1e-4: nearly all agree
            assert ev[k].shape == v.shape and (ev[k].numpy() == v).mean() > 0.99
        else:
            np.testing.assert_allclose(float(ev[k]), float(v), rtol=1e-3, err_msg=k)


def _jax_mae_params(jcfg, seed):
    shapes = jax.eval_shape(lambda: jmae.SwinMAE3D(jcfg).init(
        {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
        jnp.zeros((1, 32, 32, 32, 4)), True)["params"])
    return fill_params(shapes, seed)


def test_graft_matches_jax(jax_runs):
    """The trunk and decoder4/3/2 of a MAE land in `base`, the rest of the
    head keeps its weights: equal to JAX's graft_mae. A MAE without a
    decoder, or of another width, is refused."""
    jcfg, cfg = cfgs()
    run = jax_runs["sr"]
    mae = _jax_mae_params(jcfg, seed=5)
    want = run["trainer"].graft_mae(JTrainState(step=0, params=run["init"], opt_state=None,
                                                rng=None), mae).params
    mae_sd = params_from_jax(mae, cfg)
    head_sd = head_params_from_jax(run["init"], cfg, "sr")
    got = graft_mae(head_sd, mae_sd)
    ref = head_params_from_jax(want, cfg, "sr")
    assert set(got) == set(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    grafted = {k for k in got if not torch.equal(got[k], head_sd[k])}
    assert grafted and all(k.startswith("base.") for k in grafted)

    with pytest.raises(KeyError, match="lack"):
        graft_mae(head_sd, {k: v for k, v in mae_sd.items() if not k.startswith("decoder4")})
    bad = dict(mae_sd)
    bad["decoder3.transp_conv.bias"] = torch.zeros(7)
    with pytest.raises(ValueError, match="shape"):
        graft_mae(head_sd, bad)

    trainer = VoxelSRTrainer(cfg, TrainConfig(), TOTAL, "cpu", out_resolution=48)
    state = trainer.init(0)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state = trainer.graft_mae(state, mae_sd)
    for k, v in state.model.state_dict().items():
        want_v = mae_sd[k[len("base."):]] if k.startswith("base.") else before[k]
        assert torch.equal(v, want_v), k


# ---------------------------------------------------------------- the CLIs


def _write_scenes(root, n, res, seed, out_res=None, num_classes=None):
    """n scenes of odd sizes at or below `res` (raw density), with SR
    targets at out_res or semantic labels where asked."""
    rs = np.random.RandomState(seed)
    for sub in ("features", "out", "sem"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    for i in range(n):
        size = tuple(int(s) for s in rs.randint(res - 7, res + 1, 3))
        g = rs.rand(*size, 4).astype(np.float32)
        g[..., 3] = rs.randn(*size) * 3
        np.savez(root / "features" / f"s{i}.npz", rgbsigma=g)
        if out_res:
            hi = rs.rand(out_res, out_res, out_res, 4).astype(np.float32)
            np.savez(root / "out" / f"s{i}.npz", rgbsigma=hi)
        if num_classes:
            np.save(root / "sem" / f"s{i}.npy", rs.randint(0, num_classes, size))
    return root


_TINY = ["--backbone_type", "swin_nano", "--resolution", "32", "--batch_size", "2",
         "--compute_dtype", "float32", "--device", "cpu"]


@pytest.fixture(scope="module")
def mae_ckpt(tmp_path_factory):
    """run_mae_pretrain --dataset front3d on a scene directory (2 steps,
    augmented), its checkpoint, and a .npz of a JAX MAE tree."""
    root = _write_scenes(tmp_path_factory.mktemp("mae"), 3, 32, seed=0)
    ckpt = str(root / "ckpt")
    out = run_mae_pretrain.main(["--mode", "train", "--dataset", "front3d",
                                 "--features_path", str(root / "features"),
                                 "--flip_prob", "0.5", "--rotate_prob", "0.5", *_TINY,
                                 "--steps", "2", "--checkpoint_dir", ckpt,
                                 "--log_interval", "1"])
    jtree = _jax_mae_params(JMAEConfig(swin=JPRESETS["swin_nano"], resolution=32), seed=1)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(jtree)}
    npz = root / "jax_mae.npz"
    np.savez(npz, **flat)
    return root, ckpt, out, str(npz), flat


def test_pretrain_from_a_scene_directory(mae_ckpt):
    root, ckpt, out, _, _ = mae_ckpt
    assert out["steps"] == 2 and all(np.isfinite(h["loss"]) for h in out["history"])
    assert checkpoint_steps(ckpt) == [2]
    agg = run_mae_pretrain.main(["--mode", "eval", "--dataset", "front3d",
                                 "--features_path", str(root / "features"), *_TINY,
                                 "--checkpoint", ckpt])
    assert agg and all(np.isfinite(v) for v in agg.values())


def _nano_cfg():
    return MAEConfig(swin=SWIN_PRESETS["swin_nano"], resolution=32, compute_dtype="float32")


@pytest.mark.parametrize("source", ["port", "jax_npz"])
def test_voxel_sr_cli_end_to_end(mae_ckpt, tmp_path, source):
    """train (grafted) -> eval from the checkpoint -> benchmark, synthetic
    for a port MAE checkpoint and scenes on disk for the JAX .npz."""
    root, mae_dir, _, npz, flat = mae_ckpt
    mae = mae_dir if source == "port" else npz
    if source == "port":
        data = ["--dataset", "synthetic", "--n_synthetic", "2"]
    else:
        scenes = _write_scenes(tmp_path / "scenes", 2, 32, seed=4, out_res=48)
        data = ["--dataset", "front3d", "--features_path", str(scenes / "features"),
                "--out_feat_path", str(scenes / "out")]
    common = [*data, *_TINY, "--out_resolution", "48"]
    ckpt = str(tmp_path / "sr")
    out = run_voxel_sr.main(["--mode", "train", *common, "--steps", "2",
                             "--mae_checkpoint", mae, "--checkpoint_dir", ckpt,
                             "--log_interval", "1"])
    assert [h["step"] for h in out["history"]] == [1, 2]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["psnr"]) for h in out["history"])
    assert checkpoint_steps(ckpt) == [2]
    # what the CLI grafted: the MAE as load_mae_params reads it
    mae_sd = load_mae_params(mae, _nano_cfg())
    if source == "jax_npz":
        want = params_from_jax(flat, _nano_cfg())
        assert all(torch.equal(mae_sd[k], want[k]) for k in want)
    trainer = VoxelSRTrainer(_nano_cfg(), TrainConfig(), 2, "cpu", out_resolution=48)
    state = trainer.graft_mae(trainer.init(0), mae_sd)
    assert torch.equal(state.model.base.decoder3.transp_conv.weight,
                       mae_sd["decoder3.transp_conv.weight"])
    eval_json = tmp_path / "eval.json"
    agg = run_voxel_sr.main(["--mode", "eval", *common, "--checkpoint", ckpt,
                             "--eval_json", str(eval_json)])
    assert set(agg) == {"loss", "mse", "psnr"}
    assert json.loads(eval_json.read_text()) == agg
    bench = run_voxel_sr.main(["--mode", "benchmark", *common, "--checkpoint", ckpt])
    assert bench["metric"] == "eval_ms_voxel_sr_swin_nano_32_to_48"
    assert bench["ms"] > 0 and bench["grids_per_sec"] > 0 and bench["device"] == "cpu"
    assert restore_checkpoint(ckpt)["step"] == 2


def test_voxel_semantics_cli_end_to_end(mae_ckpt, tmp_path):
    """Scenes on disk with labels, class weights from the training labels,
    a grafted port MAE: train -> eval (mIoU / mAcc / allAcc) -> benchmark."""
    _, mae_dir, _, _, _ = mae_ckpt
    scenes = _write_scenes(tmp_path / "scenes", 3, 32, seed=6, num_classes=5)
    labels = [np.load(scenes / "sem" / f"s{i}.npy") for i in range(3)]
    weights = tmp_path / "w.npy"
    np.save(weights, calculate_class_weights(labels, 5))
    common = ["--dataset", "scannet", "--features_path", str(scenes / "features"),
              "--sem_feat_path", str(scenes / "sem"), "--num_classes", "5",
              "--class_weights", str(weights), *_TINY]
    ckpt = str(tmp_path / "sem_ckpt")
    out = run_voxel_semantics.main(["--mode", "train", *common, "--steps", "2",
                                    "--mae_checkpoint", mae_dir, "--checkpoint_dir", ckpt,
                                    "--log_interval", "1", "--eval_interval", "2"])
    assert all(np.isfinite(h["loss"]) and 0 <= h["soft_miou"] <= 1 for h in out["history"])
    assert checkpoint_steps(ckpt) == [2]
    agg = run_voxel_semantics.main(["--mode", "eval", *common, "--checkpoint", ckpt])
    assert set(agg) == {"loss", "mIoU", "mAcc", "allAcc"}
    assert all(0 <= agg[k] <= 1 for k in ("mIoU", "mAcc", "allAcc"))
    bench = run_voxel_semantics.main(["--mode", "benchmark", *common])
    assert bench["metric"] == "eval_ms_voxel_semantics_swin_nano_32_to_32"


@pytest.mark.parametrize("cli", [run_voxel_sr, run_voxel_semantics])
def test_clis_need_a_card_or_a_features_path(cli, monkeypatch):
    with pytest.raises(SystemExit, match="features_path"):
        cli.main(["--mode", "train", "--dataset", "front3d", *_TINY])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--mode", "train", "--dataset", "synthetic", *_TINY[:-2],
                     "--device", "cuda", "--steps", "1"])
