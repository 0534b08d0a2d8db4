"""Serving the port's own MAE checkpoint: `nerf_mae_torch.inference
--mae_checkpoint` takes the directory that `run_mae_pretrain` writes (its
newest step) or a step's `state.pt`, and serves bitwise what `--params`
serves from the same weights saved as a bare state dict. The loaders take a
checkpoint payload's `params`, and refuse a JAX (orbax) directory with the
name of the tool that converts it."""

import os

import numpy as np
import pytest
import torch

from nerf_mae_torch import inference, run_mae_pretrain
from nerf_mae_torch.common import load_mae_params
from nerf_mae_torch.config import SWIN_PRESETS, MAEConfig
from nerf_mae_torch.convert import expected_keys
from nerf_mae_torch.train.checkpoint import restore_checkpoint

torch.set_num_threads(1)

SIZE = ["--backbone_type", "swin_nano", "--resolution", "32", "--compute_dtype", "float32",
        "--device", "cpu"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A swin_nano MAE trained one step on the CPU by run_mae_pretrain, and
    one scene to serve."""
    root = tmp_path_factory.mktemp("mae_ckpt")
    ckpt = str(root / "ckpt")
    run_mae_pretrain.main([
        "--mode", "train", "--dataset", "synthetic", *SIZE, "--batch_size", "2",
        "--n_synthetic", "2", "--steps", "1", "--checkpoint_dir", ckpt,
        "--log_interval", "1", "--workers", "0", "--prefetch", "0"])
    rs = np.random.RandomState(3)
    grid = rs.rand(30, 27, 21, 4).astype(np.float32)
    grid[..., 3] = rs.randn(30, 27, 21) * 3
    np.savez(root / "scene.npz", rgbsigma=grid)
    return root, ckpt


def _serve(root, tag, weights):
    out = root / tag
    results = inference.main(["--scene_npz", str(root / "scene.npz"), *weights, *SIZE,
                              "--out_dir", str(out), "--save_features"])
    pred = np.load(out / "scene_pred.npz")
    feats = np.load(out / "scene_features.npz")
    return results[0], {"pred": pred["rgbsigma"], "mask": pred["token_mask"],
                        **{k: feats[k] for k in feats.files if k.startswith("level")}}


def test_serves_the_trainers_checkpoint_bitwise_as_params(trained):
    root, ckpt = trained
    state_pt = os.path.join(ckpt, "1", "state.pt")
    assert os.path.isfile(state_pt)
    bare = root / "bare.pt"
    torch.save(restore_checkpoint(ckpt)["params"], bare)
    want_summary, want = _serve(root, "bare", ["--params", str(bare)])
    assert want_summary["pred_finite"] and want_summary["features_finite"]
    for tag, weights in (("dir", ["--mae_checkpoint", ckpt]),
                         ("step", ["--mae_checkpoint", state_pt]),
                         ("params_step", ["--params", state_pt])):
        summary, got = _serve(root, tag, weights)
        assert summary["loss"] == want_summary["loss"], tag
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{tag}: {k}")


def test_load_mae_params_of_a_step_is_the_models_parameters(trained):
    _, ckpt = trained
    cfg = MAEConfig(swin=SWIN_PRESETS["swin_nano"], resolution=32, compute_dtype="float32")
    sd = load_mae_params(os.path.join(ckpt, "1", "state.pt"), cfg)
    assert set(sd) == expected_keys(cfg)
    restored = restore_checkpoint(ckpt)["params"]
    for k, v in sd.items():
        assert torch.equal(v, restored[k]), k


def test_an_orbax_directory_is_refused_naming_the_tool(tmp_path):
    state = tmp_path / "ckpt" / "5" / "state"
    state.mkdir(parents=True)
    (state / "_METADATA").write_text("{}")
    cfg = MAEConfig(swin=SWIN_PRESETS["swin_nano"], resolution=32)
    for path in (tmp_path / "ckpt", tmp_path / "ckpt" / "5"):
        with pytest.raises(ValueError, match="nerf_mae_torch.tools.orbax_to_npz"):
            load_mae_params(str(path), cfg)
