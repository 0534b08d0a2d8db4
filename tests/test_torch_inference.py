"""The port's inference entry point, its weight loading and its import
boundary.

`python -m nerf_mae_torch.inference` runs on the CPU with --device cpu on a
tiny swin_nano scene, with weights exported from a JAX parameter tree the
way the README shows (flattened with "/" and saved with np.savez). Its
outputs are checked against JAX SwinMAE3D fed the same mask, float32, at
the golden tolerances (reconstruction rtol 2e-3 / atol 5e-4, features rtol
2e-3 / atol 2e-4).
"""

import ast
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_mae_tpu.config import SWIN_PRESETS as JPRESETS
from nerf_mae_tpu.config import MAEConfig as JMAEConfig
from nerf_mae_tpu.models import mae as jmae
from nerf_mae_torch import inference

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _jax_params(cfg, seed):
    rs = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda: jmae.SwinMAE3D(cfg).init(
        {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
        jnp.zeros((1, 32, 32, 32, 4)), True)["params"])

    def fill(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "scale":
            return (1.0 + 0.1 * rs.randn(*s.shape)).astype(np.float32)
        if len(s.shape) >= 2 and name != "rel_pos_bias_table":
            return (rs.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return (0.05 * rs.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_inference_cli_matches_jax(tmp_path):
    jcfg = JMAEConfig(swin=JPRESETS["swin_nano"], resolution=32,
                      compute_dtype="float32", remat=False)
    params = _jax_params(jcfg, 0)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(params)}
    np.savez(tmp_path / "params.npz", **flat)

    rs = np.random.RandomState(1)
    grid = rs.rand(29, 31, 17, 4).astype(np.float32)
    grid[..., 3] = rs.randn(29, 31, 17) * 3  # raw density
    bbox = np.array([0.0, 1.0, 2.0], np.float32)
    np.savez(tmp_path / "scene_a.npz", rgbsigma=grid, bbox_min=bbox, resolution=29)

    out = tmp_path / "out"
    results = inference.main([
        "--scene_npz", str(tmp_path / "scene_a.npz"),
        "--params", str(tmp_path / "params.npz"),
        "--backbone_type", "swin_nano", "--resolution", "32",
        "--compute_dtype", "float32", "--out_dir", str(out),
        "--save_features", "--device", "cpu",
    ])
    assert [r["scene"] for r in results] == ["scene_a"]
    assert results[0]["pred_finite"] and results[0]["features_finite"]
    for suffix in ("target", "masked", "pred"):
        assert (out / f"scene_a_{suffix}.ply").read_text().startswith("ply\n")

    saved = np.load(out / "scene_a_pred.npz")
    np.testing.assert_array_equal(saved["bbox_min"], bbox)  # metadata passthrough
    assert int(saved["resolution"]) == 29
    np.testing.assert_array_equal(saved["valid_size"], [29, 31, 17])
    token_mask = saved["token_mask"]
    assert token_mask.shape == (8, 8, 8) and token_mask.any()

    # the same grid through JAX, with the port's mask
    g = grid.copy()
    g[..., 3] = np.clip(1.0 - np.exp(-np.exp(g[..., 3]) / 100.0), 0.0, 1.0)
    batch, sizes = jmae.pad_grids_to_batch([g], 32, channel_first=False)
    model = jmae.SwinMAE3D(jcfg)
    jpred, _ = model.apply({"params": params}, jnp.asarray(batch), True,
                           token_mask=jnp.asarray(token_mask[None]))
    np.testing.assert_allclose(saved["rgbsigma"], np.asarray(jpred)[0],
                               rtol=2e-3, atol=5e-4)
    jl, _ = jmae.mae_loss(jpred, jnp.asarray(batch), jnp.asarray(token_mask[None]),
                          jnp.asarray(sizes), jcfg)
    np.testing.assert_allclose(results[0]["loss"], float(jl), rtol=1e-3)

    feats = np.load(out / "scene_a_features.npz")
    jfeats = model.apply({"params": params}, jnp.asarray(batch), True,
                         method=jmae.SwinMAE3D.encode)
    for i, jf in enumerate(jfeats):
        np.testing.assert_allclose(feats[f"level{i}"], np.asarray(jf)[0],
                                   rtol=2e-3, atol=2e-4, err_msg=f"level {i}")


def test_cuda_without_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    np.savez(tmp_path / "s.npz", rgbsigma=np.zeros((8, 8, 8, 4), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference.main(["--scene_npz", str(tmp_path / "s.npz"), "--init_seed", "0",
                        "--backbone_type", "swin_nano", "--resolution", "32",
                        "--out_dir", str(tmp_path / "o"), "--device", "cuda"])


_FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "nerf_mae_tpu", "scripts"}


def _port_files():
    files = sorted((ROOT / "nerf_mae_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names = [node.args[0].value]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in _FORBIDDEN, f"{path}: imports {name}"
