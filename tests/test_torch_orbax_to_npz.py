"""`nerf_mae_torch.tools.orbax_to_npz`: a checkpoint that the JAX package's
save_checkpoint wrote (orbax: params and the AdamW state) becomes the flat
.npz that the port serves. The served reconstruction, loss and features
match JAX's forward of the same parameters at the golden tolerances
(features rtol 2e-3 / atol 2e-4, loss rtol 1e-3; the reconstruction at
tests/test_torch_inference.py's rtol 2e-3 / atol 5e-4). The tool reads
every storage layout orbax writes (OCDBT or a directory per leaf, zarr v2
or v3), picks the newest step or --step, names a leaf it cannot read, and
imports neither jax nor orbax.

The checkpoint's optimizer state comes from one update of the JAX trainer's
optimizer (train/optim.make_optimizer) with gradients drawn with numpy:
compiling the JAX train step at swin_nano 32^3 takes ~50 s on one core."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch

from nerf_mae_tpu.config import SWIN_PRESETS as JPRESETS
from nerf_mae_tpu.config import MAEConfig as JMAEConfig
from nerf_mae_tpu.config import TrainConfig as JTrainConfig
from nerf_mae_tpu.models import mae as jmae
from nerf_mae_tpu.train.checkpoint import save_checkpoint
from nerf_mae_tpu.train.optim import make_optimizer
from nerf_mae_torch import inference
from nerf_mae_torch.tools import orbax_to_npz

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = JMAEConfig(swin=JPRESETS["swin_nano"], resolution=32, compute_dtype="float32",
                  remat=False)


def _jax_params(seed):
    rs = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda: jmae.SwinMAE3D(JCFG).init(
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


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """Steps 1 and 2 of a swin_nano MAE saved by the JAX save_checkpoint,
    each after one AdamW update; returns (dir, {step: params})."""
    root = tmp_path_factory.mktemp("orbax")
    ckpt = str(root / "ckpt")
    tx = make_optimizer(JTrainConfig(), 10)
    update = jax.jit(tx.update)
    params = _jax_params(0)
    opt_state = tx.init(params)
    saved = {}
    rs = np.random.RandomState(1)
    for step in (1, 2):
        grads = jax.tree.map(lambda p: jnp.asarray(0.01 * rs.randn(*p.shape), p.dtype),
                             params)
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        save_checkpoint(ckpt, step, params, opt_state)
        saved[step] = params
    return ckpt, saved


def test_served_npz_matches_the_jax_forward(jax_checkpoint, tmp_path):
    ckpt, saved = jax_checkpoint
    npz = str(tmp_path / "params.npz")
    assert orbax_to_npz.main([ckpt, "--out", npz]) == npz
    params = saved[2]  # the newest step
    rs = np.random.RandomState(2)
    grid = rs.rand(29, 31, 17, 4).astype(np.float32)
    grid[..., 3] = rs.randn(29, 31, 17) * 3
    np.savez(tmp_path / "scene.npz", rgbsigma=grid)

    served = {}
    for flag in ("--params", "--mae_checkpoint"):
        out = tmp_path / flag.strip("-")
        res = inference.main([
            "--scene_npz", str(tmp_path / "scene.npz"), flag, npz,
            "--backbone_type", "swin_nano", "--resolution", "32",
            "--compute_dtype", "float32", "--out_dir", str(out), "--save_features",
            "--device", "cpu"])[0]
        served[flag] = (res, np.load(out / "scene_pred.npz"),
                        np.load(out / "scene_features.npz"))

    token_mask = served["--params"][1]["token_mask"]
    g = grid.copy()
    g[..., 3] = np.clip(1.0 - np.exp(-np.exp(g[..., 3]) / 100.0), 0.0, 1.0)
    batch, sizes = jmae.pad_grids_to_batch([g], 32, channel_first=False)
    model = jmae.SwinMAE3D(JCFG)

    @jax.jit  # one compile is cheaper than the eager forward on the CPU
    def reference(params, grids, mask):
        pred, _ = model.apply({"params": params}, grids, True, token_mask=mask)
        loss, _ = jmae.mae_loss(pred, grids, mask, jnp.asarray(sizes), JCFG)
        feats = model.apply({"params": params}, grids, True, method=jmae.SwinMAE3D.encode)
        return pred, loss, feats

    jpred, jloss, jfeats = reference(params, jnp.asarray(batch),
                                     jnp.asarray(token_mask[None]))
    for flag, (res, pred, feats) in served.items():
        np.testing.assert_array_equal(pred["token_mask"], token_mask)
        np.testing.assert_allclose(pred["rgbsigma"], np.asarray(jpred)[0], rtol=2e-3,
                                   atol=5e-4, err_msg=flag)
        np.testing.assert_allclose(res["loss"], float(jloss), rtol=1e-3, err_msg=flag)
        for i, jf in enumerate(jfeats):
            np.testing.assert_allclose(feats[f"level{i}"], np.asarray(jf)[0], rtol=2e-3,
                                       atol=2e-4, err_msg=f"{flag}: level {i}")


def test_steps_and_keys(jax_checkpoint, tmp_path):
    ckpt, saved = jax_checkpoint
    assert orbax_to_npz.checkpoint_steps(ckpt) == [1, 2]
    step, n = orbax_to_npz.convert(ckpt, str(tmp_path / "s1.npz"), step=1)
    want = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(saved[1])}
    with np.load(tmp_path / "s1.npz") as f:
        assert step == 1 and n == len(want) and set(f.files) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(f[k], v, err_msg=k)
    with pytest.raises(FileNotFoundError, match="step 3"):
        orbax_to_npz.convert(ckpt, str(tmp_path / "s3.npz"), step=3)


def test_the_tool_imports_neither_jax_nor_orbax(jax_checkpoint, tmp_path):
    ckpt, _ = jax_checkpoint
    code = (
        "import sys\n"
        "from nerf_mae_torch.tools import orbax_to_npz\n"
        f"orbax_to_npz.main([{ckpt!r}, '--out', {str(tmp_path / 'p.npz')!r}])\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules}\n"
        "             & {'jax', 'jaxlib', 'flax', 'optax', 'orbax', 'nerf_mae_tpu'})\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "clean" in out.stdout and (tmp_path / "p.npz").exists()


@pytest.mark.parametrize("use_ocdbt,use_zarr3", [(True, False), (True, True),
                                                 (False, False), (False, True)])
def test_reads_every_storage_layout(tmp_path, use_ocdbt, use_zarr3):
    tree = {"params": {"encoder": {"w": np.arange(6.0, dtype=np.float32).reshape(2, 3)},
                       "b": jnp.asarray([1.5, -2.0, 3.0], jnp.bfloat16)},
            "opt_state": {"count": np.int32(3)}}
    ckpt = str(tmp_path / "ckpt")
    handler = ocp.PyTreeCheckpointHandler(use_ocdbt=use_ocdbt, use_zarr3=use_zarr3)
    with ocp.CheckpointManager(ckpt, options=ocp.CheckpointManagerOptions(create=True),
                               item_handlers={"state": handler}) as mgr:
        mgr.save(4, args=ocp.args.Composite(state=ocp.args.PyTreeSave(tree)))
        mgr.wait_until_finished()
    out = str(tmp_path / "p.npz")
    assert orbax_to_npz.convert(ckpt, out) == (4, 2)
    with np.load(out) as f:
        assert sorted(f.files) == ["b", "encoder/w"]
        np.testing.assert_array_equal(f["encoder/w"], tree["params"]["encoder"]["w"])
        assert f["b"].dtype == np.float32
        np.testing.assert_array_equal(f["b"], [1.5, -2.0, 3.0])
    if not use_ocdbt:  # a leaf's directory gone: the error names its key
        shutil.rmtree(os.path.join(ckpt, "4", "state", "params.encoder.w"))
        with pytest.raises(ValueError, match="'encoder/w'"):
            orbax_to_npz.convert(ckpt, out)
