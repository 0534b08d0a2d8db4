"""The port's whole model against the JAX package, on the CPU.

A swin_b-shaped tiny config (4 stages, depths 2/2/2/2, embed 16) at 96^3:
token grid 24^3, so stage 1 sits at 12^3 with 27 windows (an odd count)
and stage 2 at 6^3, padded to 8^3 and shifted. Same numpy inputs and
weights through JAX SwinMAE3D (attention_impl="xla") and the port, float32,
at the golden tolerances of tests/test_parity_golden.py (features rtol 2e-3
/ atol 2e-4, reconstruction rtol 2e-3 / atol 5e-4, loss rtol 1e-3). Also the
reference golden fixture loaded straight into the port, and the weight
bridge.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

from convert_torch_checkpoint import convert_state_dict  # noqa: E402

from nerf_mae_tpu.config import MAEConfig as JMAEConfig  # noqa: E402
from nerf_mae_tpu.config import SwinConfig as JSwinConfig  # noqa: E402
from nerf_mae_tpu.models import mae as jmae  # noqa: E402
from nerf_mae_torch.config import MAEConfig, SwinConfig  # noqa: E402
from nerf_mae_torch.convert import load_weights, params_from_jax  # noqa: E402
from nerf_mae_torch.models import mae  # noqa: E402
from nerf_mae_torch.ops.fused_attention import fused_window_attention  # noqa: E402
from nerf_mae_torch.ops.fused_block import fused_swin_block  # noqa: E402

torch.set_num_threads(1)

SWIN = dict(embed_dim=16, depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4))
RES = 96
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "golden_mae_tiny.npz")


def _cfgs(gelu, impl="kernel"):
    j = JMAEConfig(swin=JSwinConfig(**SWIN, attention_impl="xla", gelu=gelu),
                   resolution=RES, compute_dtype="float32", remat=False)
    t = MAEConfig(swin=SwinConfig(**SWIN, attention_impl=impl, gelu=gelu),
                  resolution=RES, compute_dtype="float32")
    return j, t


@pytest.fixture(scope="module")
def inputs():
    rs = np.random.RandomState(0)
    scenes = [rs.rand(4, 90, 77, 85).astype(np.float32),
              rs.rand(4, 61, 96, 33).astype(np.float32)]
    for s in scenes:  # sparse occupancy, as real scenes have
        s[3] *= rs.rand(*s.shape[1:]) > 0.7
    grids, sizes = mae.pad_grids_to_batch(scenes, RES)
    blocks = rs.rand(2, 6, 6, 6) < 0.75
    token_mask = blocks.repeat(4, 1).repeat(4, 2).repeat(4, 3)
    # the JAX parameter tree's shapes (they do not depend on the resolution),
    # filled from numpy: fan-in scaled weights, nonzero biases, scales ~1
    jcfg = JMAEConfig(swin=JSwinConfig(**SWIN), resolution=32, remat=False,
                      compute_dtype="float32")
    shapes = jax.eval_shape(lambda: jmae.SwinMAE3D(jcfg).init(
        {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
        jnp.zeros((1, 32, 32, 32, 4)), True)["params"])

    def fill(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "scale":
            return (1.0 + 0.1 * rs.randn(*s.shape)).astype(np.float32)
        if len(s.shape) >= 2 and name != "rel_pos_bias_table":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rs.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (0.05 * rs.randn(*s.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    return grids, sizes, token_mask, params


def _port_model(cfg, params):
    model = mae.SwinMAE3D(cfg, device="cpu")
    load_weights(model, params_from_jax(params, cfg))
    return model.eval()


@pytest.mark.parametrize("gelu,impl", [
    ("tanh", "kernel"),  # fused-block plain versions on stages 0-2
    ("erf", "kernel"),   # fused-attention plain versions on stages 0-2
    ("tanh", "plain"),   # the plain composition everywhere
])
def test_forward_and_loss_match_jax(inputs, gelu, impl):
    grids, sizes, token_mask, params = inputs
    jcfg, cfg = _cfgs(gelu, impl)
    jpred, _ = jmae.SwinMAE3D(jcfg).apply(
        {"params": params}, jnp.asarray(grids), True,
        token_mask=jnp.asarray(token_mask))
    jloss, jaux = jmae.mae_loss(jpred, jnp.asarray(grids), jnp.asarray(token_mask),
                                jnp.asarray(sizes), jcfg)
    model = _port_model(cfg, params)
    counts = (fused_swin_block.launches, fused_window_attention.launches)
    with torch.no_grad():
        pred, mask = model(torch.from_numpy(grids),
                           token_mask=torch.from_numpy(token_mask))
        loss, aux = mae.mae_loss(pred, torch.from_numpy(grids), mask,
                                 torch.from_numpy(sizes), cfg)
    # CPU tensors never launch a kernel
    assert counts == (fused_swin_block.launches, fused_window_attention.launches)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=2e-3, atol=5e-4)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-3)
    for k in ("loss_rgb", "loss_alpha", "n_rgb", "n_alpha"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-3)


def test_encode_matches_jax(inputs):
    grids, _, _, params = inputs
    jcfg, cfg = _cfgs("tanh")
    jfeats = jmae.SwinMAE3D(jcfg).apply({"params": params}, jnp.asarray(grids),
                                        True, method=jmae.SwinMAE3D.encode)
    with torch.no_grad():
        feats = _port_model(cfg, params).encode(torch.from_numpy(grids))
    assert [tuple(f.shape[1:4]) for f in feats] == [(24,) * 3, (12,) * 3,
                                                    (6,) * 3, (3,) * 3]
    for i, (f, jf) in enumerate(zip(feats, jfeats)):
        np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=2e-3,
                                   atol=2e-4, err_msg=f"level {i}")


def test_patched_paths_match_voxel_path(inputs):
    """Patched input [B, T, T, T, p^3 * 4] and patched_pred give the same
    numbers as the voxel path (one product vs a conv: float32 sums)."""
    grids, _, token_mask, params = inputs
    _, cfg = _cfgs("tanh")
    model = _port_model(cfg, params)
    patched = mae.patchify_3d(torch.from_numpy(grids), 4).reshape(2, 24, 24, 24, -1)
    tm = torch.from_numpy(token_mask)
    with torch.no_grad():
        pred, _ = model(torch.from_numpy(grids), token_mask=tm)
        pred_p, _ = model(patched, token_mask=tm, patched_pred=True)
    np.testing.assert_allclose(mae.patchify_3d(pred, 4).numpy(), pred_p.numpy(),
                               rtol=1e-4, atol=1e-5)


def test_mae_loss_matches_jax():
    rs = np.random.RandomState(3)
    cfg_j = JMAEConfig(swin=JSwinConfig(**SWIN), resolution=32)
    cfg = MAEConfig(swin=SwinConfig(**SWIN), resolution=32)
    pred = rs.randn(2, 32, 32, 32, 4).astype(np.float32)
    target = rs.rand(2, 32, 32, 32, 4).astype(np.float32)
    target[..., 3] *= rs.rand(2, 32, 32, 32) > 0.5
    mask = rs.rand(2, 8, 8, 8) < 0.6
    sizes = np.array([[32, 20, 9], [17, 32, 31]], np.int32)
    jl, jaux = jmae.mae_loss(jnp.asarray(pred), jnp.asarray(target),
                             jnp.asarray(mask), jnp.asarray(sizes), cfg_j)
    t = torch.from_numpy
    loss, aux = mae.mae_loss(t(pred), t(target), t(mask), t(sizes), cfg)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5)


def test_pad_grids_to_batch_matches_jax():
    rs = np.random.RandomState(4)
    scenes = [rs.rand(4, 5, 7, 3).astype(np.float32),
              rs.rand(4, 2, 8, 4).astype(np.float32)]
    for channel_first in (True, False):
        if not channel_first:
            scenes = [np.moveaxis(s, 0, -1) for s in scenes]
        got = mae.pad_grids_to_batch(scenes, 8, channel_first=channel_first)
        want = jmae.pad_grids_to_batch(scenes, 8, channel_first=channel_first)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_bridge_round_trip(inputs):
    """JAX tree -> params_from_jax -> convert_state_dict gives the same
    tree back (all but the subpixel head, which has no reference name; the
    forward test above covers its mapping)."""
    params = inputs[3]
    _, cfg = _cfgs("tanh")
    sd = params_from_jax(params, cfg)
    back = convert_state_dict({k: v.numpy() for k, v in sd.items()}, SWIN["depths"])
    flat = lambda tree: {"/".join(str(getattr(k, "key", k)) for k in path): v
                         for path, v in jax.tree_util.tree_leaves_with_path(tree)}
    want = {k: v for k, v in flat(params).items()
            if not k.startswith("subpixel_head")}
    got = flat(back)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the flat "/"-joined form with a leading "params" level maps the same
    flat_sd = params_from_jax({f"params/{k}": v for k, v in flat(params).items()}, cfg)
    assert all(torch.equal(flat_sd[k], sd[k]) for k in sd)


@pytest.fixture(scope="module")
def golden():
    f = dict(np.load(FIXTURE, allow_pickle=False).items())
    cfg = MAEConfig(
        swin=SwinConfig(embed_dim=int(f["meta_embed_dim"]),
                        depths=tuple(int(d) for d in f["meta_depths"]),
                        num_heads=tuple(int(h) for h in f["meta_num_heads"]),
                        gelu="erf"),
        resolution=int(f["meta_resolution"]), decoder_type="unetr",
        compute_dtype="float32")
    model = mae.SwinMAE3D(cfg, device="cpu")
    load_weights(model, {k[3:]: v for k, v in f.items() if k.startswith("sd.")})
    rs = np.random.RandomState(1)  # the generator's grids, same order
    g0 = rs.rand(4, 64, 64, 64).astype(np.float32)
    g1 = rs.rand(4, 48, 56, 64).astype(np.float32)
    grids, sizes = mae.pad_grids_to_batch([g0, g1], cfg.resolution)
    tm = torch.from_numpy(f["token_mask"])
    g = torch.from_numpy(grids)
    with torch.no_grad():
        x = torch.where(tm[..., None], model.mask_token, model.embed(g))
        feats = model.stages(x)
        pred, _ = model(g, token_mask=tm, patched_pred=True)
        loss, aux = mae.mae_loss(pred, g, tm, torch.from_numpy(sizes), cfg)
    return f, feats, pred, loss, aux


def test_golden_stage_features(golden):
    f, feats = golden[:2]
    for i, feat in enumerate(feats):
        np.testing.assert_allclose(feat.numpy(), f[f"stage{i}"], rtol=2e-3,
                                   atol=2e-4, err_msg=f"stage {i}")


def test_golden_reconstruction(golden):
    f, _, pred = golden[:3]
    np.testing.assert_allclose(pred.numpy(), f["pred"], rtol=2e-3, atol=5e-4)


def test_golden_loss_terms(golden):
    f, _, _, loss, aux = golden
    np.testing.assert_allclose(float(aux["loss_rgb"]), f["loss_rgb"], rtol=1e-3)
    np.testing.assert_allclose(float(aux["loss_alpha"]), f["loss_alpha"], rtol=1e-3)
    np.testing.assert_allclose(float(loss), f["loss"], rtol=1e-3)
