"""The port's dense downstream heads against the JAX package, on the CPU.

VoxelSR3D (32 -> 48 and the non-integer 32 -> 52) and VoxelSemantics3D
forwards from the same weights (carried by head_params_from_jax) at the
golden tolerances of tests/test_parity_golden.py (rtol 2e-3 / atol 2e-4);
both losses with and without class weights and with void voxels (loss rtol
1e-3, with their gradients); calculate_class_weights and
intersection_and_union exactly; the nearest index map against
jax.image.resize; the SR tail the port runs (1x1 conv, then the nearest
gather) against the JAX order (gather, then conv), values and gradients;
the lean instance norm against JAX's, whole batch and a sample at a time.
Tiny config: embed 12, depths (1, 1, 1, 1), resolution 32, float32,
stochastic depth 0 (tests/test_heads.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_mae_tpu.config import MAEConfig as JMAEConfig
from nerf_mae_tpu.config import SwinConfig as JSwinConfig
from nerf_mae_tpu.models import heads as jheads
from nerf_mae_tpu.models import unetr as junetr
from nerf_mae_tpu.models.unetr import UnetOutBlock3D as JUnetOutBlock3D
from nerf_mae_torch.config import MAEConfig, SwinConfig
from nerf_mae_torch.convert import head_model, head_params_from_jax
from nerf_mae_torch.models import heads, unetr
from nerf_mae_torch.models.unetr import UnetOutBlock3D

torch.set_num_threads(1)

TINY = dict(embed_dim=12, depths=(1, 1, 1, 1), num_heads=(3, 6, 12, 24),
            stochastic_depth_prob=0.0)
RTOL, ATOL = 2e-3, 2e-4


def cfgs():
    j = JMAEConfig(swin=JSwinConfig(**TINY, attention_impl="xla"), resolution=32,
                   compute_dtype="float32", remat=False)
    t = MAEConfig(swin=SwinConfig(**TINY), resolution=32, compute_dtype="float32")
    return j, t


def fill_params(shapes, seed):
    """Numpy parameters for a tree of ShapeDtypeStructs: LN scales near 1,
    kernels at fan-in scale, the rest small."""
    rs = np.random.RandomState(seed)

    def fill(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "scale":
            return (1.0 + 0.1 * rs.randn(*s.shape)).astype(np.float32)
        if len(s.shape) >= 2 and name != "rel_pos_bias_table":
            return (rs.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return (0.05 * rs.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_head(kind, jcfg, **kw):
    if kind == "sr":
        return jheads.VoxelSR3D(jcfg, **kw)
    return jheads.VoxelSemantics3D(jcfg, **kw)


def head_params(model, seed=0):
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "droppath": jax.random.PRNGKey(1)},
        jnp.zeros((1, 32, 32, 32, 4)), True)["params"])
    return fill_params(shapes, seed)


def scenes(n=2, seed=0):
    rs = np.random.RandomState(seed)
    g = rs.rand(n, 32, 32, 32, 4).astype(np.float32)
    g[..., 3] *= rs.rand(n, 32, 32, 32) > 0.5
    return g


@pytest.mark.parametrize("kind,kw", [("sr", {"out_resolution": 48}),
                                     ("sr", {"out_resolution": 52}),
                                     ("semantics", {"num_classes": 5})])
def test_head_forward_matches_jax(kind, kw):
    jcfg, cfg = cfgs()
    jmodel = jax_head(kind, jcfg, **kw)
    params = head_params(jmodel, seed=1)
    grids = scenes()
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(grids), True))
    model = head_model(cfg, kind, device="cpu", **kw)
    model.load_state_dict(head_params_from_jax(params, cfg, kind))
    with torch.no_grad():
        got = model(torch.from_numpy(grids)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_head_params_from_jax_raises_on_missing_and_unknown():
    jcfg, cfg = cfgs()
    params = head_params(jax_head("sr", jcfg, out_resolution=48))
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(params)}
    sd = head_params_from_jax(flat, cfg, "sr")
    assert {k.split(".")[0] for k in sd} == {"base", "encoder1", "decoder1", "voxel_out"}
    assert "encoder1.conv3.weight" in sd and "decoder1.conv_block.conv3.weight" in sd
    with pytest.raises(KeyError, match="missing"):
        head_params_from_jax({k: v for k, v in flat.items() if "decoder1/up" not in k},
                             cfg, "sr")
    with pytest.raises(KeyError, match="unexpected"):
        head_params_from_jax({**flat, "base/mask_token": np.zeros(12, np.float32)},
                             cfg, "sr")
    with pytest.raises(KeyError, match="unknown JAX parameter"):
        head_params_from_jax({**flat, "voxel_out/bogus/kernel": np.zeros(1)}, cfg, "sr")
    with pytest.raises(KeyError):  # an SR tree is not a semantics tree
        head_params_from_jax(flat, cfg, "semantics")


@pytest.mark.parametrize("in_size,out_size", [(160, 256), (160, 384), (32, 48), (8, 13)])
def test_nearest_indices_match_jax_resize(in_size, out_size):
    src = jnp.arange(in_size, dtype=jnp.float32)
    want = np.asarray(jax.image.resize(src, (out_size,), "nearest")).astype(np.int64)
    got = heads.nearest_indices(in_size, out_size)
    assert int((got != want).sum()) == 0
    x = torch.arange(in_size, dtype=torch.float32).reshape(1, in_size, 1, 1, 1)
    x = x.expand(1, in_size, 2, 2, 1)
    resized = heads.nearest_resize(x, out_size)
    assert resized.shape == (1, out_size, out_size, out_size, 1)
    np.testing.assert_array_equal(resized[0, :, 0, 0, 0].numpy(), want)


def test_commuted_sr_tail_matches_the_jax_order():
    """voxel_out (a 1x1 conv) at R^3, then the nearest gather to R_out^3,
    against JAX's jax.image.resize then conv: values, and the gradients of
    a random cotangent with respect to the features and the conv's
    parameters."""
    rs = np.random.RandomState(3)
    d = rs.randn(2, 8, 8, 8, 6).astype(np.float32)
    cot = rs.randn(2, 13, 13, 13, 4).astype(np.float32)
    jout = JUnetOutBlock3D(4, dtype=jnp.float32)
    p = jout.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 2, 2, 6)))["params"]
    p = jax.tree.map(lambda a: jnp.asarray(rs.randn(*a.shape).astype(np.float32)), p)

    def jax_tail(p, d):
        up = jax.image.resize(d, (2, 13, 13, 13, 6), method="nearest")
        return (jout.apply({"params": p}, up).astype(jnp.float32) * cot).sum()

    jgp, jgd = jax.grad(jax_tail, argnums=(0, 1))(p, jnp.asarray(d))
    want = np.asarray(jout.apply({"params": p}, jax.image.resize(
        jnp.asarray(d), (2, 13, 13, 13, 6), method="nearest")))

    out = UnetOutBlock3D(6, 4, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        out.conv.weight.copy_(torch.from_numpy(
            np.transpose(np.asarray(p["conv"]["kernel"]), (4, 3, 0, 1, 2)).copy()))
        out.conv.bias.copy_(torch.from_numpy(np.array(p["conv"]["bias"])))
    td = torch.from_numpy(d).requires_grad_(True)
    got = heads.nearest_resize(out(td).float(), 13)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(jgd), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.conv.bias.grad.numpy(), np.asarray(jgp["conv"]["bias"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        out.conv.weight.grad.numpy(),
        np.transpose(np.asarray(jgp["conv"]["kernel"]), (4, 3, 0, 1, 2)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [1 << 28, 1])  # the whole batch; one sample at a time
def test_instance_norm_matches_jax(monkeypatch, chunk, dtype):
    """The lean instance norm (its own backward, float32 temporaries a
    chunk of samples at a time) against JAX's, values and gradients."""
    monkeypatch.setattr(unetr._InstanceNorm3d, "CHUNK", chunk)
    rs = np.random.RandomState(4)
    x = (3.0 + 2.0 * rs.randn(3, 5, 6, 7, 8)).astype(np.float32)
    cot = rs.randn(3, 5, 6, 7, 8).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want, vjp = jax.vjp(junetr.instance_norm_3d, jx)
    (jdx,) = vjp(jnp.asarray(cot).astype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    got = unetr.instance_norm_3d(tx)
    assert got.dtype == tx.dtype
    got.backward(torch.from_numpy(cot).to(tx.dtype))
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)
    np.testing.assert_allclose(tx.grad.float().numpy(), np.asarray(jdx.astype(jnp.float32)),
                               **tol)


def _grad_close(torch_fn, jax_fn, x):
    tx = torch.from_numpy(x).requires_grad_(True)
    loss, aux = torch_fn(tx)
    loss.backward()
    (jloss, jaux), jg = jax.value_and_grad(jax_fn, has_aux=True)(jnp.asarray(x))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-3)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-3, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), rtol=1e-3, atol=1e-7)


@pytest.mark.parametrize("empty", [False, True])
def test_voxel_sr_loss_matches_jax(empty):
    rs = np.random.RandomState(0)
    pred = rs.randn(2, 9, 9, 9, 4).astype(np.float32)
    tgt = rs.rand(2, 9, 9, 9, 4).astype(np.float32)
    tgt[..., 3] *= rs.rand(2, 9, 9, 9) > 0.4
    if empty:
        tgt[..., 3] = 0.0
    _grad_close(lambda p: heads.voxel_sr_loss(p, torch.from_numpy(tgt)),
                lambda p: jheads.voxel_sr_loss(p, jnp.asarray(tgt)), pred)


@pytest.mark.parametrize("weighted", [False, True])
def test_voxel_semantics_loss_matches_jax(weighted):
    """Void voxels (label 0) stay in the mean with zeroed logits; class 3
    is absent from the target (soft mIoU averages over present classes)."""
    rs = np.random.RandomState(1)
    logits = (2 * rs.randn(2, 7, 7, 7, 5)).astype(np.float32)
    target = rs.choice([0, 1, 2, 4], size=(2, 7, 7, 7)).astype(np.int32)
    w = heads.calculate_class_weights(list(target), 5) if weighted else None
    assert (target == 0).any()
    _grad_close(
        lambda lg: heads.voxel_semantics_loss(
            lg, torch.from_numpy(target), None if w is None else torch.from_numpy(w)),
        lambda lg: jheads.voxel_semantics_loss(
            lg, jnp.asarray(target), None if w is None else jnp.asarray(w)),
        logits)


def test_class_weights_and_confusion_counts_match_jax():
    rs = np.random.RandomState(2)
    labels = [rs.randint(0, 7, (6, 5, 4)) for _ in range(3)]
    np.testing.assert_array_equal(heads.calculate_class_weights(labels, 7),
                                  jheads.calculate_class_weights(labels, 7))
    pred = rs.randint(0, 7, (2, 6, 6, 6))
    tgt = rs.randint(0, 7, (2, 6, 6, 6))
    for ignore_zero in (True, False):
        got = heads.intersection_and_union(pred, tgt, 7, ignore_zero)
        want = jheads.intersection_and_union(pred, tgt, 7, ignore_zero)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
