"""The port's numpy and plain-PyTorch ops against the JAX package's.

Index and layout helpers must agree exactly; window attention runs in
float32 and agrees to rtol/atol 1e-5 (both sides sum float32 products in
their own order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_mae_tpu.ops import masking as jmask
from nerf_mae_tpu.ops import patchify as jpatch
from nerf_mae_tpu.ops import pos_embed as jpos
from nerf_mae_tpu.ops import window_attention as jwa
from nerf_mae_torch.ops import masking, patchify, pos_embed
from nerf_mae_torch.ops import window_attention as wa

torch.set_num_threads(1)


def test_partition_unpartition_exact():
    x = np.random.RandomState(0).randn(2, 8, 4, 12, 3).astype(np.float32)
    got, counts = wa.window_partition_3d(torch.from_numpy(x), (4, 4, 4))
    want, jcounts = jwa.window_partition_3d(jnp.asarray(x), (4, 4, 4))
    assert counts == jcounts
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = wa.window_unpartition_3d(got, (4, 4, 4), counts)
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("window", [(4, 4, 4), (2, 3, 4)])
def test_relative_position_index_exact(window):
    np.testing.assert_array_equal(wa.relative_position_index_3d(window),
                                  jwa.relative_position_index_3d(window))


@pytest.mark.parametrize("grid,shift", [
    ((8, 8, 8), (2, 2, 2)), ((12, 8, 4), (2, 2, 0)), ((8, 8, 8), (0, 0, 0)),
])
def test_shifted_window_mask_exact(grid, shift):
    got = wa.shifted_window_mask(grid, (4, 4, 4), shift)
    want = jwa.shifted_window_mask(grid, (4, 4, 4), shift)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)


def test_patchify_family_exact():
    rs = np.random.RandomState(1)
    x = rs.rand(2, 16, 16, 16, 4).astype(np.float32)
    got = patchify.patchify_3d(torch.from_numpy(x), 4).numpy()
    np.testing.assert_array_equal(got, np.asarray(jpatch.patchify_3d(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(patchify.patchify_np(x, 4), jpatch.patchify_np(x, 4))
    back = patchify.unpatchify_3d(torch.from_numpy(got), 4).numpy()
    np.testing.assert_array_equal(back, x)
    flat = got.reshape(2, 4, 4, 4, -1)
    np.testing.assert_array_equal(
        patchify.maybe_unflatten_patches(torch.from_numpy(flat), 4).numpy(),
        np.asarray(jpatch.maybe_unflatten_patches(jnp.asarray(flat), 4)))
    # the voxel grid passes through unchanged
    assert patchify.maybe_unflatten_patches(torch.from_numpy(x), 4).shape == x.shape


def test_voxel_validity_mask_exact():
    sizes = np.array([[5, 8, 3], [8, 1, 7]], np.int32)
    got = patchify.voxel_validity_mask(torch.from_numpy(sizes), 8).numpy()
    want = np.asarray(jpatch.voxel_validity_mask(jnp.asarray(sizes), 8))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dim,grid", [(12, 4), (128, 5), (16, 6)])
def test_sincos_pos_embed_exact(dim, grid):
    np.testing.assert_array_equal(pos_embed.sincos_pos_embed_3d(dim, grid),
                                  jpos.sincos_pos_embed_3d(dim, grid))


def _attn_params(rs, c, heads):
    return dict(
        qkv_kernel=rs.randn(c, 3 * c).astype(np.float32) * 0.1,
        qkv_bias=rs.randn(3 * c).astype(np.float32) * 0.1,
        proj_kernel=rs.randn(c, c).astype(np.float32) * 0.1,
        proj_bias=rs.randn(c).astype(np.float32) * 0.1,
        bias_table=rs.randn(343, heads).astype(np.float32) * 0.1,
    )


@pytest.mark.parametrize("shape,shift", [
    ((2, 8, 8, 8, 16), (0, 0, 0)),    # unshifted
    ((2, 8, 8, 8, 16), (2, 2, 2)),    # shifted
    ((1, 6, 6, 6, 16), (2, 2, 2)),    # padded to 8^3 and shifted
    ((1, 4, 4, 12, 8), (2, 2, 2)),    # window covers two axes: shift on one
])
def test_window_attention_matches_jax(shape, shift):
    rs = np.random.RandomState(2)
    heads = 2
    x = rs.randn(*shape).astype(np.float32)
    p = _attn_params(rs, shape[-1], heads)
    want = jwa.window_attention_3d(
        jnp.asarray(x), jnp.asarray(p["qkv_kernel"]), jnp.asarray(p["qkv_bias"]),
        jnp.asarray(p["proj_kernel"]), jnp.asarray(p["proj_bias"]),
        jnp.asarray(p["bias_table"]), (4, 4, 4), shift, heads)
    t = torch.from_numpy
    got = wa.window_attention_3d(
        t(x), t(p["qkv_kernel"].T.copy()), t(p["qkv_bias"]),
        t(p["proj_kernel"].T.copy()), t(p["proj_bias"]), t(p["bias_table"]),
        (4, 4, 4), shift, heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def test_block_mask_ratio_and_block_structure():
    m = masking.block_mask_3d(_gen(0), 4, 32, block=4, p_remove=0.75).numpy()
    assert m.shape == (4, 32, 32, 32) and m.dtype == np.bool_
    assert 0.65 < m.mean() < 0.85  # 2048 Bernoulli(0.75) blocks
    blocks = m.reshape(4, 8, 4, 8, 4, 8, 4)
    # constant inside every 4^3 token block
    assert (blocks.min(axis=(2, 4, 6)) == blocks.max(axis=(2, 4, 6))).all()


def test_block_mask_per_sample_vs_shared():
    per = masking.block_mask_3d(_gen(1), 3, 16, per_sample=True).numpy()
    shared = masking.block_mask_3d(_gen(1), 3, 16, per_sample=False).numpy()
    assert not (per[0] == per[1]).all() or not (per[1] == per[2]).all()
    assert (shared[0] == shared[1]).all() and (shared[1] == shared[2]).all()


def test_block_mask_grid_strategy_matches_jax():
    got = masking.block_mask_3d(_gen(2), 2, 16, strategy="grid").numpy()
    want = np.asarray(jmask.block_mask_3d(None, 2, 16, strategy="grid"))
    np.testing.assert_array_equal(got, want)
    assert got.mean() == pytest.approx(0.25, abs=1 / 64)
    with pytest.raises(ValueError):
        masking.block_mask_3d(_gen(2), 1, 16, strategy="nope")
