"""The port's fused Swin-block wrapper against the JAX package.

On a CPU tensor the wrapper runs the kernel's plain version, so these tests
hold the kernel's semantics against JAX SwinBlock3D (attention_impl="xla")
in float32 at rtol/atol 2e-5 (the fused-block kernel's own tolerance
against the XLA path in tests/test_pallas_block.py). The kernel itself
runs only on the card; chip_smoke.py holds it against this plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_mae_tpu.models.swin import SwinBlock3D as JaxBlock
from nerf_mae_tpu.models.swin import _dense, layer_norm
from nerf_mae_tpu.ops import pallas_block as jpb
from nerf_mae_tpu.ops.window_attention import window_attention_3d
from nerf_mae_torch.ops.fused_block import fused_swin_block
from nerf_mae_torch.ops.window_attention import kernel_supported

torch.set_num_threads(1)
WINDOW = (4, 4, 4)


def _params(rs, c, heads):
    n = lambda *shape: (rs.randn(*shape) * 0.05).astype(np.float32)
    return dict(
        ln1_scale=1.0 + n(c), ln1_bias=n(c),
        qkv_kernel=n(c, 3 * c), qkv_bias=n(3 * c),
        proj_kernel=n(c, c), proj_bias=n(c),
        ln2_scale=1.0 + n(c), ln2_bias=n(c),
        fc1_kernel=n(c, 4 * c), fc1_bias=n(4 * c),
        fc2_kernel=n(4 * c, c), fc2_bias=n(c),
        bias_table=n(343, heads),
    )


def _jax_tree(p):
    """The flax parameter tree of SwinBlock3D for the same weights."""
    return {
        "qkv_kernel": p["qkv_kernel"], "qkv_bias": p["qkv_bias"],
        "proj_kernel": p["proj_kernel"], "proj_bias": p["proj_bias"],
        "rel_pos_bias_table": p["bias_table"],
        "norm1": {"scale": p["ln1_scale"], "bias": p["ln1_bias"]},
        "norm2": {"scale": p["ln2_scale"], "bias": p["ln2_bias"]},
        "mlp_fc1": {"kernel": p["fc1_kernel"], "bias": p["fc1_bias"]},
        "mlp_fc2": {"kernel": p["fc2_kernel"], "bias": p["fc2_bias"]},
    }


def _port(x, p, shift, heads, keep, dtype=torch.float32):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return fused_swin_block(
        t(x).to(dtype), t(p["ln1_scale"]), t(p["ln1_bias"]),
        t(p["qkv_kernel"].T), t(p["qkv_bias"]),
        t(p["proj_kernel"].T), t(p["proj_bias"]),
        t(p["ln2_scale"]), t(p["ln2_bias"]),
        t(p["fc1_kernel"].T), t(p["fc1_bias"]),
        t(p["fc2_kernel"].T), t(p["fc2_bias"]),
        t(p["bias_table"]), t(keep), WINDOW, shift, heads, 1e-5,
    )


def _jax_module(x, p, shift, heads, dtype=jnp.float32):
    mod = JaxBlock(dim=x.shape[-1], num_heads=heads, window=WINDOW, shift=shift,
                   dtype=dtype, attention_impl="xla")
    return np.asarray(mod.apply({"params": _jax_tree(p)},
                                jnp.asarray(x).astype(dtype)).astype(jnp.float32))


@pytest.mark.parametrize("shape,shift", [
    ((2, 8, 8, 8, 32), (0, 0, 0)),   # unshifted
    ((2, 8, 8, 8, 32), (2, 2, 2)),   # shifted
    ((2, 6, 6, 6, 32), (2, 2, 2)),   # padded to 8^3, shifted (stage-2 topology)
    ((2, 6, 6, 6, 32), (0, 0, 0)),   # padded, unshifted
    ((1, 12, 4, 4, 16), (2, 2, 2)),  # odd window count (3), shift on one axis
])
def test_matches_jax_block_f32(shape, shift):
    rs = np.random.RandomState(sum(shape) + sum(shift))
    heads = 4 if shape[-1] == 32 else 2
    x = rs.randn(*shape).astype(np.float32)
    p = _params(rs, shape[-1], heads)
    before = fused_swin_block.launches
    got = _port(x, p, shift, heads, np.ones((shape[0], 2), np.float32))
    assert fused_swin_block.launches == before  # CPU: the plain version
    want = _jax_module(x, p, shift, heads)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def _jax_block_with_keeps(x, p, shift, heads, ka, km):
    """SwinBlock3D's XLA composition with given droppath factors (as
    drop_path applies them: the branch times keep/(1-rate))."""
    h = layer_norm(x, p["ln1_scale"], p["ln1_bias"], 1e-5)
    h = window_attention_3d(h, p["qkv_kernel"], p["qkv_bias"], p["proj_kernel"],
                            p["proj_bias"], p["bias_table"], WINDOW, shift, heads)
    x = x + h * ka.reshape(-1, 1, 1, 1, 1)
    h = layer_norm(x, p["ln2_scale"], p["ln2_bias"], 1e-5)
    h = _dense(h, p["fc1_kernel"], p["fc1_bias"], jnp.float32)
    h = _dense(jax.nn.gelu(h), p["fc2_kernel"], p["fc2_bias"], jnp.float32)
    return x + h * km.reshape(-1, 1, 1, 1, 1)


@pytest.mark.parametrize("shift", [(0, 0, 0), (2, 2, 2)])
def test_droppath_keep_factors(shift):
    rs = np.random.RandomState(7)
    x = rs.randn(3, 4, 4, 8, 16).astype(np.float32)
    p = _params(rs, 16, 2)
    keep = np.array([[0.0, 1.25], [1.25, 0.0], [1.25, 1.25]], np.float32)
    got = _port(x, p, shift, 2, keep)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want = _jax_block_with_keeps(jnp.asarray(x), jp, shift, 2,
                                 jnp.asarray(keep[:, 0]), jnp.asarray(keep[:, 1]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_bf16_close_to_jax_block():
    """bf16: both sides round to bf16 at different points (the kernel scales
    q before rounding and runs GELU in f32; the XLA path does neither), so
    outputs of magnitude up to ~4 may differ by a few bf16 ulps (2^-6 at
    2..4, 2^-5 at 4..8): atol 0.0625, and a relative L2 error under 5e-3."""
    rs = np.random.RandomState(11)
    x = rs.randn(2, 6, 6, 6, 32).astype(np.float32)
    p = _params(rs, 32, 4)
    got = _port(x, p, (2, 2, 2), 4, np.ones((2, 2), np.float32),
                dtype=torch.bfloat16).float().numpy()
    want = _jax_module(x, p, (2, 2, 2), 4, dtype=jnp.bfloat16)
    np.testing.assert_allclose(got, want, rtol=0, atol=0.0625)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 5e-3


@pytest.mark.parametrize("shape,heads", [
    ((1, 8, 8, 8, 128), 4), ((1, 40, 40, 40, 256), 8), ((1, 5, 5, 5, 1024), 32),
    ((1, 10, 10, 10, 512), 16), ((1, 10, 10, 10, 128), 4), ((1, 4, 4, 4, 12), 3),
])
def test_supported_predicate_matches_jax(shape, heads):
    assert (kernel_supported(shape[-1], WINDOW)
            == jpb.fused_block_supported(shape, WINDOW, heads, 4.0))


def test_rejects_other_devices():
    x = torch.empty((1, 4, 4, 4, 16), device="meta")
    with pytest.raises(ValueError):
        fused_swin_block(x, *([None] * 13), None, WINDOW, (0, 0, 0), 2, 1e-5)


@pytest.mark.slow
def test_matches_jax_pallas_kernel_interpret():
    """Against the JAX fused_swin_block itself (Pallas interpret mode on
    CPU), padded and shifted, with keep factors: the same kernel semantics,
    so the f32 tolerance is that of the XLA comparison."""
    rs = np.random.RandomState(13)
    x = rs.randn(2, 6, 6, 6, 32).astype(np.float32)
    p = _params(rs, 32, 4)
    keep = np.array([[1.25, 1.0], [1.0, 1.25]], np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want = jpb.fused_swin_block(
        jnp.asarray(x), jp["ln1_scale"], jp["ln1_bias"], jp["qkv_kernel"],
        jp["qkv_bias"], jp["proj_kernel"], jp["proj_bias"], jp["ln2_scale"],
        jp["ln2_bias"], jp["fc1_kernel"], jp["fc1_bias"], jp["fc2_kernel"],
        jp["fc2_bias"], jp["bias_table"], jnp.asarray(keep[:, 0]),
        jnp.asarray(keep[:, 1]), WINDOW, (2, 2, 2), 4, 1e-5)
    got = _port(x, p, (2, 2, 2), 4, keep)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_kernel_weight_casts_cached_until_parameters_change():
    """Without autograd SwinBlock3D casts its four weight matrices for the
    kernels once, and again only after a parameter changes in place; the
    block's output follows the change."""
    from nerf_mae_torch.models.swin import SwinBlock3D as PortBlock

    torch.manual_seed(0)
    block = PortBlock(16, 2, WINDOW, (2, 2, 2), dtype=torch.bfloat16,
                      attention_impl="kernel", device="cpu")
    for prm in block.parameters():
        torch.nn.init.normal_(prm, std=0.05)
    x = torch.randn(1, 8, 8, 8, 16)
    with torch.no_grad():
        first = block._kernel_weights()
        assert all(w.dtype == torch.bfloat16 for w in first)
        assert all(a is b for a, b in zip(first, block._kernel_weights()))
        out0 = block(x)
        block.mlp["3"].weight.mul_(2.0)
        second = block._kernel_weights()
        assert second[3] is not first[3]
        torch.testing.assert_close(second[3], block.mlp["3"].weight.to(torch.bfloat16),
                                   rtol=0, atol=0)
        assert not torch.equal(block(x), out0)
    with torch.enable_grad():
        assert block._kernel_weights()[0].requires_grad
    with torch.inference_mode():
        made_here = PortBlock(16, 2, WINDOW, (0, 0, 0), dtype=torch.bfloat16,
                              attention_impl="kernel", device="cpu")
        assert made_here._kernel_weights()[0].dtype == torch.bfloat16
