"""The port's fused window-attention wrapper against the JAX package.

On a CPU tensor the wrapper runs the kernel's plain version; in float32 it
must match JAX window_attention_3d (the XLA path) to rtol/atol 2e-5: the
two differ only in where the q scale falls relative to a float32 rounding.
The kernel itself runs only on the card; chip_smoke.py holds it against
this plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_mae_tpu.ops import pallas_attention as jpa
from nerf_mae_tpu.ops.window_attention import window_attention_3d
from nerf_mae_torch.ops.fused_attention import fused_window_attention
from nerf_mae_torch.ops.window_attention import kernel_supported

torch.set_num_threads(1)
WINDOW = (4, 4, 4)


def _params(rs, c, heads):
    n = lambda *shape: (rs.randn(*shape) * 0.1).astype(np.float32)
    return dict(qkv_kernel=n(c, 3 * c), qkv_bias=n(3 * c), proj_kernel=n(c, c),
                proj_bias=n(c), bias_table=n(343, heads))


def _port(x, p, shift, heads, dtype=torch.float32):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return fused_window_attention(
        t(x).to(dtype), t(p["qkv_kernel"].T), t(p["qkv_bias"]),
        t(p["proj_kernel"].T), t(p["proj_bias"]), t(p["bias_table"]),
        WINDOW, shift, heads)


def _jax(fn, x, p, shift, heads, dtype=jnp.float32):
    j = lambda a: jnp.asarray(a)
    out = fn(j(x).astype(dtype), j(p["qkv_kernel"]).astype(dtype), j(p["qkv_bias"]),
             j(p["proj_kernel"]).astype(dtype), j(p["proj_bias"]),
             j(p["bias_table"]), WINDOW, shift, heads)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("shape,shift", [
    ((2, 8, 8, 8, 32), (0, 0, 0)),   # unshifted
    ((2, 8, 8, 8, 32), (2, 2, 2)),   # shifted
    ((2, 6, 6, 6, 32), (2, 2, 2)),   # padded to 8^3, shifted
    ((2, 6, 6, 6, 32), (0, 0, 0)),   # padded, unshifted
    ((1, 12, 4, 4, 16), (2, 2, 2)),  # odd window count (3), shift on one axis
])
def test_matches_jax_window_attention_f32(shape, shift):
    rs = np.random.RandomState(sum(shape) + sum(shift))
    heads = 4 if shape[-1] == 32 else 2
    x = rs.randn(*shape).astype(np.float32)
    p = _params(rs, shape[-1], heads)
    before = fused_window_attention.launches
    got = _port(x, p, shift, heads)
    assert fused_window_attention.launches == before  # CPU: the plain version
    want = _jax(window_attention_3d, x, p, shift, heads)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_bf16_close_to_jax():
    """bf16: the kernel rounds q after the scale, the XLA path before it,
    so single outputs may differ by a bf16 ulp or two (outputs ~1: 2^-7):
    atol 0.03, and a relative L2 error under 5e-3."""
    rs = np.random.RandomState(5)
    x = rs.randn(2, 6, 6, 6, 32).astype(np.float32)
    p = _params(rs, 32, 4)
    got = _port(x, p, (2, 2, 2), 4, dtype=torch.bfloat16).float().numpy()
    want = _jax(window_attention_3d, x, p, (2, 2, 2), 4, dtype=jnp.bfloat16)
    np.testing.assert_allclose(got, want, rtol=0, atol=0.03)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 5e-3


@pytest.mark.parametrize("shape", [
    (1, 8, 8, 8, 128), (1, 10, 10, 10, 512), (1, 5, 5, 5, 1024), (1, 4, 4, 4, 12),
])
def test_supported_predicate_matches_jax(shape):
    assert (kernel_supported(shape[-1], WINDOW)
            == jpa.pallas_supported(shape, WINDOW, (2, 2, 2)))


def test_rejects_other_devices():
    x = torch.empty((1, 4, 4, 4, 16), device="meta")
    with pytest.raises(ValueError):
        fused_window_attention(x, None, None, None, None, None, WINDOW,
                               (0, 0, 0), 2)


@pytest.mark.slow
def test_matches_jax_pallas_kernel_interpret():
    """Against the JAX fused_window_attention itself (Pallas interpret mode
    on CPU), padded and shifted: the same kernel semantics."""
    rs = np.random.RandomState(9)
    x = rs.randn(2, 6, 6, 6, 32).astype(np.float32)
    p = _params(rs, 32, 4)
    got = _port(x, p, (2, 2, 2), 4)
    want = _jax(jpa.fused_window_attention, x, p, (2, 2, 2), 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
