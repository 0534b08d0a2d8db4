"""The port's fused window-attention backward against the JAX package, on
the CPU.

On CPU tensors FusedWindowAttentionFn runs the kernels' plain versions, so
these tests hold the backward kernel's semantics: its gradients against
jax.grad of the JAX XLA window attention in float32 at rtol/atol 2e-4 (the
tolerance of the fused-block backward's own tests); the hand-derived plain
backward against torch.autograd through the plain forward in float32; a
bf16 case; the gradients' dtypes (the weights arrive as bf16 casts, as the
JAX block passes them, so their gradients are bf16-rounded). The kernel
itself runs only on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_mae_tpu.ops import pallas_attention as jpa
from nerf_mae_tpu.ops.window_attention import window_attention_3d
from nerf_mae_torch.ops.fused_attention import (
    FusedWindowAttentionFn,
    fused_window_attention_bwd,
    fused_window_attention_bwd_plain,
    fused_window_attention_plain,
)

torch.set_num_threads(1)
WINDOW = (4, 4, 4)
KEYS = ("qkv_kernel", "qkv_bias", "proj_kernel", "proj_bias", "bias_table")
KERNELS = {"qkv_kernel", "proj_kernel"}


def _params(rs, c, heads):
    n = lambda *shape: (rs.randn(*shape) * 0.1).astype(np.float32)
    return dict(qkv_kernel=n(c, 3 * c), qkv_bias=n(3 * c), proj_kernel=n(c, c),
                proj_bias=n(c), bias_table=n(343, heads))


def _jax_grads(attn, x, p, w, dtype=jnp.float32):
    jp = [jnp.asarray(p[k]) for k in KEYS]
    loss = lambda x, *p: jnp.sum(attn(x, *p).astype(jnp.float32) * w)
    g = jax.grad(loss, argnums=tuple(range(6)))(jnp.asarray(x).astype(dtype), *jp)
    return (np.asarray(g[0].astype(jnp.float32)),
            {k: np.asarray(v) for k, v in zip(KEYS, g[1:])})


def _port_grads(x, p, shift, heads, w, dtype=torch.float32):
    """FusedWindowAttentionFn's gradients of sum(out * w); the weight
    matrices enter as `dtype` casts of float32 leaves (as SwinBlock3D passes
    them). Returned in the JAX layout."""
    xt = torch.tensor(x).to(dtype).requires_grad_()
    leaves = {k: torch.tensor(p[k].T.copy() if k in KERNELS else p[k]).requires_grad_()
              for k in KEYS}
    args = [leaves[k].to(dtype) if k in KERNELS else leaves[k] for k in KEYS]
    out = FusedWindowAttentionFn.apply(xt, *args, WINDOW, shift, heads)
    (out.float() * torch.tensor(w)).sum().backward()
    return xt.grad, {k: (t.grad.T if k in KERNELS else t.grad) for k, t in leaves.items()}


CASES = [
    ((2, 8, 8, 8, 16), (0, 0, 0)),   # unshifted
    ((2, 8, 8, 8, 16), (2, 2, 2)),   # shifted
    ((2, 6, 6, 6, 16), (2, 2, 2)),   # padded to 8^3 (stage 2)
    ((1, 12, 4, 4, 8), (2, 2, 2)),   # odd window count
]


@pytest.mark.parametrize("shape,shift", CASES)
def test_grads_match_jax_f32(shape, shift):
    rs = np.random.RandomState(sum(shape) + sum(shift))
    heads = 2
    x = rs.randn(*shape).astype(np.float32)
    p = _params(rs, shape[-1], heads)
    w = rs.randn(*shape).astype(np.float32)
    want_x, want_p = _jax_grads(
        lambda x, *p: window_attention_3d(x, *p, WINDOW, shift, heads), x, p, w)
    before = fused_window_attention_bwd.launches
    got_x, got_p = _port_grads(x, p, shift, heads, w)
    assert fused_window_attention_bwd.launches == before  # CPU: the plain backward
    np.testing.assert_allclose(got_x.numpy(), want_x, rtol=2e-4, atol=2e-4)
    for k in KEYS:
        np.testing.assert_allclose(got_p[k].numpy(), want_p[k], rtol=2e-4, atol=2e-4,
                                   err_msg=k)


@pytest.mark.parametrize("shape,shift", CASES[1:])
def test_plain_backward_matches_autograd(shape, shift):
    """The hand-derived plain backward against torch.autograd through the
    plain forward, float32."""
    torch.manual_seed(sum(shape))
    c = shape[-1]
    r = lambda *s: torch.randn(*s)
    params = [r(3 * c, c) / c ** 0.5, 0.1 * r(3 * c), r(c, c) / c ** 0.5,
              0.1 * r(c), r(343, 2)]
    params = [t.requires_grad_() for t in params]
    x = r(*shape).requires_grad_()
    dy = r(*shape)
    out = fused_window_attention_plain(x, *params, WINDOW, shift, 2)
    want = torch.autograd.grad(out, [x, *params], dy)
    q, qb, pw, _, table = (t.detach() for t in params)
    got = fused_window_attention_bwd_plain(x.detach(), q, qb, pw, table, dy, WINDOW,
                                           shift, 2)
    for i, (g, w) in enumerate(zip(got, want)):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5 * w.abs().max().item(),
                                   msg=f"output {i}")


def test_bf16_close_to_jax():
    """bf16: the port keeps the fused kernel's rounding points (q scaled
    before its rounding), the JAX XLA path rounds q first, so the gradients
    agree to a relative L2 of 3e-2 each."""
    rs = np.random.RandomState(5)
    shape, shift, heads = (2, 6, 6, 6, 16), (2, 2, 2), 2
    x = rs.randn(*shape).astype(np.float32)
    p = _params(rs, 16, heads)
    w = rs.randn(*shape).astype(np.float32)

    def xla(x, qk, qb, pk, pb, t):
        bf = jnp.bfloat16
        return window_attention_3d(x, qk.astype(bf), qb, pk.astype(bf), pb, t,
                                   WINDOW, shift, heads)

    want_x, want_p = _jax_grads(xla, x, p, w, dtype=jnp.bfloat16)
    got_x, got_p = _port_grads(x, p, shift, heads, w, dtype=torch.bfloat16)
    rel = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)
    assert rel(got_x.float().numpy(), want_x) < 3e-2
    for k in KEYS:
        assert rel(got_p[k].numpy(), want_p[k]) < 3e-2, k


def test_weight_grads_bf16_rounded():
    """bf16 weight casts in, as the JAX block passes them
    (nerf_mae_tpu/models/swin.py:199-204): their gradients are bf16 values
    widened to the float32 leaves; the biases' and the table's are float32
    and not rounded."""
    rs = np.random.RandomState(4)
    x = rs.randn(2, 8, 8, 8, 16).astype(np.float32)
    p = _params(rs, 16, 2)
    w = rs.randn(*x.shape).astype(np.float32)
    _, grads = _port_grads(x, p, (2, 2, 2), 2, w, dtype=torch.bfloat16)
    for k in KEYS:
        g = grads[k]
        assert g.dtype == torch.float32, k
        rounded = torch.equal(g.bfloat16().float(), g)
        assert rounded == (k in KERNELS), k


def test_rejects_other_devices():
    x = torch.empty((1, 4, 4, 4, 16), device="meta")
    with pytest.raises(ValueError):
        fused_window_attention_bwd(x, None, None, None, None, x, WINDOW, (0, 0, 0), 2)


@pytest.mark.slow
def test_matches_jax_pallas_backward_interpret():
    """Against jax.grad through the JAX fused_window_attention itself (its
    Pallas backward kernel in interpret mode on CPU), padded and shifted."""
    rs = np.random.RandomState(9)
    shape, shift, heads = (2, 6, 6, 6, 16), (2, 2, 2), 2
    x = rs.randn(*shape).astype(np.float32)
    p = _params(rs, 16, heads)
    w = rs.randn(*shape).astype(np.float32)
    want_x, want_p = _jax_grads(
        lambda x, *p: jpa.fused_window_attention(x, *p, WINDOW, shift, heads), x, p, w)
    got_x, got_p = _port_grads(x, p, shift, heads, w)
    np.testing.assert_allclose(got_x.numpy(), want_x, rtol=2e-4, atol=2e-4)
    for k in KEYS:
        np.testing.assert_allclose(got_p[k].numpy(), want_p[k], rtol=2e-4, atol=2e-4,
                                   err_msg=k)
