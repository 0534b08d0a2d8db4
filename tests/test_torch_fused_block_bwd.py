"""The port's fused Swin-block backward against the JAX package, on the CPU.

On CPU tensors FusedSwinBlockFn runs the kernels' plain versions, so these
tests hold the backward kernel's semantics: its gradients against jax.grad
of the JAX XLA block composition (as tests/test_pallas_block.py builds it)
in float32 at rtol/atol 2e-4, the JAX package's own tolerance for its
fused backward; the hand-derived plain backward against torch.autograd
through the plain forward in float32 (summation order only: 1e-5 of each
gradient's largest value); a bf16 case; the gradients' dtypes. The kernel
itself runs only on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_mae_tpu.models.swin import _dense, layer_norm
from nerf_mae_tpu.ops import pallas_block as jpb
from nerf_mae_tpu.ops.window_attention import window_attention_3d
from nerf_mae_torch.models.swin import SwinBlock3D
from nerf_mae_torch.ops.fused_block import (
    FusedSwinBlockFn,
    fused_swin_block_bwd,
    fused_swin_block_bwd_plain,
    fused_swin_block_plain,
)

torch.set_num_threads(1)
WINDOW = (4, 4, 4)
KEYS = ("ln1_scale", "ln1_bias", "qkv_kernel", "qkv_bias", "proj_kernel",
        "proj_bias", "ln2_scale", "ln2_bias", "fc1_kernel", "fc1_bias",
        "fc2_kernel", "fc2_bias", "bias_table")
KERNELS = {"qkv_kernel", "proj_kernel", "fc1_kernel", "fc2_kernel"}


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


def _xla_block(x, p, shift, heads, ka, km):
    """SwinBlock3D's XLA composition with given droppath factors."""
    d = x.dtype
    h = layer_norm(x, p["ln1_scale"], p["ln1_bias"], 1e-5)
    h = window_attention_3d(h.astype(d), p["qkv_kernel"], p["qkv_bias"],
                            p["proj_kernel"], p["proj_bias"], p["bias_table"],
                            WINDOW, shift, heads)
    x = x + h.astype(d) * ka.reshape(-1, 1, 1, 1, 1).astype(d)
    h = layer_norm(x, p["ln2_scale"], p["ln2_bias"], 1e-5)
    h = _dense(h, p["fc1_kernel"], p["fc1_bias"], d)
    h = _dense(jax.nn.gelu(h), p["fc2_kernel"], p["fc2_bias"], d)
    return x + h.astype(d) * km.reshape(-1, 1, 1, 1, 1).astype(d)


def _jax_grads(block, x, p, w, dtype=jnp.float32):
    """jax.grad of sum(block(x, p) * w): (dx, {name: dparam})."""
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    loss = lambda x, p: jnp.sum(block(x, p).astype(jnp.float32) * w)
    gx, gp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x).astype(dtype), jp)
    return np.asarray(gx.astype(jnp.float32)), {k: np.asarray(v) for k, v in gp.items()}


def _port_grads(x, p, shift, heads, keep, w, dtype=torch.float32):
    """FusedSwinBlockFn's gradients of sum(out * w), the parameters float32
    leaves in torch layout; returned in the JAX layout."""
    xt = torch.tensor(x).to(dtype).requires_grad_()
    leaves = [torch.tensor(p[k].T.copy() if k in KERNELS else p[k]).requires_grad_()
              for k in KEYS]
    out = FusedSwinBlockFn.apply(xt, *leaves, torch.tensor(keep), WINDOW, shift,
                                 heads, 1e-5)
    (out.float() * torch.tensor(w)).sum().backward()
    grads = {k: (t.grad.T if k in KERNELS else t.grad) for k, t in zip(KEYS, leaves)}
    return xt.grad, grads


CASES = [  # shape, shift, keep
    ((2, 8, 8, 8, 32), (0, 0, 0), [[1.25, 1.0], [1.0, 1.25]]),   # unshifted
    ((2, 8, 8, 8, 32), (2, 2, 2), [[1.25, 1.0], [1.0, 1.25]]),   # shifted
    ((2, 6, 6, 6, 32), (2, 2, 2), [[1.25, 1.0], [1.0, 1.25]]),   # padded to 8^3 (stage 2)
    ((1, 12, 4, 4, 16), (2, 2, 2), [[1.25, 0.8]]),               # odd window count
    ((3, 4, 4, 8, 16), (2, 2, 2), [[0.0, 1.25], [1.25, 0.0], [1.25, 1.25]]),  # keep 0
]


@pytest.mark.parametrize("shape,shift,keep", CASES)
def test_grads_match_jax_f32(shape, shift, keep):
    rs = np.random.RandomState(sum(shape) + sum(shift) + len(keep))
    heads = 4 if shape[-1] == 32 else 2
    x = rs.randn(*shape).astype(np.float32)
    p = _params(rs, shape[-1], heads)
    w = rs.randn(*shape).astype(np.float32)
    keep = np.asarray(keep, np.float32)
    ka, km = jnp.asarray(keep[:, 0]), jnp.asarray(keep[:, 1])
    want_x, want_p = _jax_grads(lambda x, p: _xla_block(x, p, shift, heads, ka, km), x, p, w)
    before = fused_swin_block_bwd.launches
    got_x, got_p = _port_grads(x, p, shift, heads, keep, w)
    assert fused_swin_block_bwd.launches == before  # CPU: the plain backward
    np.testing.assert_allclose(got_x.numpy(), want_x, rtol=2e-4, atol=2e-4)
    for k in KEYS:
        np.testing.assert_allclose(got_p[k].numpy(), want_p[k], rtol=2e-4, atol=2e-4,
                                   err_msg=k)


@pytest.mark.parametrize("shape,shift,keep", CASES[1:4])
def test_plain_backward_matches_autograd(shape, shift, keep):
    """The hand-derived plain backward against torch.autograd through the
    plain forward, float32."""
    torch.manual_seed(sum(shape))
    c = shape[-1]
    heads = 4 if c == 32 else 2
    r = lambda *s: torch.randn(*s)
    params = [1 + 0.1 * r(c), 0.1 * r(c), r(3 * c, c) / c ** 0.5, 0.1 * r(3 * c),
              r(c, c) / c ** 0.5, 0.1 * r(c), 1 + 0.1 * r(c), 0.1 * r(c),
              r(4 * c, c) / c ** 0.5, 0.1 * r(4 * c), r(c, 4 * c) / (2 * c ** 0.5),
              0.1 * r(c), r(343, heads)]
    params = [t.requires_grad_() for t in params]
    x = r(*shape).requires_grad_()
    keep = torch.tensor(keep)
    dy = r(*shape)
    out = fused_swin_block_plain(x, *params, keep, WINDOW, shift, heads, 1e-5)
    want = torch.autograd.grad(out, [x, *params], dy)
    got = fused_swin_block_bwd_plain(x.detach(), *[t.detach() for t in params], keep,
                                     dy, WINDOW, shift, heads, 1e-5)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5 * w.abs().max().item(),
                                   msg=f"output {i}")


def test_bf16_close_to_jax():
    """bf16: the port keeps the fused kernel's rounding points, the JAX XLA
    composition rounds elsewhere (q before its scale, GELU in bf16), so the
    gradients agree to a relative L2 of 3e-2 each."""
    rs = np.random.RandomState(21)
    shape, shift, heads = (2, 6, 6, 6, 32), (2, 2, 2), 4
    x = rs.randn(*shape).astype(np.float32)
    p = _params(rs, 32, heads)
    w = rs.randn(*shape).astype(np.float32)
    keep = np.array([[1.25, 1.0], [1.0, 1.25]], np.float32)
    ka, km = jnp.asarray(keep[:, 0]), jnp.asarray(keep[:, 1])
    want_x, want_p = _jax_grads(lambda x, p: _xla_block(x, p, shift, heads, ka, km),
                                x, p, w, dtype=jnp.bfloat16)
    got_x, got_p = _port_grads(x, p, shift, heads, keep, w, dtype=torch.bfloat16)
    assert got_x.dtype == torch.bfloat16
    rel = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)
    assert rel(got_x.float().numpy(), want_x) < 3e-2
    for k in KEYS:
        assert rel(got_p[k].numpy(), want_p[k]) < 3e-2, k


def test_weight_grads_float32_never_rounded():
    """bf16 compute, float32 parameters: every parameter gradient comes back
    float32 and is not rounded to bf16 (pallas_block.py:842-851); dx is
    bf16; keep gets no gradient."""
    rs = np.random.RandomState(3)
    shape = (2, 8, 8, 8, 16)
    x = torch.tensor(rs.randn(*shape).astype(np.float32)).bfloat16().requires_grad_()
    p = _params(rs, 16, 2)
    leaves = [torch.tensor(p[k].T.copy() if k in KERNELS else p[k]).requires_grad_()
              for k in KEYS]
    keep = torch.ones((2, 2), requires_grad=True)
    out = FusedSwinBlockFn.apply(x, *leaves, keep, WINDOW, (2, 2, 2), 2, 1e-5)
    (out.float() ** 2).sum().backward()
    assert x.grad.dtype == torch.bfloat16
    assert keep.grad is None
    for k, t in zip(KEYS, leaves):
        assert t.grad.dtype == torch.float32, k
        assert (t.grad.bfloat16().float() != t.grad).any(), k


def test_kernel_path_trains_through_the_function():
    """Under autograd a kernel block goes through FusedSwinBlockFn (whose
    backward is the backward kernel on the card), not through the forward
    kernel's bare output, which has no gradient."""
    torch.manual_seed(0)
    block = SwinBlock3D(16, 2, WINDOW, (2, 2, 2), dtype=torch.float32,
                        attention_impl="kernel", device="cpu")
    for prm in block.parameters():
        torch.nn.init.normal_(prm, std=0.05)
    out = block(torch.randn(1, 8, 8, 8, 16))
    assert type(out.grad_fn).__name__ == "FusedSwinBlockFnBackward"
    out.square().sum().backward()
    assert all(prm.grad is not None and prm.grad.abs().max() > 0
               for prm in block.parameters())


def test_rejects_other_devices():
    x = torch.empty((1, 4, 4, 4, 16), device="meta")
    with pytest.raises(ValueError):
        fused_swin_block_bwd(x, *([None] * 13), None, x, WINDOW, (0, 0, 0), 2, 1e-5)


@pytest.mark.slow
def test_matches_jax_pallas_backward_interpret():
    """Against jax.grad through the JAX fused_swin_block itself (its Pallas
    backward kernel in interpret mode on CPU), padded and shifted, with a
    dropped branch."""
    rs = np.random.RandomState(13)
    shape, shift, heads = (2, 6, 6, 6, 32), (2, 2, 2), 4
    x = rs.randn(*shape).astype(np.float32)
    p = _params(rs, 32, heads)
    w = rs.randn(*shape).astype(np.float32)
    keep = np.array([[1.25, 0.0], [1.0, 1.25]], np.float32)
    ka, km = jnp.asarray(keep[:, 0]), jnp.asarray(keep[:, 1])

    def fused(x, p):
        return jpb.fused_swin_block(x, *(p[k] for k in KEYS), ka, km, WINDOW, shift,
                                    heads, 1e-5)

    want_x, want_p = _jax_grads(fused, x, p, w)
    got_x, got_p = _port_grads(x, p, shift, heads, keep, w)
    np.testing.assert_allclose(got_x.numpy(), want_x, rtol=2e-4, atol=2e-4)
    for k in KEYS:
        np.testing.assert_allclose(got_p[k].numpy(), want_p[k], rtol=2e-4, atol=2e-4,
                                   err_msg=k)
