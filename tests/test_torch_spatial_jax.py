"""The port's grid sharding against JAX's on the CPU: the MAE step on 2
gloo ranks of a (1 data x 2 space) mesh against JAX's loss and gradients
of the same batch sharded on make_mesh_2d(1, 2) (grid_pspec: the grids and
the token mask over `space`), the weights through convert.params_from_jax,
both sides given the token mask, at the golden tolerances: loss rtol 1e-3;
gradients (reduced over the ranks, before the clip) rtol 2e-3 / atol 2e-4
of the largest gradient (tests/test_torch_parallel_jax.py's). JAX's side
goes through prepare_spatial_config (its attention on XLA, the Shardy
partitioner off), whose flag is restored afterwards; the port's through
its own (the plain attention). The ranks' code lives in the JAX-free
tests/test_torch_spatial.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import NamedSharding

from nerf_mae_tpu.models import mae as jmae
from nerf_mae_tpu.parallel import grid_pspec, make_mesh_2d
from nerf_mae_tpu.parallel.mesh import prepare_spatial_config
from nerf_mae_tpu.parallel import shard_batch as jshard_batch
from nerf_mae_torch.convert import params_from_jax
from nerf_mae_torch.parallel import dryrun

from test_torch_train import _cfgs, _jax_params

torch.set_num_threads(1)


def test_two_rank_spatial_mae_step_matches_jax_on_a_space_mesh():
    jcfg, cfg = _cfgs()
    params = _jax_params(jcfg)
    rs = np.random.RandomState(13)
    grids = rs.rand(2, 32, 32, 32, 4).astype(np.float32)
    grids[..., 3] *= rs.rand(2, 32, 32, 32) > np.array([0.3, 0.7])[:, None, None, None]
    sizes = np.array([[32, 29, 31], [27, 32, 24]], np.int32)
    token_mask = rs.rand(2, 8, 8, 8) < 0.6

    old = jax.config.jax_use_shardy_partitioner
    try:
        mesh = make_mesh_2d(1, 2)
        jcfg = dataclasses.replace(jcfg, swin=prepare_spatial_config(mesh, jcfg.swin))
        batch = jshard_batch({"grids": grids, "sizes": sizes}, mesh,
                             specs={"grids": grid_pspec(mesh)})
        jmask = jax.device_put(jnp.asarray(token_mask), NamedSharding(mesh, grid_pspec(mesh)))
        model = jmae.SwinMAE3D(jcfg)

        def loss_fn(p, g, s, m):
            pred, _ = model.apply({"params": p}, g, False, token_mask=m)
            return jmae.mae_loss(pred, g, m, s, jcfg)[0]

        jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params, batch["grids"],
                                                             batch["sizes"], jmask)
        jloss, jgrads = float(jloss), jax.tree.map(np.asarray, jgrads)
    finally:
        jax.config.update("jax_use_shardy_partitioner", old)
    assert jcfg.swin.attention_impl == "xla"

    out = dryrun.launch("test_torch_spatial:jax_case_rank", 2, {
        "state_dict": params_from_jax(params, cfg), "grids": grids, "sizes": sizes,
        "token_mask": token_mask, "cfg": cfg})
    want = params_from_jax(jgrads, cfg)
    atol = 2e-4 * max(float(g.abs().max()) for g in want.values())
    for o in out:
        assert o["attention_impl"] == "plain"
        np.testing.assert_allclose(o["loss"], jloss, rtol=1e-3)
        for name, g in want.items():
            np.testing.assert_allclose(o["grads"][name], g.numpy(), rtol=2e-3, atol=atol,
                                       err_msg=name)
