"""The port's 2-rank MAE step against JAX on a data mesh, on the CPU.

The port's step on two gloo ranks against JAX's loss and gradients of the
joined batch sharded on make_mesh(2) (8 virtual devices here), the weights
through convert.params_from_jax, both sides given the token mask, at the
golden tolerances: loss rtol 1e-3; gradients (reduced over the ranks,
before the clip) rtol 2e-3 / atol 2e-4 of the largest gradient, as
tests/test_torch_train.py holds the moments, since a gradient that is zero
in exact arithmetic (a convolution bias before a norm) is float32 noise on
both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import NamedSharding, PartitionSpec

from nerf_mae_tpu.models import mae as jmae
from nerf_mae_tpu.parallel import make_mesh as jmake_mesh
from nerf_mae_tpu.parallel import shard_batch as jshard_batch
from nerf_mae_torch.config import TrainConfig
from nerf_mae_torch.convert import params_from_jax
from nerf_mae_torch.parallel import dryrun, make_mesh, shard_batch
from nerf_mae_torch.train.trainer import MAETrainer

from test_torch_train import _cfgs, _jax_params

torch.set_num_threads(1)

MODULE = "test_torch_parallel_jax"  # the ranks import this module by name


def jax_case_rank(state_dict, grids, sizes, token_mask):
    """A launch target: one MAE step of the port on 2 ranks from
    `state_dict`, given the global batch and token mask; the loss and the
    reduced gradients before the clip."""
    _, cfg = _cfgs()
    with make_mesh(2, device="cpu") as mesh:
        trainer = MAETrainer(cfg, TrainConfig(lr=1e-3), 10, "cpu", mesh)
        state = trainer.init(0)
        state.model.load_state_dict(state_dict)
        grads = {}
        clip = trainer.clip

        def recorded(gs, max_norm):
            grads.update({n: g.clone().numpy() for (n, _), g in
                          zip(state.model.named_parameters(), gs)})
            return clip(gs, max_norm)

        trainer.clip = recorded
        batch = shard_batch({"grids": grids, "sizes": sizes, "mask": token_mask}, mesh)
        mask = batch.pop("mask")
        _, m = trainer.train_step(state, batch, token_mask=mask)
        return {"loss": float(m["loss"]), "grads": grads}


def test_two_rank_mae_step_matches_jax_on_a_data_mesh():
    jcfg, cfg = _cfgs()
    params = _jax_params(jcfg)
    rs = np.random.RandomState(11)
    grids = rs.rand(4, 32, 32, 32, 4).astype(np.float32)
    grids[..., 3] *= rs.rand(4, 32, 32, 32) > np.array([0.2, 0.2, 0.8, 0.8])[:, None, None, None]
    sizes = np.array([[32, 29, 31], [27, 32, 32], [32, 32, 20], [25, 30, 32]], np.int32)
    token_mask = rs.rand(4, 8, 8, 8) < 0.6

    mesh = jmake_mesh(2)
    batch = jshard_batch({"grids": grids, "sizes": sizes}, mesh)
    jmask = jax.device_put(jnp.asarray(token_mask), NamedSharding(mesh, PartitionSpec("data")))
    model = jmae.SwinMAE3D(jcfg)

    def loss_fn(p, g, s, m):
        pred, _ = model.apply({"params": p}, g, False, token_mask=m)
        return jmae.mae_loss(pred, g, m, s, jcfg)[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params, batch["grids"],
                                                         batch["sizes"], jmask)
    out = dryrun.launch(f"{MODULE}:jax_case_rank", 2, {
        "state_dict": params_from_jax(params, cfg), "grids": grids, "sizes": sizes,
        "token_mask": token_mask})
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), cfg)
    atol = 2e-4 * max(float(g.abs().max()) for g in want.values())
    for o in out:
        np.testing.assert_allclose(o["loss"], float(jloss), rtol=1e-3)
        for name, g in want.items():
            np.testing.assert_allclose(o["grads"][name], g.numpy(), rtol=2e-3, atol=atol,
                                       err_msg=name)
