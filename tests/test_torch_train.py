"""The port's training slice against the JAX package, on the CPU.

Schedule, clip guard and AdamW update against nerf_mae_tpu.train.optim;
one whole train step of the tiny config (stochastic depth 0, float32)
against the JAX composition given the same token_mask, at the golden
tolerances of tests/test_parity_golden.py (loss rtol 1e-3; parameters and
first moments rtol 2e-3 / atol 2e-4, the moments' atol relative to their
largest value); a second step from the JAX optimizer state carried over;
eval metrics; checkpoints, resume and pruning; trunk surgery; FLOPs; the
data helpers bit for bit; the CLI; stochastic depth drawn only in training;
remat.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_mae_tpu import flops as jflops
from nerf_mae_tpu.config import SWIN_PRESETS as JPRESETS
from nerf_mae_tpu.config import MAEConfig as JMAEConfig
from nerf_mae_tpu.config import SwinConfig as JSwinConfig
from nerf_mae_tpu.config import TrainConfig as JTrainConfig
from nerf_mae_tpu.data import datasets as jdata
from nerf_mae_tpu.metrics import masked_mse as jmasked_mse
from nerf_mae_tpu.metrics import masked_psnr as jmasked_psnr
from nerf_mae_tpu.models import mae as jmae
from nerf_mae_tpu.train import optim as joptim
from nerf_mae_torch import data, flops, run_mae_pretrain
from nerf_mae_torch.config import SWIN_PRESETS, MAEConfig, SwinConfig, TrainConfig
from nerf_mae_torch.convert import adamw_state_from_jax, params_from_jax
from nerf_mae_torch.metrics import masked_mse, masked_psnr
from nerf_mae_torch.models.mae import SwinMAE3D, init_weights
from nerf_mae_torch.models.swin import SwinBlock3D
from nerf_mae_torch.ops.patchify import patchify_np
from nerf_mae_torch.train import optim
from nerf_mae_torch.train.checkpoint import (
    checkpoint_steps,
    extract_trunk,
    load_trunk_into,
    restore_checkpoint,
    save_checkpoint,
)
from nerf_mae_torch.train.trainer import MAETrainer

torch.set_num_threads(1)

# the tiny config of the repository's verify notes, stochastic depth off
TINY = dict(embed_dim=12, depths=(1, 1, 2, 1), num_heads=(3, 6, 12, 24))


def _cfgs(**swin):
    kw = {**TINY, "stochastic_depth_prob": 0.0, **swin}
    j = JMAEConfig(swin=JSwinConfig(**kw, attention_impl="xla"), resolution=32,
                   compute_dtype="float32", remat=False)
    t = MAEConfig(swin=SwinConfig(**kw), resolution=32, compute_dtype="float32")
    return j, t


def _batch(n=2, seed=0):
    rs = np.random.RandomState(seed)
    grids = rs.rand(n, 32, 32, 32, 4).astype(np.float32)
    grids[..., 3] *= rs.rand(n, 32, 32, 32) > 0.5
    sizes = np.array([[32, 29, 31], [27, 32, 32]], np.int32)[:n]
    return grids, sizes


def _jax_params(jcfg, seed=0):
    rs = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda: jmae.SwinMAE3D(jcfg).init(
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


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


# ---------------------------------------------------------------- optimizer


@pytest.mark.parametrize("total,lr,pct", [(1, 1e-4, 0.3), (2, 1e-4, 0.3), (3, 1e-4, 0.3),
                                          (4, 1e-4, 0.3), (37, 1e-3, 0.45), (100, 1e-4, 0.3)])
def test_schedule_matches_jax(total, lr, pct):
    jsched = joptim.make_schedule(JTrainConfig(lr=lr, onecycle_pct_start=pct), total)
    sched = optim.make_schedule(TrainConfig(lr=lr, onecycle_pct_start=pct), total)
    got = np.array([sched(s) for s in range(total + 1)])
    want = np.array([float(jsched(s)) for s in range(total + 1)])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=lr * 1e-6)  # float32 JAX
    if total <= 3:  # the constant fallback
        assert (got == lr).all()


def _grad_lists(rs, scale):
    shapes = [(5, 3), (7,), (2, 2, 2)]
    return [(rs.randn(*s) * scale).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("case", ["clipped", "unclipped", "nan", "inf"])
def test_clip_guard_matches_jax(case):
    rs = np.random.RandomState(1)
    grads = _grad_lists(rs, 1.0 if case != "unclipped" else 1e-3)
    if case == "nan":
        grads[1][2] = np.nan
    if case == "inf":
        grads[0][1, 1] = np.inf
    tx = joptim.clip_with_nonfinite_guard(0.1)
    want, _ = tx.update([jnp.asarray(g) for g in grads], tx.init(None))
    tg = [torch.tensor(g) for g in grads]
    norm = optim.clip_with_nonfinite_guard(tg, 0.1)
    jnorm = float(optax.global_norm([jnp.asarray(g) for g in grads]))
    if case in ("nan", "inf"):
        assert not np.isfinite(float(norm)) and not np.isfinite(jnorm)
        assert all((t == 0).all() for t in tg)
    else:
        np.testing.assert_allclose(float(norm), jnorm, rtol=1e-6)
    for t, w in zip(tg, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("scale", [1.0, 1e-3])
def test_clip_without_guard_matches_optax(scale):
    """skip_nonfinite_updates=False: optax.clip_by_global_norm."""
    grads = _grad_lists(np.random.RandomState(5), scale)
    tx = optax.clip_by_global_norm(0.1)
    want, _ = tx.update([jnp.asarray(g) for g in grads], tx.init(None))
    tg = [torch.tensor(g) for g in grads]
    optim.clip_by_global_norm(tg, 0.1)
    for t, w in zip(tg, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-6, atol=1e-8)
    trainer = MAETrainer(_cfgs()[1], TrainConfig(skip_nonfinite_updates=False), 1, "cpu")
    assert trainer.clip is optim.clip_by_global_norm


def test_optimizer_updates_match_jax():
    """Clip + AdamW + OneCycle, three updates, against
    make_optimizer(...).update."""
    rs = np.random.RandomState(2)
    cfg = dict(lr=1e-2, weight_decay=1e-2, clip_grad_norm=0.5)
    tx = joptim.make_optimizer(JTrainConfig(**cfg), 10)
    params = _grad_lists(rs, 1.0)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.tensor(p)) for p in params]
    tcfg = TrainConfig(**cfg)
    opt = optim.make_optimizer(tp, tcfg)
    sched = optim.make_schedule(tcfg, 10)
    for step in range(3):
        grads = _grad_lists(rs, 0.3)
        upd, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, upd)
        for t, g in zip(tp, grads):
            t.grad = torch.tensor(g)
        optim.clip_with_nonfinite_guard([t.grad for t in tp], tcfg.clip_grad_norm)
        for group in opt.param_groups:
            group["lr"] = sched(step)
        opt.step()
        for t, w in zip(tp, jp):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-7, err_msg=f"step {step}")


# ---------------------------------------------------------------- train step


def _jax_step(jcfg, params, opt_state, tx, grids_p, sizes, token_mask):
    model = jmae.SwinMAE3D(jcfg)

    def loss_fn(p):
        pred, _ = model.apply({"params": p}, grids_p, False, token_mask=token_mask,
                              patched_pred=True)
        loss, aux = jmae.mae_loss(pred, grids_p, token_mask, sizes, jcfg)
        return loss, aux

    (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    upd, opt_state = tx.update(grads, opt_state, params)
    return optax.apply_updates(params, upd), opt_state, float(loss), float(
        optax.global_norm(grads))


def _close_tree(model, jtree, cfg, what, moments=None):
    """The model's parameters (or, given `moments`, those per parameter)
    against a JAX tree. The moments' atol is relative to their largest value
    over the whole tree: gradients that are zero in exact arithmetic (a
    convolution bias before a norm) are float32 noise on both sides."""
    want = params_from_jax(jtree, cfg)
    atol = 2e-4
    if moments is not None:
        atol *= max(float(v.abs().max()) for v in want.values())
    for name, prm in model.named_parameters():
        got = prm.detach().numpy() if moments is None else moments[prm]
        np.testing.assert_allclose(got, want[name].numpy(), rtol=2e-3, atol=atol,
                                   err_msg=f"{what} {name}")


def test_train_steps_match_jax():
    """Step 1 from the same parameters and mask: loss, grad_norm, the
    updated parameters and the first moments (0.1 x the clipped
    gradients). Then JAX's optimizer state goes into the port's AdamW
    (adamw_state_from_jax) and step 2 runs on both: the parameters again."""
    jcfg, cfg = _cfgs()
    params = _jax_params(jcfg)
    grids, sizes = _batch()
    grids_p = patchify_np(grids, 4)
    rs = np.random.RandomState(4)
    masks = [rs.rand(2, 8, 8, 8) < 0.6 for _ in range(2)]
    jtcfg = JTrainConfig(lr=1e-3)
    tx = joptim.make_optimizer(jtcfg, 10)
    opt_state = tx.init(params)

    trainer = MAETrainer(cfg, TrainConfig(lr=1e-3), 10, device="cpu")
    state = trainer.init(0)
    state.model.load_state_dict(params_from_jax(params, cfg))
    batch = {"grids": torch.from_numpy(grids_p), "sizes": torch.from_numpy(sizes)}

    p1, opt_state, jloss, jnorm = _jax_step(jcfg, params, opt_state, tx, grids_p, sizes,
                                           jnp.asarray(masks[0]))
    state, m = trainer.train_step(state, batch, token_mask=torch.from_numpy(masks[0]))
    np.testing.assert_allclose(float(m["loss"]), jloss, rtol=1e-3)
    np.testing.assert_allclose(float(m["grad_norm"]), jnorm, rtol=1e-3)
    _close_tree(state.model, p1, cfg, "step 1")
    adam = opt_state[1][0]
    mu = {prm: state.optimizer.state[prm]["exp_avg"].numpy()
          for prm in state.model.parameters()}
    _close_tree(state.model, adam.mu, cfg, "mu", moments=mu)

    # both trainers continue from JAX's state
    state.model.load_state_dict(params_from_jax(p1, cfg))
    adamw_state_from_jax(adam.mu, adam.nu, int(adam.count), state.model, state.optimizer)
    p2, _, jloss, _ = _jax_step(jcfg, p1, opt_state, tx, grids_p, sizes, jnp.asarray(masks[1]))
    state, m = trainer.train_step(state, batch, token_mask=torch.from_numpy(masks[1]))
    np.testing.assert_allclose(float(m["loss"]), jloss, rtol=1e-3)
    _close_tree(state.model, p2, cfg, "step 2")


def test_eval_step_metrics():
    """eval_step's PSNR/MSE are masked_mse/masked_psnr of its prediction
    (both equal to JAX's definitions), with a fixed mask stream."""
    _, cfg = _cfgs()
    trainer = MAETrainer(cfg, TrainConfig(), 10, device="cpu")
    state = trainer.init(0)
    grids, sizes = _batch()
    batch = {"grids": torch.from_numpy(grids), "sizes": torch.from_numpy(sizes)}
    m1, m2 = trainer.eval_step(state, batch), trainer.eval_step(state, batch)
    assert {k: float(v) for k, v in m1.items()} == {k: float(v) for k, v in m2.items()}
    assert float(m1["mse"]) > 0 and np.isfinite(float(m1["psnr"]))
    np.testing.assert_allclose(float(m1["psnr"]), -10 * np.log10(float(m1["mse"])),
                               rtol=1e-6)
    rs = np.random.RandomState(0)
    pred, tgt = rs.rand(2, 6, 5).astype(np.float32), rs.rand(2, 6, 5).astype(np.float32)
    mask = rs.rand(2, 6, 1) > 0.4
    args = [torch.tensor(pred), torch.tensor(tgt), torch.tensor(mask)]
    np.testing.assert_allclose(float(masked_mse(*args)),
                               float(jmasked_mse(pred, tgt, mask)), rtol=1e-6)
    np.testing.assert_allclose(float(masked_psnr(*args)),
                               float(jmasked_psnr(pred, tgt, mask)), rtol=1e-6)


# ---------------------------------------------------------------- checkpoints


def _tiny_trainer(total=10):
    _, cfg = _cfgs()
    return MAETrainer(cfg, TrainConfig(lr=1e-3), total, device="cpu")


def test_checkpoint_round_trip_and_resume(tmp_path):
    grids, sizes = _batch()
    batch = {"grids": torch.from_numpy(grids), "sizes": torch.from_numpy(sizes)}
    trainer = _tiny_trainer()
    state = trainer.init(0)
    for _ in range(2):
        state, _ = trainer.train_step(state, batch)
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, state.step, state.model.state_dict(),
                    state.optimizer.state_dict(), extra={"psnr": 21.5})
    state, m_run = trainer.train_step(state, batch)  # step 3, uninterrupted

    restored = restore_checkpoint(ckpt)
    assert restored["step"] == 2 and restored["extra"] == {"psnr": 21.5}
    fresh = _tiny_trainer()
    resumed = fresh.init(0)
    resumed.model.load_state_dict(restored["params"])
    resumed.optimizer.load_state_dict(restored["opt_state"])
    resumed.step = restored["step"]
    for k, v in restored["opt_state"]["state"].items():
        assert int(v["step"]) == 2, k
    resumed, m_res = fresh.train_step(resumed, batch)  # step 3 again
    assert float(m_res["loss"]) == float(m_run["loss"])
    for (name, a), b in zip(state.model.named_parameters(), resumed.model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def test_fit_steps_and_logs():
    grids, sizes = _batch()
    batch = {"grids": torch.from_numpy(grids), "sizes": torch.from_numpy(sizes)}
    trainer = _tiny_trainer()
    logged = []
    state = trainer.fit(trainer.init(0), iter([batch] * 4), steps=4, log_every=2,
                        callback=lambda step, m: logged.append((step, m)))
    assert state.step == 4
    assert [step for step, _ in logged] == [2, 4]
    assert all(np.isfinite(m["loss"]) and set(m) == {"loss", "loss_rgb", "loss_alpha",
                                                     "grad_norm"} for _, m in logged)


def test_checkpoint_keeps_newest(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    params = {"w": torch.arange(4.0)}
    for step in (1, 2, 5, 7, 9):
        save_checkpoint(ckpt, step, params, keep=3)
    assert checkpoint_steps(ckpt) == [5, 7, 9]
    assert restore_checkpoint(ckpt)["step"] == 9
    assert "opt_state" not in restore_checkpoint(ckpt, step=5)
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"))


def test_trunk_surgery():
    _, cfg = _cfgs()
    a = init_weights(SwinMAE3D(cfg, device="cpu"), 0).state_dict()
    b = init_weights(SwinMAE3D(cfg, device="cpu"), 7).state_dict()
    trunk = extract_trunk(a)
    assert {k.split(".")[0] for k in trunk} == {"patch_partition", "stages"}
    assert not any(k.startswith(("decoder", "mask_token", "subpixel")) for k in trunk)
    grafted = load_trunk_into(b, trunk)
    for k in a:
        want = a[k] if k in trunk else b[k]
        assert torch.equal(grafted[k], want), k
    bad = dict(trunk)
    key = next(iter(bad))
    bad[key] = torch.zeros(1)
    with pytest.raises(ValueError):
        load_trunk_into(b, bad)
    with pytest.raises(KeyError):
        load_trunk_into({k: v for k, v in b.items() if k != key}, trunk)


# ---------------------------------------------------------------- flops, data


@pytest.mark.parametrize("preset", sorted(SWIN_PRESETS))
@pytest.mark.parametrize("decoder", ["subpixel", "unetr"])
def test_flops_match_jax(preset, decoder):
    cfg = MAEConfig(swin=SWIN_PRESETS[preset], resolution=160, decoder_type=decoder)
    jcfg = JMAEConfig(swin=JPRESETS[preset], resolution=160, decoder_type=decoder)
    assert flops.mae_flops_per_grid(cfg) == jflops.mae_flops_per_grid(jcfg)
    assert flops.train_mfu(22.5, cfg) == jflops.train_mfu(22.5, jcfg, peak_flops=989e12)


def test_data_helpers_bitwise_equal_jax():
    got = data.synthetic_scenes(3, 32, seed=5)
    want = jdata.synthetic_scenes(3, 32, seed=5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    big = np.random.RandomState(0).rand(40, 20, 33, 4).astype(np.float32)
    for g, w in zip(data.pad_to_cube(big, 32), jdata.pad_to_cube(big, 32)):
        np.testing.assert_array_equal(g, w)

    class DS:
        def __len__(self):
            return len(got)

        def __getitem__(self, i):
            return {"rgbsigma": got[i]}

    for pm in (0, 4):
        ours = data.mae_batch_iterator(DS(), 2, 32, seed=3, patch_major=pm)
        theirs = jdata.mae_batch_iterator(DS(), 2, 32, seed=3, workers=0, patch_major=pm)
        for _ in range(3):
            a, b = next(ours), next(theirs)
            np.testing.assert_array_equal(a["grids"], b["grids"])
            np.testing.assert_array_equal(a["sizes"], b["sizes"])
        theirs.close()


# ---------------------------------------------------------------- the CLI


_CLI = ["--dataset", "synthetic", "--backbone_type", "swin_nano", "--resolution", "32",
        "--batch_size", "2", "--n_synthetic", "4", "--compute_dtype", "float32",
        "--device", "cpu"]


def test_cli_train_then_eval(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    out = run_mae_pretrain.main(["--mode", "train", *_CLI, "--steps", "3",
                                 "--checkpoint_dir", ckpt, "--log_interval", "1",
                                 "--log_dir", str(tmp_path / "logs")])
    assert out["steps"] == 3 and [h["step"] for h in out["history"]] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert checkpoint_steps(ckpt) == [3]
    lines = (tmp_path / "logs" / "metrics_mae_swin_nano.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [1, 2, 3]
    eval_json = tmp_path / "eval.json"
    agg = run_mae_pretrain.main(["--mode", "eval", *_CLI, "--checkpoint", ckpt,
                                 "--eval_json", str(eval_json)])
    assert set(agg) == {"loss", "loss_rgb", "loss_alpha", "mse", "psnr"}
    assert json.loads(eval_json.read_text()) == agg
    # the checkpoint is what eval read: its parameters give the same numbers
    trainer = MAETrainer(MAEConfig(swin=SWIN_PRESETS["swin_nano"], resolution=32,
                                   compute_dtype="float32"), TrainConfig(), 3, "cpu")
    state = trainer.init(0)  # the eval mask stream follows the seed
    state.model.load_state_dict(restore_checkpoint(ckpt)["params"])
    scenes = data.synthetic_scenes(2, 32, 10_000)
    batch = next(data.mae_batch_iterator([{"rgbsigma": s} for s in scenes], 2, 32,
                                         shuffle=False, loop=False, patch_major=4))
    m = trainer.eval_step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m["psnr"]), agg["psnr"], rtol=1e-6)


def test_cli_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_mae_pretrain.main(["--mode", "train", *_CLI[:-2], "--device", "cuda",
                               "--steps", "1"])


def test_cli_other_datasets_refused():
    """A dataset on disk is refused without its features directory."""
    with pytest.raises(SystemExit, match="features_path"):
        run_mae_pretrain.main(["--mode", "train", "--dataset", "front3d", "--device", "cpu"])


# ---------------------------------------------------------------- model


def test_droppath_drawn_only_in_training():
    """With a stochastic-depth rate > 0 a training forward draws keep
    factors from the droppath generator and an eval forward draws none."""
    _, cfg = _cfgs(stochastic_depth_prob=0.5)
    model = init_weights(SwinMAE3D(cfg, device="cpu"), 0)
    grids, _ = _batch()
    grids = torch.from_numpy(grids)
    mask = torch.from_numpy(np.random.RandomState(0).rand(2, 8, 8, 8) < 0.5)
    gen = torch.Generator()
    gen.manual_seed(3)
    before = gen.get_state()
    with torch.no_grad():
        eval_a, _ = model(grids, token_mask=mask, droppath_generator=gen)
        assert torch.equal(gen.get_state(), before)
        eval_b, _ = model(grids, True, token_mask=mask, droppath_generator=gen)
        assert torch.equal(gen.get_state(), before)
        train, _ = model(grids, False, token_mask=mask, droppath_generator=gen)
    assert not torch.equal(gen.get_state(), before)
    assert torch.equal(eval_a, eval_b) and not torch.equal(train, eval_a)
    with pytest.raises(ValueError, match="droppath generator"):
        model(grids, False, token_mask=mask)


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_same_gradients(policy, monkeypatch):
    """Remat'd stages recompute their blocks in the backward and give the
    same gradients."""
    grids, sizes = _batch()
    mask = torch.from_numpy(np.random.RandomState(1).rand(2, 8, 8, 8) < 0.5)
    calls = []
    block = SwinBlock3D._block
    monkeypatch.setattr(SwinBlock3D, "_block",
                        lambda self, x, keep: calls.append(self.dim) or block(self, x, keep))
    grads = []
    for stages in ((False,) * 4, (True, True, False, False)):
        _, cfg = _cfgs()
        cfg = dataclasses.replace(cfg, remat_stages=stages, remat_policy=policy)
        model = init_weights(SwinMAE3D(cfg, device="cpu"), 0)
        pred, _ = model(torch.from_numpy(grids), False, token_mask=mask, patched_pred=True)
        from nerf_mae_torch.models.mae import mae_loss

        mae_loss(pred, torch.from_numpy(grids), mask, torch.from_numpy(sizes),
                 cfg)[0].backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    # 5 blocks per forward; the two remat'd stages' blocks run again
    assert len(calls) == 5 + 5 + 2
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_train_after_serving_in_one_process():
    """A training step after an inference_mode forward in the same process:
    the per-shape tensors cached by the serving call (bias index, shift
    mask) must not be inference tensors that the backward would save."""
    _, cfg = _cfgs()
    cfg = dataclasses.replace(cfg, resolution=64)  # shapes no other test cached
    model = init_weights(SwinMAE3D(cfg, device="cpu"), 0)
    grids = torch.rand(1, 64, 64, 64, 4)
    gen = torch.Generator()
    gen.manual_seed(0)
    with torch.inference_mode():
        model(grids, generator=gen)
    pred, mask = model(grids, False, generator=gen)
    pred.square().mean().backward()
    assert all(p.grad is not None for p in model.parameters())
