"""The port's data parallelism (nerf_mae_torch.parallel) on the CPU: the
mesh and its refusals, shard_batch, the draws of a rank sliced from the
draws of the global batch, the feed's rows (with augments and workers, and
the device corpus), the reductions over gloo ranks, the dry runs (a
checkpoint written by rank 0 only), the MAE driver on a space axis
(--mesh_space) and detection's refusal of it.

Multi-rank cases start fresh processes through parallel.dryrun.launch (one
a rank, torchrun's environment, gloo, one thread each). This module imports
no JAX: its functions are also the ranks' code for
tests/test_torch_parallel_train.py.
"""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from nerf_mae_torch import run_fcos, run_mae_pretrain
from nerf_mae_torch.common import ListDataset
from nerf_mae_torch.config import SWIN_PRESETS, MAEConfig, TrainConfig
from nerf_mae_torch.data import (
    SceneDataset,
    detection_batch_iterator,
    mae_batch_iterator,
    synthetic_detection_scenes,
)
from nerf_mae_torch.data.device_cache import device_corpus_batches
from nerf_mae_torch.models.fcos import FCOSConfig
from nerf_mae_torch.models.rcnn import RCNNConfig, sample_rois
from nerf_mae_torch.models.rpn import RPNConfig
from nerf_mae_torch.models.swin import droppath_keep
from nerf_mae_torch.ops.anchors import balanced_sample
from nerf_mae_torch.ops.draws import batch_generator
from nerf_mae_torch.ops.masking import block_mask_3d
from nerf_mae_torch.parallel import (
    DataMesh,
    all_reduce_grads,
    all_reduce_sum,
    count_sum,
    gather_objects,
    make_mesh,
    replicate,
    shard_batch,
)
from nerf_mae_torch.parallel import dryrun
from nerf_mae_torch.train.det_trainer import DetectionTrainer
from nerf_mae_torch.train.head_trainer import VoxelSemanticsTrainer, VoxelSRTrainer
from nerf_mae_torch.train.rpn_trainer import RCNNTrainer, RPNTrainer
from nerf_mae_torch.train.trainer import MAETrainer

torch.set_num_threads(1)

MODULE = "test_torch_parallel"  # the ranks import this module by name
LR, TOTAL = 1e-4, 10
# swin_nano with stochastic depth, so that a step draws keep factors
NANO = dataclasses.replace(SWIN_PRESETS["swin_nano"], stochastic_depth_prob=0.2)
RCNN_C = 16  # the RCNN's feature width in these cases
KINDS = ("mae", "sr", "semantics", "fcos", "rpn", "rcnn")
STEPS = {"mae": 2, "sr": 1, "semantics": 1, "fcos": 1, "rpn": 1, "rcnn": 1}


# ---------------------------------------------------------------- the cases

def _mae_cfg():
    return MAEConfig(swin=NANO, resolution=32, compute_dtype="float32", remat=False)


def make_trainer(kind, mesh=None):
    """The trainer of `kind` at the tiny size, on the mesh (or the CPU)."""
    tcfg = TrainConfig(lr=LR)
    if kind == "mae":
        return MAETrainer(_mae_cfg(), tcfg, TOTAL, "cpu", mesh)
    if kind == "sr":
        return VoxelSRTrainer(_mae_cfg(), tcfg, TOTAL, "cpu", out_resolution=48, mesh=mesh)
    if kind == "semantics":
        weights = np.array([0.0, 1.0, 2.0, 0.5, 1.5], np.float32)
        return VoxelSemanticsTrainer(_mae_cfg(), tcfg, TOTAL, "cpu", num_classes=5,
                                     class_weights=weights, mesh=mesh)
    det = dict(backbone="swin_nano", compute_dtype="float32", remat=False, mesh=mesh)
    if kind == "fcos":
        fcos = FCOSConfig(resolution=32, use_obb=False, max_gt=8, pre_nms_top_n=60,
                          post_nms_top_n=40)
        return DetectionTrainer(NANO, fcos, tcfg, TOTAL, "cpu", **det)
    if kind == "rpn":
        # a sample larger than a scene's labelled anchors: the number sampled
        # (the loss's denominator) then depends on the scene
        rpn = RPNConfig(resolution=32, pre_nms_top_n=64, post_nms_top_n=32, max_gt=8,
                        batch_size_per_mesh=8192)
        return RPNTrainer(NANO, rpn, tcfg, TOTAL, "cpu", **det)
    # as many RoIs as proposals: the valid ones (a denominator) depend on the scene
    return RCNNTrainer(RCNNConfig(resolution=32, rois_per_scene=16, output_size=3), tcfg, TOTAL,
                       "cpu", in_channels=RCNN_C, mesh=mesh)


def _detection_batch(n, seed):
    scenes = synthetic_detection_scenes(n, 32, seed=seed, min_size=24)
    batch = next(detection_batch_iterator(ListDataset(scenes), n, 32, max_gt=8,
                                          shuffle=False, loop=False))
    batch["gt_valid"][n // 2:, 1:] = False  # the second half: one box a scene
    return batch


def global_batch(kind, n=4):
    """The global batch of `kind` (numpy), drawn so that its halves (the
    ranks' rows) give the losses different counts."""
    rs = np.random.RandomState(7)
    half = n // 2
    if kind == "mae":
        grids = rs.rand(n, 32, 32, 32, 4).astype(np.float32)
        keep = rs.rand(n, 32, 32, 32) > np.array([0.2] * half + [0.8] * half)[:, None, None, None]
        grids[..., 3] *= keep
        sizes = np.array([[32, 29, 31], [27, 32, 32], [32, 32, 20], [25, 30, 32]], np.int32)
        return {"grids": grids, "sizes": sizes[:n]}
    if kind == "sr":
        out = rs.rand(n, 48, 48, 48, 4).astype(np.float32)
        out[..., 3] *= rs.rand(n, 48, 48, 48) > np.array([0.3] * half + [0.9] * half)[
            :, None, None, None]
        idx = (np.arange(32) * 1.5).astype(int)
        return {"grids": np.ascontiguousarray(out[:, idx][:, :, idx][:, :, :, idx]),
                "out_grids": out}
    if kind == "semantics":
        grids = rs.rand(n, 32, 32, 32, 4).astype(np.float32)
        sem = rs.randint(0, 5, (n, 32, 32, 32)).astype(np.int32)
        sem[half:] *= rs.rand(n - half, 32, 32, 32) > 0.7  # mostly void
        return {"grids": grids, "semantics": sem}
    if kind in ("fcos", "rpn"):
        return _detection_batch(n, seed=3)
    det = _detection_batch(n, seed=5)
    gt = det["gt_boxes"]
    # proposals near the valid boxes, jittered, and random ones
    props = np.concatenate([gt + rs.randn(*gt.shape).astype(np.float32) * 0.5,
                            np.sort(rs.rand(n, 8, 2, 3).astype(np.float32) * 32, 2
                                    ).reshape(n, 8, 6)], 1)
    valid = np.concatenate([det["gt_valid"], np.ones((n, 8), bool)], 1)
    feats = {f"feat{i}": rs.rand(n, s, s, s, RCNN_C).astype(np.float32)
             for i, s in enumerate((8, 4, 2, 1))}
    return {**feats, "boxes": props, "valid": valid, "gt_boxes": gt,
            "gt_valid": det["gt_valid"]}


def step(kind, trainer, state, batch):
    """One train step of `kind` on `batch` (tensors)."""
    if kind != "rcnn":
        return trainer.train_step(state, batch)
    feats = [batch[f"feat{i}"] for i in range(4)]
    return trainer.train_step(state, feats, {"boxes": batch["boxes"], "valid": batch["valid"]},
                              batch)


def run_steps(kind, mesh=None):
    """init(0) and STEPS[kind] steps on `kind`'s global batch (this rank's
    rows on a mesh): the metrics of each step, the parameters after, and
    the inputs of every count_sum call (the rows' own counts)."""
    trainer = make_trainer(kind, mesh)
    seen = []
    inner = trainer.count_sum

    def recorded(t):
        seen.append(t.detach().clone().numpy())
        return inner(t)

    trainer.count_sum = recorded
    state = trainer.init(0)
    host = global_batch(kind)
    batch = shard_batch(host, mesh) if mesh else {k: torch.from_numpy(v) for k, v in host.items()}
    metrics = []
    for _ in range(STEPS[kind]):
        state, m = step(kind, trainer, state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    params = {k: v.detach().numpy().copy() for k, v in state.model.state_dict().items()}
    return {"metrics": metrics, "params": params, "counts": seen}


def rank_steps(kinds):
    """A launch target: run_steps of each kind on a 2-rank gloo mesh."""
    with make_mesh(2, device="cpu") as mesh:
        return {kind: run_steps(kind, mesh) for kind in kinds}


# --------------------------------------------------------- the mesh itself

def _lone(rank=0, world=2):
    """A mesh's view without a group (its collectives are the identity)."""
    return DataMesh(rank, world, rank, torch.device("cpu"))


def test_make_mesh_without_a_group_is_one_rank_and_refuses_more(monkeypatch):
    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.world_size, mesh.group) == (0, 1, None)
    assert mesh.device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="asked for 2 ranks but the world has 1"):
        make_mesh(2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()  # no fallback to the CPU
    t = [torch.ones(3)]
    assert all_reduce_sum(t, mesh)[0] is t[0] and count_sum(t[0], None) is t[0]
    assert gather_objects({"a": 1}, mesh) == [{"a": 1}]


def test_shard_batch_takes_the_ranks_rows_and_refuses_an_indivisible_batch():
    host = {"grids": np.arange(4 * 2 * 2 * 2 * 4 * 2, dtype=np.float32).reshape(4, 2, 2, 2, 4, 2),
            "sizes": np.arange(12, dtype=np.int32).reshape(4, 3)}
    got = shard_batch(host, _lone(1))
    assert tuple(got["grids"].shape) == (2, 2, 2, 2, 8)  # patch-major: channel-flat
    np.testing.assert_array_equal(got["grids"].numpy(), host["grids"][2:].reshape(2, 2, 2, 2, 8))
    np.testing.assert_array_equal(got["sizes"].numpy(), host["sizes"][2:])
    with pytest.raises(ValueError, match="does not divide over 3 ranks"):
        shard_batch(host, _lone(0, 3))


def test_draws_are_the_ranks_rows_of_the_global_draws():
    """A BatchGenerator for rows [2, 4) of a global batch of 6 gives the
    mask, keep factors and sampler draws that those rows get in one
    process."""
    def plain(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return g

    sl = slice(2, 4)
    mask = block_mask_3d(batch_generator("cpu", 1, 2, 6), 2, 8, block=2, p_remove=0.5)
    want = block_mask_3d(plain(1), 6, 8, block=2, p_remove=0.5)[sl]
    assert torch.equal(mask, want) and 0 < int(want.sum()) < want.numel()
    assert torch.equal(droppath_keep(2, 0.3, batch_generator("cpu", 2, 2, 6)),
                       droppath_keep(6, 0.3, plain(2))[sl])
    labels = torch.from_numpy(np.random.RandomState(0).randint(-1, 2, (6, 50)).astype(np.float32))
    got = balanced_sample(labels[sl], 8, 0.5, generator=batch_generator("cpu", 3, 2, 6))
    want = balanced_sample(labels, 8, 0.5, generator=plain(3))
    assert all(torch.equal(a, b[sl]) for a, b in zip(got, want))
    case = global_batch("rcnn", 6)
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    cfg = RCNNConfig(resolution=32, rois_per_scene=8)
    got = sample_rois(cfg, t["boxes"][sl], t["valid"][sl], t["gt_boxes"][sl], t["gt_valid"][sl],
                      generator=batch_generator("cpu", 4, 2, 6))
    want = sample_rois(cfg, t["boxes"], t["valid"], t["gt_boxes"], t["gt_valid"],
                       generator=plain(4))
    assert all(torch.equal(a, b[sl]) for a, b in zip(got, want))


def test_trainer_generator_without_a_group_is_the_plain_one():
    """A mesh of one rank without a group changes nothing: plain generators
    and the identity count_sum (so the single-process path is the same
    code as before the mesh)."""
    trainer = make_trainer("mae", make_mesh(device="cpu"))
    assert type(trainer._generator(0, 0, 0, 4)) is torch.Generator
    t = torch.ones(2)
    assert trainer.count_sum(t) is t


# ----------------------------------------------------------------- the feed

@pytest.fixture()
def disk_scenes(tmp_path):
    """6 scenes with OBB boxes on disk."""
    feats, boxes = tmp_path / "features", tmp_path / "boxes"
    feats.mkdir()
    boxes.mkdir()
    for i, s in enumerate(synthetic_detection_scenes(6, 24, seed=9, obb=True)):
        np.savez(feats / f"s{i}.npz", rgbsigma=s["rgbsigma"])
        np.save(boxes / f"s{i}.npy", s["boxes"])
    return tmp_path


@pytest.mark.parametrize("kind", ["mae", "detection"])
def test_rank_feeds_are_rows_of_the_serial_batches(disk_scenes, kind):
    """With augments and 2 workers a rank's batches are its rows of the
    single-process serial batches (every rank draws the whole batch's
    augment parameters, in order, and applies its own), over 3 epochs."""
    aug = dict(flip_prob=0.5, rotate_prob=0.5, rot_scale_prob=0.5)

    def batches(rank, world, workers):
        ds = SceneDataset(str(disk_scenes / "features"), boxes_path=str(disk_scenes / "boxes"),
                          seed=4, **aug)
        kw = dict(seed=1, workers=workers, rank=rank, world=world)
        it = (mae_batch_iterator(ds, 4, 24, patch_major=4, **kw) if kind == "mae"
              else detection_batch_iterator(ds, 4, 24, max_gt=16, **kw))
        out = [next(it) for _ in range(4)]
        it.close()
        return out

    serial = batches(0, 1, 0)
    for rank in (0, 1):
        got = batches(rank, 2, 2)
        for g, s in zip(got, serial):
            for k in s:
                np.testing.assert_array_equal(g[k], s[k][2 * rank: 2 * rank + 2], err_msg=k)
    with pytest.raises(ValueError, match="does not divide over 3 ranks"):
        next(mae_batch_iterator(ListDataset([{"rgbsigma": np.zeros((8, 8, 8, 4))}] * 4), 4, 8,
                                rank=0, world=3))


def test_device_corpus_gathers_the_ranks_rows():
    corpus = {"grids": np.arange(10 * 2, dtype=np.float32).reshape(10, 2),
              "sizes": np.arange(10, dtype=np.int32)}
    one = device_corpus_batches(corpus, "cpu", 4, seed=3)
    ranks = [device_corpus_batches(corpus, "cpu", 4, seed=3, rank=r, world=2) for r in (0, 1)]
    for _ in range(5):  # over an epoch's end
        want = next(one)
        for r, it in enumerate(ranks):
            got = next(it)
            assert all(torch.equal(got[k], want[k][2 * r: 2 * r + 2]) for k in want)


# --------------------------------------------------- collectives over gloo

def collectives_rank():
    """A launch target: replicate, all_reduce_grads and the sums on 2 ranks."""
    with make_mesh(2, device="cpu") as mesh:
        r = mesh.rank
        module = torch.nn.Linear(3, 2)
        torch.nn.init.constant_(module.weight, float(r + 1))  # rank 0's must win
        version = module.weight._version
        replicate(module, mesh)
        for i, p in enumerate(module.parameters()):
            p.grad = torch.full_like(p, float(r + 1) * (i + 1))
        nbytes = all_reduce_grads(module.parameters(), mesh)
        sums = all_reduce_sum([torch.tensor(float(r)), torch.tensor([r, 2 * r], dtype=torch.int64)],
                              mesh)
        return {"weight": module.weight.detach().numpy(),
                "bumped": module.weight._version > version,
                "grads": [p.grad.numpy() for p in module.parameters()], "bytes": nbytes,
                "sums": [s.numpy() for s in sums], "gathered": gather_objects(r, mesh)}


def test_collectives_over_gloo_ranks():
    out = dryrun.launch(f"{MODULE}:collectives_rank", 2)
    for o in out:
        np.testing.assert_array_equal(o["weight"], np.ones((2, 3)))
        assert o["bumped"]  # a cache keyed on the version sees the broadcast
        np.testing.assert_array_equal(o["grads"][0], np.full((2, 3), 3.0))
        np.testing.assert_array_equal(o["grads"][1], np.full((2,), 6.0))
        assert o["bytes"] == 8 * 4
        assert float(o["sums"][0]) == 1.0 and o["sums"][1].tolist() == [1, 2]
        assert o["gathered"] == [0, 1]


def failing_rank():
    """A launch target: rank 1 raises, rank 0 would sleep a minute."""
    if os.environ["RANK"] == "1":
        raise ValueError("rank 1 fails on purpose")
    time.sleep(60)


def test_launch_kills_the_ranks_and_reports_a_failure():
    """Rank 1 raises while rank 0 sleeps: rank 0 is killed at once (not at
    the timeout) and the error carries rank 1's traceback."""
    want = r"(?s)failed: ranks \[1\] \(killed: \[0\]\).*rank 1 fails on purpose"
    with pytest.raises(RuntimeError, match=want):
        dryrun.launch(f"{MODULE}:failing_rank", 2, timeout_s=30)


# ------------------------------------------------------------ the dry runs

def test_dryrun_multichip():
    out = dryrun.dryrun_multichip(2)
    assert len(out) == 2 and out[0]["psnr"] == out[0]["psnr_restored"]


def test_dryrun_multihost_checkpoints_on_rank_0_only():
    out = dryrun.dryrun_multihost(2, 2)
    assert [(o["group_rank"], o["local_rank"]) for o in out] == [(0, 0), (0, 1), (1, 0), (1, 1)]


# --------------------------------------------------------------- the drivers

MAE_SPACE = ["--mode", "train", "--dataset", "synthetic", "--backbone_type", "swin_nano",
             "--resolution", "32", "--batch_size", "2", "--n_synthetic", "2", "--steps", "1",
             "--compute_dtype", "float32", "--device", "cpu", "--workers", "0", "--prefetch",
             "0", "--log_interval", "1"]


def mae_driver_rank(ckpt):
    """A launch target: run_mae_pretrain's one step with --mesh_space 2 in
    this rank of a world of 2, then its --mode benchmark line."""
    space = ["--mesh_space", "2", "--checkpoint_dir", ckpt]
    bench = [a if a != "train" else "benchmark" for a in MAE_SPACE]
    # one group for both runs: a driver that makes the group destroys it
    with make_mesh(2, device="cpu"):
        return (run_mae_pretrain.main([*MAE_SPACE, *space]),
                run_mae_pretrain.main([*bench, *space]))


def test_drivers_take_mesh_space(tmp_path):
    """run_mae_pretrain --mesh_space 2 on 2 CPU ranks gives one process's
    loss, and its benchmark line reports the (1 x 2) mesh; run_fcos still
    refuses it with JAX's words."""
    out = dryrun.launch(f"{MODULE}:mae_driver_rank", 2, {"ckpt": str(tmp_path / "space")})
    want = run_mae_pretrain.main([*MAE_SPACE, "--checkpoint_dir", str(tmp_path / "one")])
    for train, bench in out:
        np.testing.assert_allclose(train["history"][0]["loss"], want["history"][0]["loss"],
                                   rtol=1e-5)
        assert (bench["world_size"], bench["data"], bench["space"],
                bench["batch_per_rank"]) == (2, 1, 2, 2)
        assert np.isfinite(bench["loss"])
    tiny = ["--dataset", "synthetic", "--backbone_type", "swin_nano", "--resolution", "32",
            "--device", "cpu", "--mesh_space", "2"]
    with pytest.raises(SystemExit, match="detection trainers are data-parallel only"):
        run_fcos.main(tiny)
