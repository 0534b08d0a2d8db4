"""The port's voxel semantics train step against the benchmark's plain
reference (perfbench/reference/semantics.py), on the CPU at a tiny size
with seeded random weights, and the benchmark's label painting.

VoxelSemanticsTrainer.train_step (float32, remat on, stochastic depth
drawn) and the reference from the same weights, batch and draws: the loss,
ce and soft_miou of three steps, the first step's clipped gradients leaf by
leaf and the parameters after three AdamW steps, to float32 rounding. The
labels the `sem_s160` cell trains on are the scenes' boxes painted by
scenes.paint_obb, each with its drawn class, a later box over an earlier
one, void elsewhere.
"""

import statistics

import numpy as np
import pytest
import torch

from nerf_mae_torch.config import MAEConfig, SwinConfig, TrainConfig
from nerf_mae_torch.models.heads import VoxelSemantics3D, calculate_class_weights
from nerf_mae_torch.train.head_trainer import VoxelSemanticsTrainer
from nerf_mae_torch.train.optim import make_optimizer
from nerf_mae_torch.train.trainer import TrainState
from perfbench import scenes, spec, weights
from perfbench.reference import semantics as ref_sem
from perfbench.reference import swin as ref_swin
from perfbench.reference import train as ref_train
from perfbench.reference.swin import Numerics
from perfbench.tasks import voxel_semantics

torch.set_num_threads(1)

CELL = spec.load_json(spec.ROOT / "perfbench/configs/sem_swin_s_160.json")
CFG = {**CELL, "resolution": 32, "embed_dim": 12, "depths": [1, 1, 2, 1], "num_classes": 5,
       "compute_dtype": "float32"}
SEED, BATCH, STEPS, TOTAL = 11, 2, 3, 100


def _batch():
    rs = np.random.RandomState(0)
    grids = rs.rand(BATCH, 32, 32, 32, 4).astype(np.float32)
    grids[..., 3] *= rs.rand(BATCH, 32, 32, 32) > 0.5
    labels = rs.randint(0, CFG["num_classes"], (BATCH, 32, 32, 32)).astype(np.int32)
    return torch.from_numpy(grids), torch.from_numpy(labels)


def _weights():
    return weights.make(ref_sem.shapes(CFG), CFG["init"], SEED, torch.device("cpu"))


def _port_steps(compute_dtype):
    """Three port train steps: per step (loss, ce, soft_miou), the first
    step's clipped gradients, the parameters after the third."""
    c = CFG
    swin = SwinConfig(embed_dim=c["embed_dim"], depths=tuple(c["depths"]),
                      num_heads=tuple(c["num_heads"]),
                      stochastic_depth_prob=c["stochastic_depth_prob"])
    mae_cfg = MAEConfig(swin=swin, resolution=c["resolution"], compute_dtype=compute_dtype,
                        remat=c["remat"])
    train_cfg = TrainConfig(batch_size=BATCH, lr=c["lr"], weight_decay=c["weight_decay"],
                            clip_grad_norm=c["clip_grad_norm"])
    grids, labels = _batch()
    trainer = VoxelSemanticsTrainer(
        mae_cfg, train_cfg, TOTAL, device="cpu", num_classes=c["num_classes"],
        class_weights=calculate_class_weights(labels.numpy(), c["num_classes"]))
    model = VoxelSemantics3D(trainer.mae_cfg, c["num_classes"], device="cpu")
    model.load_state_dict(_weights())
    state = TrainState(0, model.train(), make_optimizer(model.parameters(), train_cfg), SEED)
    metrics, grads = [], None
    for i in range(STEPS):
        state, m = trainer.train_step(state, {"grids": grids, "semantics": labels})
        metrics.append([float(m[k]) for k in ("loss", "ce", "soft_miou")])
        if i == 0:
            grads = {k: p.grad.clone() for k, p in state.model.named_parameters()}
    params = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    return metrics, grads, params


@pytest.fixture(scope="module")
def port():
    return _port_steps("float32")


@pytest.fixture(scope="module")
def reference():
    p = _weights()
    grids, labels = _batch()
    w = torch.from_numpy(ref_sem.class_weights(labels.numpy(), CFG["num_classes"]))
    opt = ref_train.AdamW(p, CFG["weight_decay"])
    metrics, first = [], None
    for i in range(STEPS):
        keeps = ref_swin.draw_keeps(CFG, BATCH, ref_train.generator(
            SEED, i, ref_train.DROPPATH_STREAM, torch.device("cpu")), torch.device("cpu"))
        loss, grads, terms = ref_sem.loss_and_grads(p, grids, labels, keeps, w, CFG,
                                                    Numerics("float32"), 1)
        ref_train.clip_(grads, CFG["clip_grad_norm"])
        metrics.append([loss, terms["ce"], terms["soft_miou"]])
        if i == 0:
            first = {k: g.clone() for k, g in grads.items()}
        opt.step(p, grads, ref_train.onecycle_lr(i, CFG["lr"], TOTAL))
    return metrics, first, p


def test_class_weights_match():
    _, labels = _batch()
    ours = ref_sem.class_weights(labels.numpy(), CFG["num_classes"])
    theirs = calculate_class_weights(labels.numpy(), CFG["num_classes"])
    np.testing.assert_allclose(ours, theirs, rtol=1e-6)
    assert ours[0] == 0.0 and (ours[1:] > 0).all()


def test_losses_match(port, reference):
    np.testing.assert_allclose(np.array(port[0]), np.array(reference[0]), rtol=2e-6)


def _gap(ours, theirs, keys, floor):
    """Per leaf: the norm of the difference over the larger of the
    reference leaf's norm and `floor` (the median leaf's)."""
    return {k: float((ours[k] - theirs[k]).norm()) / max(float(theirs[k].norm()), floor)
            for k in keys}


# Float32 rounding, amplified where a gradient crosses an instance norm's
# backward (its mean terms cancel; at 32^3 decoder4 normalises over 8
# voxels): readings up to 2.0e-3 on the gradients and 1.7e-2 on the
# parameters' change. The same steps in bfloat16 fail the gradients' limit
# (test_bfloat16_steps_fail_the_gradient_limit).
GRAD_GAP, CHANGE_GAP = 1e-2, 5e-2


def test_first_gradients_match_leaf_by_leaf(port, reference):
    ours, theirs = port[1], reference[1]
    assert ours.keys() == theirs.keys()
    median = statistics.median(float(g.norm()) for g in theirs.values())
    gaps = _gap(ours, theirs, theirs, median)
    assert max(gaps.values()) < GRAD_GAP, sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
    # the last layers, which no instance norm follows, to a few ulps
    for k in ("sem_out.conv.weight", "sem_out.conv.bias"):
        torch.testing.assert_close(ours[k], theirs[k], rtol=1e-5, atol=1e-9)


def test_bfloat16_steps_fail_the_gradient_limit(reference):
    ours, theirs = _port_steps("bfloat16")[1], reference[1]
    median = statistics.median(float(g.norm()) for g in theirs.values())
    assert max(_gap(ours, theirs, theirs, median).values()) > 3 * GRAD_GAP


def test_parameters_after_three_steps_match(port, reference):
    """The change of every leaf whose gradient is not rounding noise (under
    a thousandth of the median leaf's: the conv biases before an instance
    norm), by its norm; every element to within the two sign flips of
    AdamW's normalised step that noise in its gradient can cause."""
    w0 = _weights()
    grads = reference[1]
    median = statistics.median(float(g.norm()) for g in grads.values())
    moving = [k for k, g in grads.items() if float(g.norm()) >= 1e-3 * median]
    ours = {k: port[2][k] - w0[k] for k in moving}
    theirs = {k: reference[2][k] - w0[k] for k in moving}
    change_median = statistics.median(float(v.norm()) for v in theirs.values())
    gaps = _gap(ours, theirs, moving, change_median)
    assert max(gaps.values()) < CHANGE_GAP, sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
    flips = 2 * sum(ref_train.onecycle_lr(i, CFG["lr"], TOTAL) for i in range(STEPS))
    for k, v in reference[2].items():
        torch.testing.assert_close(port[2][k], v, rtol=0, atol=flips, msg=k)


def test_labels_are_the_boxes_painted():
    """Each labelled voxel carries the class drawn for the last box that
    paints it (scenes.paint_obb on the same boxes); every voxel the scene's
    boxes paint is labelled, and nothing else."""
    traffic = {**spec.load_json(spec.ROOT / "perfbench/traffic/resident_obb_boxes.json"),
               "scenes": 3, "extent": [24, 32], "boxes": [3, 6], "half_extent": [2, 5]}
    grids, sizes, boxes = scenes.draw(traffic, 32, 5)
    labels = voxel_semantics.paint_labels(boxes, sizes, 32, 9, 19)
    assert labels.dtype == np.int32 and labels.shape == (3, 32, 32, 32)
    for i, (scene_boxes, size) in enumerate(zip(boxes, sizes)):
        rng = scenes.scene_rng(9, i)
        classes = [rng.randint(1, 19) for _ in scene_boxes]
        which = np.zeros((32, 32, 32, 4), np.float32)
        for j, box in enumerate(scene_boxes):
            scenes.paint_obb(which[:size[0], :size[1], :size[2]], box, j + 1, 1.0)
        last = which[..., 0].astype(int)
        want = np.where(last > 0, np.array([0] + classes)[last], 0)
        np.testing.assert_array_equal(labels[i], want)
        np.testing.assert_array_equal(labels[i] > 0, grids[i, ..., 3] > 0)
        assert set(np.unique(labels[i])) <= set(range(19))
