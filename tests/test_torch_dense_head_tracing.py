"""The dense heads' spans and counters (tracing.py in models/heads.py and
train/head_trainer.py), on the CPU at a tiny size, and their FLOP count.

Under torch.profiler a voxel semantics train step records its pieces
(embed, the stages and merges, decoder4/3/2, encoder1, decoder1, head,
loss), each with its .bwd; the forward pieces fill the forward span and
the .bwd pieces partition the backward; dense_head.voxels counts the
voxels scored and dense_head.remat the pieces run under checkpoint. With
the profiler off nothing is recorded or counted. flops.py's
dense_head_flops_per_grid equals the benchmark's frozen count
(perfbench/dense_counts.py).
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nerf_mae_torch import flops, tracing
from nerf_mae_torch.config import SWIN_PRESETS, MAEConfig, SwinConfig, TrainConfig
from nerf_mae_torch.train.head_trainer import VoxelSemanticsTrainer
from perfbench import dense_counts, spec

torch.set_num_threads(1)

TINY = MAEConfig(swin=SwinConfig(embed_dim=12, depths=(1, 1, 2, 1), num_heads=(3, 6, 12, 24)),
                 resolution=32, compute_dtype="float32")
FORWARD = ("encoder1", "embed", "stage0", "stage1", "stage2", "stage3", "decoder4", "decoder3",
           "decoder2", "decoder1", "head", "loss")
# the order the backward reaches the pieces' outputs: encoder1's output
# joins the graph first, so its piece runs last
BACKWARD = ["loss", "head", "decoder1", "decoder2", "decoder3", "decoder4", "stage3", "merge3",
            "stage2", "merge2", "stage1", "merge1", "stage0", "embed", "encoder1"]


@pytest.fixture(autouse=True)
def fresh():
    tracing.reset()
    yield
    tracing.reset()


def _step(traced: bool, steps: int = 1):
    trainer = VoxelSemanticsTrainer(TINY, TrainConfig(batch_size=2), 100, device="cpu",
                                    num_classes=5)
    state = trainer.init(0)
    rs = np.random.RandomState(0)
    batch = {"grids": torch.from_numpy(rs.rand(2, 32, 32, 32, 4).astype(np.float32)),
             "semantics": torch.from_numpy(rs.randint(0, 5, (2, 32, 32, 32)).astype(np.int32))}
    if not traced:
        for _ in range(steps):
            state, _ = trainer.train_step(state, batch)
        return
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(steps):
            state, _ = trainer.train_step(state, batch)


def test_pieces_fill_the_forward_and_partition_the_backward():
    _step(traced=True)
    recs = tracing.records()
    by_name = {r.name: r for r in recs}
    for n in FORWARD:
        assert by_name[f"nerf_mae.{n}"].parent == by_name["nerf_mae.forward"].id, n
    pieces = [r for r in recs if r.name.endswith(tracing.BWD)]
    assert [r.name for r in pieces] == [f"nerf_mae.{n}.bwd" for n in BACKWARD]
    for a, b in zip(pieces, pieces[1:]):
        assert a.end_ns == b.start_ns
    # the tolerance of the MAE's spans (test_torch_tracing.py): 3%
    bwd = by_name["nerf_mae.backward"]
    assert pieces[-1].end_ns - pieces[0].start_ns >= 0.97 * (bwd.end_ns - bwd.start_ns)
    fwd = by_name["nerf_mae.forward"]
    inside = sum(by_name[f"nerf_mae.{n}"].end_ns - by_name[f"nerf_mae.{n}"].start_ns
                 for n in FORWARD)
    assert inside >= 0.97 * (fwd.end_ns - fwd.start_ns)


def test_counters_count_voxels_and_checkpointed_pieces():
    _step(traced=True, steps=2)
    c = tracing.counters()
    assert c["dense_head.voxels"] == 2 * 2 * 32 ** 3
    # decoder4/3/2, encoder1 and decoder1 under checkpoint with remat on
    assert c["dense_head.remat"] == 2 * 5


def test_off_records_and_counts_nothing():
    _step(traced=False)
    assert tracing.records() == []
    assert not [k for k in tracing.counters() if k.startswith("dense_head.")]


@pytest.mark.parametrize("size", ["cell", "tiny"])
def test_dense_head_flops_equal_the_benchmarks(size):
    cfg = spec.load_json(spec.ROOT / "perfbench/configs/sem_swin_s_160.json")
    mae_cfg = MAEConfig(swin=SWIN_PRESETS["swin_s"], resolution=160)
    if size == "tiny":
        cfg.update(resolution=32, embed_dim=12, depths=[1, 1, 2, 1])
        mae_cfg = TINY
    port = flops.dense_head_flops_per_grid(mae_cfg, cfg["num_classes"])
    ours = dense_counts.semantics_flops_per_grid(cfg)
    assert ours.keys() == port.keys()
    for k, v in port.items():
        assert ours[k] == pytest.approx(v, rel=1e-12), k
    assert port["train_total"] == pytest.approx(3 * port["fwd_total"])
