"""The voxel semantic segmentation training step: nerf_mae_torch's
VoxelSemanticsTrainer.train_step over VoxelSemantics3D, built as
run_voxel_semantics builds it (the compute dtype and remat of the
configuration, AdamW + OneCycle + the clip), on the benchmark's weights,
fed by device_corpus_batches from scenes and their per-voxel labels held
on the device. The reference is perfbench/reference/semantics.py.

The labels are painted from the scenes' boxes (scenes.draw's "obb_boxes"
content): each box gets a class in 1 .. num_classes - 1, drawn per box from
a stream seeded by (the run's label seed, the scene), apart from the
scenes' own draws; a later box overwrites an earlier one, as its colour
does; every other voxel is void (0). The system's class weights are its
calculate_class_weights over the cell's labels; the reference computes its
own.

Both sides' records leave out the biases of the convolutions an instance
norm follows (every residual block's conv1-3): the norm removes them, so
their gradient is zero but for rounding, which at 160^3 x 8 sums over 32.8
M voxels and outgrows the median leaf's gradient, and AdamW's normalised
step then moves them by that noise. Their numbers say nothing of either
side.
"""

from __future__ import annotations

import functools
import re
from typing import Dict

import numpy as np
import torch

from perfbench import dense_counts, scenes  # noqa: F401 (dense_counts: the FLOP count)
from perfbench.reference import semantics as ref_sem
from perfbench.reference import swin as ref_swin
from perfbench.reference import train as ref_train
from perfbench.training import DRAWS, FEED, Records, TrainingTask, sub_seed

LABELS = 4  # the labels' sub-seed purpose, after training's four
UNGRADED = re.compile(r"conv[123]\.bias$")  # before an instance norm


def paint_labels(boxes, sizes: np.ndarray, resolution: int, seed: int,
                 num_classes: int) -> np.ndarray:
    """[N, R, R, R] int32 labels: scene i's boxes painted in order, each
    with its class drawn from scenes.scene_rng(seed, i), over void."""
    labels = np.zeros((len(boxes), resolution, resolution, resolution), np.int32)
    for i, (scene_boxes, size) in enumerate(zip(boxes, sizes)):
        rng = scenes.scene_rng(seed, i)
        canvas = np.zeros((*size, 4), np.float32)
        for box in scene_boxes:
            scenes.paint_obb(canvas, box, rng.randint(1, num_classes), 1.0)
        labels[i, :size[0], :size[1], :size[2]] = canvas[..., 0]
    return labels


class VoxelSemantics(TrainingTask):
    kind = "semantics"
    terms = ("ce", "soft_miou")

    def param_shapes(self):
        return ref_sem.shapes(self.cfg)

    @functools.cached_property
    def labels(self) -> np.ndarray:
        _, sizes, boxes = self.scenes
        return paint_labels(boxes, sizes, self.cfg["resolution"], sub_seed(self.seed, LABELS),
                            self.cfg["num_classes"])

    @functools.cached_property
    def reference_weights(self) -> torch.Tensor:
        return torch.from_numpy(ref_sem.class_weights(self.labels, self.cfg["num_classes"]))

    def build_trainer(self, w):
        from nerf_mae_torch.config import MAEConfig, SwinConfig, TrainConfig
        from nerf_mae_torch.models.heads import VoxelSemantics3D, calculate_class_weights
        from nerf_mae_torch.train.head_trainer import VoxelSemanticsTrainer
        from nerf_mae_torch.train.optim import make_optimizer
        from nerf_mae_torch.train.trainer import TrainState
        c = self.cfg
        swin = SwinConfig(embed_dim=c["embed_dim"], depths=tuple(c["depths"]),
                          num_heads=tuple(c["num_heads"]), patch_size=(c["patch_size"],) * 3,
                          window_size=tuple(c["window_size"]), mlp_ratio=c["mlp_ratio"],
                          stochastic_depth_prob=c["stochastic_depth_prob"],
                          norm_eps=c["norm_eps"])
        mae_cfg = MAEConfig(swin=swin, resolution=c["resolution"],
                            input_channels=c["input_channels"],
                            compute_dtype=c["compute_dtype"], remat=c["remat"])
        train_cfg = TrainConfig(batch_size=self.batch, lr=c["lr"], weight_decay=c["weight_decay"],
                                clip_grad_norm=c["clip_grad_norm"])
        trainer = VoxelSemanticsTrainer(
            mae_cfg, train_cfg, c["total_steps"], device=self.device,
            num_classes=c["num_classes"],
            class_weights=calculate_class_weights(self.labels, c["num_classes"]))
        model = VoxelSemantics3D(trainer.mae_cfg, c["num_classes"], device=self.device)
        model.load_state_dict(w)
        state = TrainState(0, model.train(), make_optimizer(model.parameters(), train_cfg),
                           sub_seed(self.seed, DRAWS))
        return trainer, state

    def corpus(self) -> Dict[str, np.ndarray]:
        return {"grids": self.scenes[0], "semantics": self.labels}

    def make_feed(self):
        from nerf_mae_torch.data.device_cache import device_corpus_batches
        t = self.traffic
        return device_corpus_batches(self.corpus(), self.device, self.batch,
                                     seed=sub_seed(self.seed, FEED), shuffle=t["shuffle"],
                                     transfer_dtype=t["transfer_dtype"])

    @staticmethod
    def graded(rec: Records) -> Records:
        """rec without the leaves UNGRADED names (module doc)."""
        for norms in (rec.grad_norms, rec.change_norms):
            for k in [k for k in norms if UNGRADED.search(k)]:
                del norms[k]
        return rec

    def first_steps(self, w0):
        return self.graded(super().first_steps(w0))

    # -- the reference's side -----------------------------------------------
    def expected_batch(self, step: int) -> Dict[str, torch.Tensor]:
        rows = self.order(step)
        out = {k: torch.from_numpy(v[rows]).to(self.device) for k, v in self.corpus().items()}
        if self.traffic["transfer_dtype"] == "bfloat16":
            out["grids"] = out["grids"].to(torch.bfloat16)
        out["grids"] = out["grids"].float()
        return out

    def reference_records(self, num, rows=None) -> Records:
        return self.graded(super().reference_records(num, rows))

    def reference_grads(self, p, batch, step, num, rows):
        keeps = ref_swin.draw_keeps(self.cfg, self.batch, ref_train.generator(
            sub_seed(self.seed, DRAWS), step, ref_train.DROPPATH_STREAM, self.device), self.device)
        return ref_sem.loss_and_grads(
            p, batch["grids"][rows], batch["semantics"][rows], ref_swin.rows_of(keeps, rows),
            self.reference_weights.to(self.device), self.cfg, num,
            self.workload["reference_rows"])


def build(run) -> VoxelSemantics:
    return VoxelSemantics(run)
