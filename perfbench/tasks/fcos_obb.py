"""The FCOS detection training step with oriented boxes: nerf_mae_torch's
DetectionTrainer.train_step over a Swin-FPN on the benchmark's weights,
fed from scenes and boxes held on the device. The reference is
perfbench/reference/fcos.py."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from perfbench import scenes
from perfbench.reference import fcos as ref_fcos
from perfbench.reference import swin as ref_swin
from perfbench.reference import train as ref_train
from perfbench.training import DRAWS, FEED, TrainingTask, sub_seed


class FCOSTrain(TrainingTask):
    kind = "fcos"
    terms = ("loss_cls", "loss_reg", "loss_centerness")

    def param_shapes(self):
        return ref_fcos.shapes(self.cfg)

    def build_trainer(self, w):
        from nerf_mae_torch.config import SwinConfig, TrainConfig
        from nerf_mae_torch.models.detector import FCOSDetector
        from nerf_mae_torch.models.fcos import FCOSConfig
        from nerf_mae_torch.train.det_trainer import DetectionTrainer
        from nerf_mae_torch.train.optim import make_optimizer
        from nerf_mae_torch.train.trainer import TrainState
        c = self.cfg
        swin = SwinConfig(embed_dim=c["embed_dim"], depths=tuple(c["depths"]),
                          num_heads=tuple(c["num_heads"]), patch_size=(c["patch_size"],) * 3,
                          window_size=tuple(c["window_size"]), mlp_ratio=c["mlp_ratio"],
                          stochastic_depth_prob=c["stochastic_depth_prob"],
                          norm_eps=c["norm_eps"])
        fcos = FCOSConfig(resolution=c["resolution"], strides=tuple(c["strides"]),
                          num_convs=c["num_convs"], use_obb=True,
                          center_sampling_radius=c["center_sampling_radius"],
                          iou_loss_type=c["iou_loss_type"], reg_loss_weight=c["reg_loss_weight"],
                          max_gt=c["max_gt"])
        train_cfg = TrainConfig(batch_size=self.batch, lr=c["lr"], weight_decay=c["weight_decay"],
                                clip_grad_norm=c["clip_grad_norm"])
        trainer = DetectionTrainer(swin, fcos, train_cfg, c["total_steps"], device=self.device,
                                   backbone=c["backbone"], compute_dtype=c["compute_dtype"])
        model = FCOSDetector(swin, fcos, c["backbone"], out_channels=c["fpn_channels"],
                             dtype=trainer.dtype, remat=trainer.remat, device=self.device)
        model.load_state_dict(w)
        state = TrainState(0, model.train(), make_optimizer(model.parameters(), train_cfg),
                           sub_seed(self.seed, DRAWS))
        return trainer, state

    def corpus(self) -> Dict[str, np.ndarray]:
        grids, sizes, boxes = self.scenes
        return {"grids": grids, "sizes": sizes, **scenes.pad_boxes(boxes, self.cfg["max_gt"])}

    def make_feed(self):
        from nerf_mae_torch.data.device_cache import device_corpus_batches
        t = self.traffic
        return device_corpus_batches(self.corpus(), self.device, self.batch,
                                     seed=sub_seed(self.seed, FEED), shuffle=t["shuffle"],
                                     transfer_dtype=t["transfer_dtype"])

    def expected_batch(self, step: int) -> Dict[str, torch.Tensor]:
        rows = self.order(step)
        out = {k: torch.from_numpy(v[rows]).to(self.device) for k, v in self.corpus().items()}
        if self.traffic["transfer_dtype"] == "bfloat16":
            out["grids"] = out["grids"].to(torch.bfloat16)
        out["grids"] = out["grids"].float()
        return out

    def reference_grads(self, p, batch, step, num, rows):
        keeps = ref_swin.draw_keeps(self.cfg, self.batch, ref_train.generator(
            sub_seed(self.seed, DRAWS), step, ref_train.DROPPATH_STREAM, self.device), self.device)
        sub = {k: v[rows] for k, v in batch.items()}
        return ref_fcos.loss_and_grads(p, sub, ref_swin.rows_of(keeps, rows), self.cfg, num,
                                       self.workload["reference_rows"])


def build(run) -> FCOSTrain:
    return FCOSTrain(run)
