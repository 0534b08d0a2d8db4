"""The MAE pretraining step: nerf_mae_torch's MAETrainer.train_step on the
benchmark's weights, fed either from a corpus held on the device
("feed": "device") or from npz files through the system's host training
feed ("feed": "disk"). The reference is perfbench/reference/mae.py."""

from __future__ import annotations

import os
import types
from typing import Dict

import numpy as np
import torch

from perfbench import scenes
from perfbench.reference import mae as ref_mae
from perfbench.reference import swin as ref_swin
from perfbench.reference import train as ref_train
from perfbench.training import DRAWS, FEED, TrainingTask, sub_seed


class MAEPretrain(TrainingTask):
    kind = "mae"
    terms = ("loss_rgb", "loss_alpha")

    def param_shapes(self):
        return ref_mae.shapes(self.cfg)

    def mae_config(self):
        from nerf_mae_torch.config import MAEConfig, SwinConfig
        c = self.cfg
        swin = SwinConfig(embed_dim=c["embed_dim"], depths=tuple(c["depths"]),
                          num_heads=tuple(c["num_heads"]), patch_size=(c["patch_size"],) * 3,
                          window_size=tuple(c["window_size"]), mlp_ratio=c["mlp_ratio"],
                          stochastic_depth_prob=c["stochastic_depth_prob"],
                          norm_eps=c["norm_eps"])
        return MAEConfig(swin=swin, resolution=c["resolution"],
                         input_channels=c["input_channels"], out_channels=c["out_channels"],
                         masking_prob=c["masking_ratio"], mask_block=c["mask_block"],
                         compute_dtype=c["compute_dtype"])

    def build_trainer(self, w):
        from nerf_mae_torch.config import TrainConfig
        from nerf_mae_torch.models.mae import SwinMAE3D
        from nerf_mae_torch.train.optim import make_optimizer
        from nerf_mae_torch.train.trainer import MAETrainer, TrainState
        c = self.cfg
        train_cfg = TrainConfig(batch_size=self.batch, lr=c["lr"], weight_decay=c["weight_decay"],
                                clip_grad_norm=c["clip_grad_norm"])
        trainer = MAETrainer(self.mae_config(), train_cfg, c["total_steps"], device=self.device)
        model = SwinMAE3D(trainer.mae_cfg, device=self.device)
        model.load_state_dict(w)
        state = TrainState(0, model.train(), make_optimizer(model.parameters(), train_cfg),
                           sub_seed(self.seed, DRAWS))
        return trainer, state

    def make_feed(self):
        t = self.traffic
        grids, sizes, _ = self.scenes
        if t["feed"] == "device":
            from nerf_mae_torch.data.device_cache import device_corpus_batches
            return device_corpus_batches({"grids": grids, "sizes": sizes}, self.device,
                                         self.batch, seed=sub_seed(self.seed, FEED),
                                         shuffle=t["shuffle"],
                                         transfer_dtype=t["transfer_dtype"])
        from nerf_mae_torch.common import make_train_batches
        from nerf_mae_torch.data.datasets import SceneDataset, mae_batch_iterator
        directory = os.path.join(self.run.scratch, "scenes")
        scenes.write_npz(directory, grids, sizes)
        self.scenes = None  # the reference reads the files back
        ds = SceneDataset(directory, flip_prob=t["flip_prob"], rotate_prob=t["rotate_prob"],
                          seed=sub_seed(self.seed, FEED))
        args = types.SimpleNamespace(device_data=False, prefetch=t["prefetch"],
                                     transfer_dtype=t["transfer_dtype"], batch_size=self.batch,
                                     seed=sub_seed(self.seed, FEED))
        return make_train_batches(args, self.device, lambda: mae_batch_iterator(
            ds, self.batch, self.cfg["resolution"], seed=sub_seed(self.seed, FEED),
            workers=t["workers"]))

    # -- the reference's side -----------------------------------------------
    def expected_batch(self, step: int) -> Dict[str, torch.Tensor]:
        if self.traffic["feed"] != "device":
            return self.disk_batch(step)
        grids, sizes, _ = self.scenes
        rows = self.order(step)
        g = torch.from_numpy(grids[rows]).to(self.device)
        if self.traffic["transfer_dtype"] == "bfloat16":
            g = g.to(torch.bfloat16)
        return {"grids": g.float(), "sizes": torch.from_numpy(sizes[rows]).to(self.device)}

    def disk_batch(self, step: int) -> Dict[str, torch.Tensor]:
        from perfbench.reference import feed as ref_feed
        t = self.traffic
        rows = self.order(step)
        draws = ref_feed.augment_draws(sub_seed(self.seed, FEED), t["flip_prob"],
                                       t["rotate_prob"], self.batch * (step + 1))
        grids, sizes = [], []
        for j, i in enumerate(rows):
            g = ref_feed.read_scene(os.path.join(self.run.scratch, "scenes", f"scene{i:04d}.npz"))
            g = ref_feed.augment(g, draws[self.batch * step + j])
            padded, size = ref_feed.pad_to_cube(g, self.cfg["resolution"])
            grids.append(padded)
            sizes.append(size)
        g = torch.from_numpy(np.stack(grids)).to(self.device)
        if t["transfer_dtype"] == "bfloat16":
            g = g.to(torch.bfloat16)
        return {"grids": g.float(), "sizes": torch.from_numpy(np.stack(sizes)).to(self.device)}

    def reference_grads(self, p, batch, step, num, rows):
        cfg, b = self.cfg, self.batch
        gen = ref_train.generator(sub_seed(self.seed, DRAWS), step, ref_train.MASK_STREAM,
                                  self.device)
        t = self.cfg["resolution"] // self.cfg["patch_size"]
        mask = ref_train.block_mask(gen, b, t, self.cfg["mask_block"], self.cfg["masking_ratio"])
        keeps = ref_swin.draw_keeps(cfg, b, ref_train.generator(
            sub_seed(self.seed, DRAWS), step, ref_train.DROPPATH_STREAM, self.device), self.device)
        return ref_mae.loss_and_grads(p, batch["grids"][rows], batch["sizes"][rows], mask[rows],
                                      ref_swin.rows_of(keeps, rows), cfg, num,
                                      self.workload["reference_rows"])


def build(run) -> MAEPretrain:
    return MAEPretrain(run)
