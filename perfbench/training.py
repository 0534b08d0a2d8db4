"""What every training cell shares: the benchmark's weights handed to the
system's trainer, the feed, the first steps that set-up drives and records,
the timed step, and the comparison of those first steps with the plain
reference once the window has closed.

A task module (perfbench/tasks/<task>.py) subclasses TrainingTask with its
model family: the parameter shapes, how the system's trainer and state are
built, and the reference's loss and gradients of one batch.
"""

from __future__ import annotations

import contextlib
import gc
import math
import statistics
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from perfbench import scenes, weights
from perfbench.reference import train as ref_train
from perfbench.reference.swin import Numerics

BETA1 = 0.9


def sub_seed(seed: int, purpose: int) -> int:
    """A 32-bit seed for one purpose of a run (weights, scenes, feed, the
    trainer's draws), from the run's seed of any size."""
    return int(np.random.SeedSequence([seed, purpose]).generate_state(1)[0])


WEIGHTS, SCENES, FEED, DRAWS = range(4)


@contextlib.contextmanager
def float32_exact():
    """TF32 off for matrix products and convolutions inside."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


class Records:
    """What one side's first steps give the comparison: each step's loss,
    the first gradient's norm by leaf (as the optimizer got it: clipped),
    and the norm by leaf of the parameters' change over the steps."""

    def __init__(self):
        self.losses: List[float] = []
        self.terms: List[Dict[str, float]] = []  # each step's loss terms
        self.grad_norms: Dict[str, float] = {}
        self.change_norms: Dict[str, float] = {}


def readings(program: Records, reference: Records) -> Dict[str, float]:
    """The numbers compared: the widest relative gap of a step's loss; by
    the worst leaf, the gap between the two sides' norms of the first
    gradient, over the larger of the reference's norm of that leaf and of
    the median leaf; the widest relative gap of a loss term (term_rel); the
    same for the parameters' change, leaving out the
    leaves whose reference gradient is under a thousandth of the median
    leaf's (they move by round-off alone)."""
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    loss = max(rel(a, b) for a, b in zip(program.losses, reference.losses))
    term = max(rel(a[k], b[k]) for a, b in zip(program.terms, reference.terms) for k in b)
    g_ref = reference.grad_norms
    g_med = statistics.median(g_ref.values())
    grad = max(abs(program.grad_norms[k] - v) / max(v, g_med) for k, v in g_ref.items())
    moving = [k for k, v in g_ref.items() if v >= 1e-3 * g_med]
    c_med = statistics.median(reference.change_norms[k] for k in moving)
    change = max(abs(program.change_norms[k] - reference.change_norms[k])
                 / max(reference.change_norms[k], c_med) for k in moving)
    return {"loss_rel": loss, "term_rel": term, "grad_gap": grad, "change_gap": change}


class TrainingTask:
    """Subclasses set `kind` ("mae" or "fcos": the FLOP count) and define
    param_shapes, build_trainer, batch_inputs and reference_grads."""

    kind = ""
    terms: tuple = ()  # the loss terms train_step reports, compared step by step

    def __init__(self, run):
        self.run = run
        self.cfg, self.traffic, self.workload = run.cell.config, run.cell.traffic, run.cell.workload
        self.device = run.device
        self.seed = run.seed
        self.batch = self.traffic["batch"]
        self.grids_per_step = self.batch
        self.batch_wait_s: List[float] = []
        self.steps = 0
        self.shapes = self.param_shapes()
        self.scenes = scenes.draw(self.traffic, self.cfg["resolution"], sub_seed(self.seed, SCENES))
        w = self.make_weights()
        self.trainer, self.state = self.build_trainer(w)
        self.feed = self.make_feed()
        self.program = self.first_steps(w)
        del w

    # -- the family's parts -------------------------------------------------
    def param_shapes(self) -> Dict[str, tuple]:
        raise NotImplementedError

    def build_trainer(self, w: Dict[str, torch.Tensor]):
        raise NotImplementedError

    def make_feed(self) -> Iterator[Dict[str, torch.Tensor]]:
        raise NotImplementedError

    def expected_batch(self, step: int) -> Dict[str, torch.Tensor]:
        """The batch the feed is to deliver at `step` (0-based), rebuilt by
        the benchmark from its own scenes, as float32 on the device."""
        raise NotImplementedError

    def reference_grads(self, p, batch, step: int, num: Numerics, rows: slice):
        """(loss, gradients, loss terms) of the reference on `batch`'s `rows`
        at `step`."""
        raise NotImplementedError

    # -- shared --------------------------------------------------------------
    def make_weights(self) -> Dict[str, torch.Tensor]:
        return weights.make(self.shapes, self.cfg["init"], sub_seed(self.seed, WEIGHTS),
                            self.device)

    def order(self, step: int) -> np.ndarray:
        """The scenes of batch `step` (0-based) as the feed states its order:
        each epoch a RandomState(feed seed) permutation (or the scenes in
        order), cut into whole batches."""
        n, b = self.traffic["scenes"], self.batch
        per_epoch = n // b
        rng = np.random.RandomState(sub_seed(self.seed, FEED))
        for _ in range(step // per_epoch + 1):
            perm = rng.permutation(n) if self.traffic["shuffle"] else np.arange(n)
        s = (step % per_epoch) * b
        return perm[s:s + b]

    def next_batch(self) -> Dict[str, torch.Tensor]:
        t0 = time.perf_counter()
        batch = next(self.feed)
        self.batch_wait_s.append(time.perf_counter() - t0)
        return batch

    def step(self) -> None:
        """One timed step, through the trainer's own call; the loss is read
        (a host synchronisation) every `log_every` steps, as a training
        loop logs it."""
        self.state, metrics = self.trainer.train_step(self.state, self.next_batch())
        self.steps += 1
        if self.steps % self.workload["log_every"] == 0:
            loss = float(metrics["loss"])
            if not math.isfinite(loss):
                raise FloatingPointError(f"loss {loss} at step {self.steps}")

    def named_parameters(self) -> Dict[str, torch.Tensor]:
        return dict(self.state.model.named_parameters())

    def first_steps(self, w0: Dict[str, torch.Tensor]) -> Records:
        """Set-up drives the trainer through its first `check_steps` steps
        with the window's own call and feed, and records them."""
        rec = Records()
        self.delivered = []
        for i in range(self.workload["check_steps"]):
            batch = self.next_batch()
            self.delivered.append({k: v.detach().to("cpu", copy=True) for k, v in batch.items()})
            self.state, metrics = self.trainer.train_step(self.state, batch)
            rec.losses.append(float(metrics["loss"]))
            rec.terms.append({k: float(metrics[k]) for k in self.terms})
            if i == 0:
                opt = self.state.optimizer
                moments = {k: opt.state[p].get("exp_avg", torch.zeros_like(p))
                           for k, p in self.named_parameters().items()}  # none: no update
                rec.grad_norms = leaf_norms({k: m / (1.0 - BETA1) for k, m in moments.items()})
        with torch.no_grad():
            rec.change_norms = leaf_norms({k: p - w0[k]
                                           for k, p in self.named_parameters().items()})
        self.batch_wait_s.clear()
        return rec

    def close(self) -> None:
        """Free the system's state (and stop its feed) before the reference
        runs."""
        close = getattr(self.feed, "close", None)
        if close is not None:
            close()
        self.feed = self.trainer = self.state = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_records(self, num: Numerics, rows: Optional[slice] = None) -> Records:
        """The reference's first steps from the same weights and draws,
        `rows` of each batch only where a fault is planted."""
        rec = Records()
        with float32_exact():
            p = self.make_weights()
            w0 = {k: v.clone() for k, v in p.items()}
            opt = ref_train.AdamW(p, self.cfg["weight_decay"])
            for i in range(self.workload["check_steps"]):
                batch = self.expected_batch(i)
                loss, grads, terms = self.reference_grads(p, batch, i, num,
                                                          rows or slice(0, self.batch))
                ref_train.clip_(grads, self.cfg["clip_grad_norm"])
                rec.losses.append(loss)
                rec.terms.append(terms)
                if i == 0:
                    rec.grad_norms = leaf_norms(grads)
                lr = ref_train.onecycle_lr(i, self.cfg["lr"], self.cfg["total_steps"])
                opt.step(p, grads, lr)
                del grads
            rec.change_norms = leaf_norms({k: p[k] - w0[k] for k in p})
        return rec

    def batch_gap(self) -> float:
        """Widest absolute gap between what the feed delivered in the first
        steps and the benchmark's own rebuild of those batches."""
        gap = 0.0
        for i, got in enumerate(self.delivered):
            want = self.expected_batch(i)
            for k, v in want.items():
                if got[k].numel() != v.numel():  # rows missing or added
                    return math.inf
                g = got[k].to(v.device).float().reshape(v.shape)
                gap = max(gap, float((g - v.float()).abs().max()))
        return gap

    def check(self) -> Dict[str, float]:
        """The numbers compared, once the window has closed and close() has
        freed the system's state."""
        out = {"batch_gap": self.batch_gap()}
        out.update(readings(self.program, self.reference_records(Numerics("float32"))))
        return out
