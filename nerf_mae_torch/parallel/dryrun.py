"""Multi-process dry runs of the data-parallel path (counterparts of
__graft_entry__.dryrun_multichip and dryrun_multihost), and `launch`, which
starts one fresh process a rank with torchrun's environment and returns
what each rank's function returned.

    python -m nerf_mae_torch.parallel.dryrun multichip 2
    python -m nerf_mae_torch.parallel.dryrun multihost --hosts 2 --local_ranks 2

Both run gloo ranks on the CPU at a tiny size (swin_nano, 32^3, float32).
multichip: one MAE train step on the global batch sharded over the ranks
(the replicas stay equal), an eval, a checkpoint round trip that reproduces
the eval's PSNR, a step on the patch-major input, and at n >= 4 (even) the
spatial leg (__graft_entry__.py:228-256): the same first step on an
(n/2 data x 2 space) mesh of the same ranks, its loss within 1e-3 of the
data-parallel one. multihost: "hosts x
local ranks" processes (LOCAL_RANK and GROUP_RANK as torchrun sets them on
each host) each run `run_mae_pretrain.main` for one step, and exactly rank 0
must have written the checkpoint. A worker that outlives its timeout is
killed, and a failure raises with every rank's output attached.
"""

from __future__ import annotations

import argparse
import importlib
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

WORKER_TIMEOUT_S = 600.0
MODULE = "nerf_mae_torch.parallel.dryrun"  # __name__ is __main__ under -m


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(text: str, lines: int = 40) -> str:
    return "\n".join(text.splitlines()[-lines:])


def launch(target: str, world: int, kwargs: Optional[Dict[str, Any]] = None, *,
           local_world: Optional[int] = None, timeout_s: float = WORKER_TIMEOUT_S,
           threads: int = 1) -> List[Any]:
    """Run `module:function`(**kwargs) in `world` new processes, rank r with
    torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK = r % local_world,
    LOCAL_WORLD_SIZE, GROUP_RANK = r // local_world, MASTER_ADDR / PORT)
    and torch.set_num_threads(threads). local_world defaults to the world
    (one host); local_world=1 gives every rank local rank 0 (ranks sharing
    one card). Returns each rank's return value (saved with torch.save), in
    rank order. Ranks are killed at timeout_s, and all are killed as soon as
    one fails; a failure raises with every rank's output attached."""
    local_world = local_world or world
    workdir = tempfile.mkdtemp(prefix="nerf_mae_ranks_")
    procs, logs = [], []
    try:
        torch.save({"target": target, "kwargs": kwargs or {}, "threads": threads},
                   os.path.join(workdir, "spec.pt"))
        path = [p or os.getcwd() for p in sys.path]  # the caller's imports resolve
        base = {**os.environ, "WORLD_SIZE": str(world), "LOCAL_WORLD_SIZE": str(local_world),
                "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
                "OMP_NUM_THREADS": str(threads), "PYTHONPATH": os.pathsep.join(path)}
        for rank in range(world):
            env = {**base, "RANK": str(rank), "LOCAL_RANK": str(rank % local_world),
                   "GROUP_RANK": str(rank // local_world)}
            logs.append(open(os.path.join(workdir, f"rank{rank}.log"), "w+"))
            procs.append(subprocess.Popen([sys.executable, "-m", MODULE, "worker", workdir],
                                          env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout_s
        timed_out = False
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break  # the others would wait for it in a collective
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.05)
        killed = [r for r, p in enumerate(procs) if p.poll() is None]
        for r in killed:
            procs[r].kill()
            procs[r].wait()
        outputs = []
        for f in logs:
            f.seek(0)
            outputs.append(f.read())
        failed = [r for r, p in enumerate(procs) if p.returncode != 0 and r not in killed]
        if failed or killed:
            why = (f"timed out after {timeout_s:.0f} s" if timed_out
                   else f"failed: ranks {failed}")
            report = "\n".join(
                f"--- rank {r} (rc {procs[r].returncode}"
                + (", killed" if r in killed else "") + f") ---\n{_tail(outputs[r])}"
                for r in range(world))
            raise RuntimeError(f"{target} on {world} ranks {why} (killed: {killed})\n{report}")
        return [torch.load(os.path.join(workdir, f"result{r}.pt"), weights_only=False)
                for r in range(world)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
        shutil.rmtree(workdir, ignore_errors=True)


def _worker(workdir: str) -> None:
    spec = torch.load(os.path.join(workdir, "spec.pt"), weights_only=False)
    torch.set_num_threads(spec["threads"])
    module, name = spec["target"].split(":")
    out = getattr(importlib.import_module(module), name)(**spec["kwargs"])
    torch.save(out, os.path.join(workdir, f"result{os.environ['RANK']}.pt"))


# ------------------------------------------------------------------ dry runs

def _tiny_mae(world: int):
    from nerf_mae_torch.config import MAEConfig, SwinConfig, TrainConfig

    cfg = MAEConfig(swin=SwinConfig(embed_dim=12, depths=(1, 1, 2, 1), num_heads=(3, 6, 12, 24)),
                    resolution=32, compute_dtype="float32", remat=False)
    return cfg, TrainConfig(batch_size=2 * world)


def _global_batch(n: int, patch: int = 0) -> Dict[str, np.ndarray]:
    from nerf_mae_torch.ops.patchify import patchify_np

    grids = np.random.RandomState(0).rand(n, 32, 32, 32, 4).astype(np.float32)
    return {"grids": patchify_np(grids, patch) if patch else grids,
            "sizes": np.full((n, 3), 32, np.int32)}


def multichip_rank(n: int, ckpt_dir: str) -> Dict[str, Any]:
    """One rank of dryrun_multichip (a launch target)."""
    from nerf_mae_torch.common import save_on_main
    from nerf_mae_torch.parallel import gather_objects, make_mesh, shard_batch
    from nerf_mae_torch.train.checkpoint import restore_checkpoint
    from nerf_mae_torch.train.trainer import MAETrainer

    with make_mesh(n, device="cpu") as mesh:
        cfg, tcfg = _tiny_mae(n)
        trainer = MAETrainer(cfg, tcfg, 10, mesh=mesh)
        state = trainer.init(0)
        batch = shard_batch(_global_batch(tcfg.batch_size), mesh)
        state, metrics = trainer.train_step(state, batch)
        flat = torch.cat([p.detach().reshape(-1) for p in state.model.parameters()])
        replicas = gather_objects(flat.numpy(), mesh)
        psnr = float(trainer.eval_step(state, batch)["psnr"])
        save_on_main(mesh, ckpt_dir, 1, state)
        state.model.load_state_dict(restore_checkpoint(ckpt_dir)["params"])
        psnr2 = float(trainer.eval_step(state, batch)["psnr"])
        pm = shard_batch(_global_batch(tcfg.batch_size, cfg.swin.patch_size[0]), mesh)
        _, pm_metrics = trainer.train_step(state, pm)
        out = {"loss": float(metrics["loss"]), "psnr": psnr, "psnr_restored": psnr2,
               "replicas_equal": all(np.array_equal(replicas[0], r) for r in replicas),
               "pm_loss": float(pm_metrics["loss"])}
        if n >= 4 and n % 2 == 0:  # the spatial leg, on the same ranks
            smesh = make_mesh(n, device="cpu", n_space=2)
            strainer = MAETrainer(cfg, tcfg, 10, mesh=smesh)
            _, smetrics = strainer.train_step(strainer.init(0),
                                              shard_batch(_global_batch(tcfg.batch_size), smesh))
            out["spatial_loss"] = float(smetrics["loss"])
        return out


def dryrun_multichip(n: int = 2) -> List[Dict]:
    """n gloo ranks: a train step, an eval, a checkpoint round trip, a
    patch-major step and at n >= 4 the spatial leg (module doc). Raises
    unless every leg holds on every rank; returns each rank's numbers."""
    ckpt = tempfile.mkdtemp(prefix="nerf_mae_dryrun_ckpt_")
    try:
        out = launch(f"{MODULE}:multichip_rank", n, {"n": n, "ckpt_dir": ckpt})
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    for r, o in enumerate(out):
        if not (np.isfinite(o["loss"]) and np.isfinite(o["psnr"]) and np.isfinite(o["pm_loss"])):
            raise RuntimeError(f"dryrun_multichip({n}): rank {r} not finite: {o}")
        if o["psnr_restored"] != o["psnr"]:
            raise RuntimeError(f"dryrun_multichip({n}): checkpoint round trip drifted: {o}")
        if not o["replicas_equal"]:
            raise RuntimeError(f"dryrun_multichip({n}): the replicas differ after a step")
        if o["loss"] != out[0]["loss"]:
            raise RuntimeError(f"dryrun_multichip({n}): the ranks' global losses differ")
        if "spatial_loss" in o and not (
                abs(o["spatial_loss"] - o["loss"]) < 1e-3 * max(abs(o["loss"]), 1.0)):
            raise RuntimeError(f"dryrun_multichip({n}): spatial ({n // 2}x2) loss "
                               f"{o['spatial_loss']} != data-parallel loss {o['loss']}")
    print(f"dryrun_multichip({n}): ok, loss {out[0]['loss']:.4f}, psnr {out[0]['psnr']:.4f}, "
          f"patch-major loss {out[0]['pm_loss']:.4f}"
          + (f", spatial ({n // 2}x2) loss {out[0]['spatial_loss']:.4f}"
             if "spatial_loss" in out[0] else ""), flush=True)
    return out


def multihost_rank(workdir: str, batch_size: int) -> Dict[str, Any]:
    """One rank of dryrun_multihost (a launch target): run_mae_pretrain.main
    for one step; each call of save_checkpoint leaves a marker naming its
    rank."""
    from nerf_mae_torch import common, run_mae_pretrain

    rank = int(os.environ["RANK"])
    save = common.save_checkpoint

    def marked(*a, **kw):
        open(os.path.join(workdir, f"ckpt_rank{rank}"), "w").close()
        return save(*a, **kw)

    common.save_checkpoint = marked
    out = run_mae_pretrain.main([
        "--mode", "train", "--dataset", "synthetic", "--backbone_type", "swin_nano",
        "--resolution", "32", "--batch_size", str(batch_size), "--n_synthetic",
        str(batch_size), "--steps", "1", "--compute_dtype", "float32", "--no_remat",
        "--device", "cpu", "--workers", "0", "--prefetch", "0", "--log_interval", "1",
        "--checkpoint_dir", os.path.join(workdir, "ckpt")])
    return {"rank": rank, "group_rank": int(os.environ["GROUP_RANK"]),
            "local_rank": int(os.environ["LOCAL_RANK"]), "loss": out["history"][0]["loss"]}


def dryrun_multihost(hosts: int = 2, local_ranks: int = 2) -> List[Dict]:
    """hosts x local_ranks gloo processes through run_mae_pretrain (module
    doc); raises unless every rank succeeds, all report the same loss, and
    exactly rank 0 wrote the checkpoint."""
    world = hosts * local_ranks
    workdir = tempfile.mkdtemp(prefix="nerf_mae_multihost_")
    try:
        out = launch(f"{MODULE}:multihost_rank", world,
                     {"workdir": workdir, "batch_size": world}, local_world=local_ranks)
        markers = sorted(f for f in os.listdir(workdir) if f.startswith("ckpt_rank"))
        steps = sorted(os.listdir(os.path.join(workdir, "ckpt")))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if markers != ["ckpt_rank0"] or steps != ["1"]:
        raise RuntimeError(f"expected exactly rank 0 to checkpoint step 1, got markers "
                           f"{markers}, steps {steps}")
    if len({o["loss"] for o in out}) != 1:
        raise RuntimeError(f"the ranks' global losses differ: {out}")
    print(f"dryrun_multihost({hosts}x{local_ranks}): ok, loss {out[0]['loss']:.4f}, "
          "checkpoint written by rank 0 only", flush=True)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    mc = sub.add_parser("multichip")
    mc.add_argument("n", type=int, nargs="?", default=2)
    mh = sub.add_parser("multihost")
    mh.add_argument("--hosts", type=int, default=2)
    mh.add_argument("--local_ranks", type=int, default=2)
    wk = sub.add_parser("worker")
    wk.add_argument("workdir")
    args = p.parse_args(argv)
    if args.cmd == "worker":
        _worker(args.workdir)
    elif args.cmd == "multichip":
        dryrun_multichip(args.n)
    else:
        dryrun_multihost(args.hosts, args.local_ranks)


if __name__ == "__main__":
    main()
