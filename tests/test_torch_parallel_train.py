"""Data parallelism of the port's six trainers on the CPU: two gloo ranks
against one process on the joined batch (tests/test_torch_parallel_jax.py
holds the MAE step against JAX).

- Each trainer (MAE two steps, SR, semantics, FCOS, RPN, RCNN one step) on
  2 ranks from the same seed: every step's loss within rel 1e-5 of one
  process on the joined batch, the parameters after within rtol 1e-4 /
  atol 1e-5 (tests/test_train.py:116-135, JAX's own sharded-vs-single
  check), the replicas bitwise equal. The batch's halves give the losses
  different counts (n_rgb, the semantic weight sum, num_pos, the sampled
  anchors, the valid RoIs), and the test asserts that they do: a loss
  that averaged per-rank means would fail it.
- The evals through the drivers: MAE PSNR, semantics mIoU and FCOS AP /
  recall over 2 ranks equal one process's.
"""

import numpy as np
import pytest
import torch

from nerf_mae_torch import run_fcos, run_mae_pretrain, run_voxel_semantics
from nerf_mae_torch.parallel import dryrun, make_mesh

import test_torch_parallel as cases

torch.set_num_threads(1)

MODULE = "test_torch_parallel_train"  # the ranks import this module by name


@pytest.fixture(scope="module")
def two_ranks():
    """Every kind's steps on 2 gloo ranks, in one launch."""
    return dryrun.launch(f"{cases.MODULE}:rank_steps", 2, {"kinds": cases.KINDS})


@pytest.mark.parametrize("kind", cases.KINDS)
def test_two_ranks_equal_one_process_on_the_joined_batch(two_ranks, kind):
    want = cases.run_steps(kind)
    r0, r1 = two_ranks[0][kind], two_ranks[1][kind]
    # the ranks' denominators differ: the first count_sum of a step is the
    # loss's (n_rgb, the weight sum, num_pos, sampled anchors, valid RoIs)
    assert r0["counts"] and (r0["counts"][0] != r1["counts"][0]).all()
    for step, (got, ref) in enumerate(zip(r0["metrics"], want["metrics"])):
        assert got.keys() == ref.keys()
        assert got == r1["metrics"][step]  # every rank holds the global metrics
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5, err_msg=f"step {step}")
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {step} {k}")
    for name, p in want["params"].items():
        np.testing.assert_array_equal(r0["params"][name], r1["params"][name], err_msg=name)
        np.testing.assert_allclose(r0["params"][name], p, rtol=1e-4, atol=1e-5, err_msg=name)


# ------------------------------------------------------------------ evals

TINY = ["--dataset", "synthetic", "--backbone_type", "swin_nano", "--resolution", "32",
        "--batch_size", "2", "--n_synthetic", "4", "--n_synthetic_val", "4",
        "--compute_dtype", "float32", "--device", "cpu", "--workers", "0", "--prefetch", "0",
        "--log_interval", "1", "--seed", "3"]
EVALS = {
    "mae": (run_mae_pretrain, []),
    "semantics": (run_voxel_semantics, ["--num_classes", "5"]),
    "fcos": (run_fcos, ["--max_gt", "8", "--pre_nms_top_n", "60",
                        "--fpn_post_nms_top_n", "40"]),
}


def eval_rank(ckpts):
    """A launch target: each driver's --mode eval on 2 ranks of one group."""
    with make_mesh(2, device="cpu"):
        return {kind: module.main(["--mode", "eval", *TINY, *extra, "--checkpoint", ckpts[kind]])
                for kind, (module, extra) in EVALS.items()}


@pytest.fixture(scope="module")
def evals(tmp_path_factory):
    """One train step of each driver, then its eval in one process and on
    2 ranks."""
    ckpts, one = {}, {}
    for kind, (module, extra) in EVALS.items():
        ckpts[kind] = str(tmp_path_factory.mktemp(kind))
        module.main(["--mode", "train", *TINY, *extra, "--steps", "1",
                     "--checkpoint_dir", ckpts[kind]])
        one[kind] = module.main(["--mode", "eval", *TINY, *extra, "--checkpoint", ckpts[kind]])
    return one, dryrun.launch(f"{MODULE}:eval_rank", 2, {"ckpts": ckpts})


@pytest.mark.parametrize("kind,keys", [("mae", ("psnr", "mse", "loss")),
                                       ("semantics", ("mIoU", "mAcc", "allAcc", "loss")),
                                       ("fcos", ("ap25", "ap50", "recall25_top300"))])
def test_evals_over_two_ranks_equal_one_process(evals, kind, keys):
    one, ranks = evals
    assert one[kind] and set(keys) <= set(one[kind])
    for r in ranks:
        assert r[kind].keys() == one[kind].keys()
        for k in one[kind]:
            np.testing.assert_allclose(r[kind][k], one[kind][k], rtol=1e-5, atol=1e-7,
                                       err_msg=f"{kind} {k}")
