"""The port's device-resident corpus (nerf_mae_torch/data/device_cache.py)
on the CPU device, mirroring tests/test_device_cache.py: batches equal to
the JAX package's device_corpus_batches on a 1-device CPU mesh and to the
host iterator, the tail dropped or padded, the grid-only cast, channel-flat
patch-major storage, and the trainer stepping on the gathered batches."""

import numpy as np
import pytest
import torch

from nerf_mae_tpu.data import device_cache as jcache
from nerf_mae_tpu.parallel import make_mesh
from nerf_mae_torch.config import SWIN_PRESETS, MAEConfig, TrainConfig
from nerf_mae_torch.data import mae_batch_iterator, synthetic_scenes
from nerf_mae_torch.data.device_cache import (
    corpus_from_iterator,
    corpus_nbytes,
    device_corpus_batches,
)
from nerf_mae_torch.train.trainer import MAETrainer

torch.set_num_threads(1)
CPU = torch.device("cpu")


class _DS:
    def __init__(self, scenes):
        self.scenes = scenes

    def __len__(self):
        return len(self.scenes)

    def __getitem__(self, i):
        return {"rgbsigma": self.scenes[i]}


def _dataset(n=10, r=8, seed=0):
    return _DS(synthetic_scenes(n, r, seed, min_size=r))


def _corpus(ds, r=8, **kw):
    return corpus_from_iterator(mae_batch_iterator(ds, 4, r, shuffle=False, loop=False,
                                                   drop_last=False, **kw))


def test_corpus_from_iterator_concatenates_ragged_epoch():
    ds = _dataset(n=10)
    corpus = _corpus(ds)
    assert corpus["grids"].shape == (10, 8, 8, 8, 4)  # batches of 4, 4, 2
    assert corpus["sizes"].shape == (10, 3)
    np.testing.assert_array_equal(corpus["grids"][9, ..., 0], ds[9]["rgbsigma"][..., 0])


def test_corpus_from_iterator_empty_raises():
    with pytest.raises(ValueError, match="empty"):
        corpus_from_iterator(iter([]))


@pytest.mark.parametrize("dtype,itemsize", [(None, 4), ("float32", 4), ("bfloat16", 2),
                                            ("float16", 2)])
def test_corpus_nbytes_counts_grid_downcast(dtype, itemsize):
    corpus = {"grids": np.zeros((4, 8, 8, 8, 4), np.float32),
              "gt": np.zeros((4, 16, 6), np.float32),  # metadata: stays float32
              "sizes": np.zeros((4, 3), np.int32)}
    want = 4 * 512 * 4 * itemsize + 4 * 16 * 6 * 4 + 4 * 3 * 4
    assert corpus_nbytes(corpus, dtype) == want == jcache.corpus_nbytes(corpus, dtype)


def test_batches_equal_jaxs_device_corpus_batch_by_batch():
    """The epoch permutations of the JAX package's device cache on a
    1-device CPU mesh, across epoch boundaries (9 scenes, batch 4)."""
    corpus = _corpus(_dataset(n=9))
    ours = device_corpus_batches(corpus, CPU, 4, seed=3)
    theirs = jcache.device_corpus_batches(corpus, make_mesh(1), 4, seed=3)
    for _ in range(7):
        a, b = next(ours), next(theirs)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))


def test_gather_matches_host_iterator_exactly():
    ds = _dataset(n=9)
    dev = device_corpus_batches(_corpus(ds), CPU, 4, seed=3)
    host = mae_batch_iterator(ds, 4, 8, shuffle=True, seed=3)
    for _ in range(5):
        db, hb = next(dev), next(host)
        np.testing.assert_array_equal(db["grids"].numpy(), hb["grids"])
        np.testing.assert_array_equal(db["sizes"].numpy(), hb["sizes"])


def test_one_epoch_tail_padding_and_coverage():
    corpus = _corpus(_dataset(n=6))
    out = list(device_corpus_batches(corpus, CPU, 4, shuffle=False, loop=False,
                                     drop_last=False))
    assert len(out) == 2
    tail = out[1]["grids"].numpy()  # [4, 5] padded by repeating index 4
    for i, j in enumerate((4, 5, 4, 4)):
        np.testing.assert_array_equal(tail[i], corpus["grids"][j])


def test_one_epoch_tail_dropped():
    out = list(device_corpus_batches(_corpus(_dataset(n=6)), CPU, 4, shuffle=False,
                                     loop=False))
    assert len(out) == 1 and out[0]["grids"].shape[0] == 4


def test_transfer_dtype_downcasts_grids_only():
    corpus = {"grids": np.random.rand(4, 8, 8, 8, 4).astype(np.float32),
              "gt_boxes": np.random.rand(4, 16, 6).astype(np.float32),
              "sizes": np.full((4, 3), 8, np.int32)}
    b = next(device_corpus_batches(corpus, CPU, 2, transfer_dtype="bfloat16"))
    j = next(jcache.device_corpus_batches(corpus, make_mesh(1), 2, transfer_dtype="bfloat16"))
    assert b["grids"].dtype == torch.bfloat16
    assert b["gt_boxes"].dtype == torch.float32  # ndim < 4: metadata kept float32
    assert b["sizes"].dtype == torch.int32
    # torch's round-to-nearest-even equals ml_dtypes'
    np.testing.assert_array_equal(b["grids"].float().numpy(), np.asarray(j["grids"], np.float32))


def test_batch_size_larger_than_corpus_raises():
    with pytest.raises(ValueError, match="corpus size"):
        next(device_corpus_batches({"grids": np.zeros((2, 8, 8, 8, 4), np.float32)}, CPU, 4))


def test_patch_major_corpus_is_stored_channel_flat():
    ds = _dataset(n=8, r=8)
    host = list(mae_batch_iterator(ds, 8, 8, shuffle=False, loop=False, drop_last=False,
                                   patch_major=4))
    corpus = corpus_from_iterator(iter(host))
    assert corpus["grids"].shape == (8, 2, 2, 2, 64, 4)
    b = next(device_corpus_batches(corpus, CPU, 8, shuffle=False))
    j = next(jcache.device_corpus_batches(corpus, make_mesh(1), 8, shuffle=False))
    assert b["grids"].shape == (8, 2, 2, 2, 256) == j["grids"].shape
    np.testing.assert_array_equal(b["grids"].numpy().reshape(8, 2, 2, 2, 64, 4),
                                  host[0]["grids"])


@pytest.mark.parametrize("patch_major", [0, 4])
def test_mae_train_step_consumes_device_batches(patch_major):
    """The trainer steps on gathered batches, voxel grids or channel-flat
    patch-major, with the losses of the host batches."""
    cfg = MAEConfig(swin=SWIN_PRESETS["swin_nano"], resolution=32, compute_dtype="float32",
                    remat=False)
    ds = _DS(synthetic_scenes(4, 32, 0, min_size=20))
    corpus = corpus_from_iterator(mae_batch_iterator(ds, 2, 32, shuffle=False, loop=False,
                                                     drop_last=False, patch_major=patch_major))
    dev = device_corpus_batches(corpus, CPU, 2)
    host = mae_batch_iterator(ds, 2, 32, patch_major=patch_major)
    losses = []
    for batches in (dev, host):
        trainer = MAETrainer(cfg, TrainConfig(batch_size=2, lr=1e-3), 4, CPU)
        state = trainer.init(0)
        run = []
        for _ in range(2):
            b = next(batches)
            b = b if isinstance(b["grids"], torch.Tensor) else {
                k: torch.from_numpy(v) for k, v in b.items()}
            state, m = trainer.train_step(state, b)
            run.append(float(m["loss"]))
        losses.append(run)
    assert all(np.isfinite(losses[0])) and losses[0] == losses[1]
