"""The port's training feed on the CPU: the prefetch thread and the scene
pool (mirroring tests/test_pipeline.py), the batch iterators and datasets
bitwise against the JAX package's on the same seeded inputs, the
host-to-device transfer, and the drivers' feeds (--workers, --prefetch,
--device_data, --transfer_dtype, --synthetic_hard, --log_dir, --wandb,
--profile_dir)."""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from nerf_mae_tpu.data import datasets as jdata
from nerf_mae_torch import common, run_fcos, run_mae_pretrain
from nerf_mae_torch.data import (
    ConcatDataset,
    GeneralDataset,
    PrefetchIterator,
    SceneDataset,
    ScenePool,
    datasets,
    prefetch,
    split_hypersim_dataset,
)

torch.set_num_threads(1)


class _ListDS:
    def __init__(self, scenes):
        self.scenes = scenes

    def __len__(self):
        return len(self.scenes)

    def __getitem__(self, i):
        s = self.scenes[i]
        return dict(s) if isinstance(s, dict) else {"rgbsigma": s}


def _equal_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


# -- the prefetch thread and the scene pool (tests/test_pipeline.py) ------

def test_prefetch_preserves_order_and_values():
    src = [{"x": np.full((4,), i, np.float32)} for i in range(20)]
    got = list(prefetch(iter(src), depth=3))
    assert len(got) == 20
    for i, b in enumerate(got):
        np.testing.assert_array_equal(b["x"], src[i]["x"])


def test_prefetch_map_fn_runs_on_background_thread():
    main = threading.get_ident()
    tids = []

    def mark(x):
        tids.append(threading.get_ident())
        return x * 2

    assert list(prefetch(iter([1, 2, 3]), depth=2, map_fn=mark)) == [2, 4, 6]
    assert tids and all(t != main for t in tids)


def test_prefetch_propagates_source_exception():
    def bad():
        yield 1
        raise ValueError("boom")

    it = prefetch(bad(), depth=2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom"):
        for _ in it:
            pass
    assert not it._thread.is_alive()


def test_prefetch_propagates_map_fn_exception():
    def bad(x):
        raise KeyError("map")

    it = prefetch(iter([1, 2]), depth=1, map_fn=bad)
    with pytest.raises(KeyError, match="map"):
        next(it)


def test_prefetch_close_stops_producer_promptly():
    produced = []

    def slow():
        for i in range(10_000):
            produced.append(i)
            yield i

    it = prefetch(slow(), depth=2)
    next(it)
    it.close()
    n = len(produced)
    time.sleep(0.2)
    assert len(produced) <= n + 2  # within one queue slot of the close
    assert not it._thread.is_alive()
    with pytest.raises(StopIteration):
        next(it)


def test_prefetch_context_manager_stops_the_thread():
    with prefetch(iter(range(5)), depth=1) as it:
        assert next(it) == 0
    it._thread.join(timeout=5)
    assert not it._thread.is_alive()
    with pytest.raises(StopIteration):
        next(it)


@pytest.mark.parametrize("depth", [0, -1])
def test_prefetch_depth_validation(depth):
    with pytest.raises(ValueError, match=">= 1"):
        PrefetchIterator(iter([]), depth=depth)


def test_prefetch_bounds_the_queue():
    produced = []

    def src():
        for i in range(100):
            produced.append(i)
            yield i

    it = prefetch(src(), depth=2)
    time.sleep(0.3)
    assert len(produced) <= 2 + 1  # the queue's two plus the one in hand
    it.close()


def test_scene_pool_keeps_order_under_contention():
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        pool = ScenePool(16)  # more workers than cores
        items = list(range(200))
        got = pool.map(lambda x: (time.sleep(0.0005 * (x % 3)), x * x)[1], items)
        pool.close()
    finally:
        sys.setswitchinterval(switch)
    assert got == [x * x for x in items]


def test_scene_pool_inline_and_closed_threads():
    assert ScenePool(0).map(lambda x: x + 1, [1, 2]) == [2, 3]
    pool = ScenePool(2)
    pool.map(lambda x: x, range(4))
    pool.close()
    assert all(not t.is_alive() for t in pool._pool._threads)


# -- the batch iterators against JAX's --------------------------------------

@pytest.mark.parametrize("workers", [0, 3])
@pytest.mark.parametrize("patch_major", [0, 4])
def test_mae_iterator_matches_jax(workers, patch_major):
    scenes = datasets.synthetic_scenes(7, 32, seed=3, min_size=20)
    ours = list(datasets.mae_batch_iterator(_ListDS(scenes), 2, 32, seed=5, loop=False,
                                            workers=workers, patch_major=patch_major))
    theirs = list(jdata.mae_batch_iterator(_ListDS(scenes), 2, 32, seed=5, loop=False,
                                           workers=0, patch_major=patch_major))
    assert len(ours) == 3  # the ragged tail dropped
    _equal_batches(ours, theirs)


@pytest.mark.parametrize("workers", [0, 3])
@pytest.mark.parametrize("obb", [False, True])
def test_detection_iterator_matches_jax(workers, obb):
    scenes = datasets.synthetic_detection_scenes(6, 32, seed=3, obb=obb, hard=True)
    kw = dict(max_gt=8, seed=2, loop=False, drop_last=False)
    ours = list(datasets.detection_batch_iterator(_ListDS(scenes), 4, 32, workers=workers, **kw))
    theirs = list(jdata.detection_batch_iterator(_ListDS(scenes), 4, 32, workers=0, **kw))
    assert len(ours) == 2
    _equal_batches(ours, theirs)


@pytest.fixture()
def disk_scenes(tmp_path):
    """5 scenes with OBB boxes on disk, and a csv over them."""
    feats, boxes = tmp_path / "features", tmp_path / "boxes"
    feats.mkdir()
    boxes.mkdir()
    rows = ["scene,rgbsigma_path,boxes_path"]
    for i, s in enumerate(datasets.synthetic_detection_scenes(5, 24, seed=9, obb=True)):
        g = s["rgbsigma"].copy()
        g[..., 3] = np.random.RandomState(i).randn(*g.shape[:3]) * 2  # raw density
        np.savez(feats / f"s{i}.npz", rgbsigma=g)
        np.save(boxes / f"s{i}.npy", s["boxes"])
        rows.append(f"s{i},{feats / f's{i}.npz'},{boxes / f's{i}.npy' if i % 2 else 'None'}")
    (tmp_path / "scenes.csv").write_text("\n".join(rows) + "\n")
    return tmp_path


AUG = dict(flip_prob=0.5, rotate_prob=0.5, rot_scale_prob=0.5)


@pytest.mark.parametrize("kind", ["mae", "detection"])
def test_augmented_iterators_draw_in_scene_order(disk_scenes, kind):
    """With augments, workers=3 gives exactly workers=0's batches, which are
    JAX's serial ones (JAX's own iterators draw inside the pool's threads,
    so under workers > 0 theirs follow thread scheduling)."""
    def batches(module, workers):
        ds = module.SceneDataset(str(disk_scenes / "features"),
                                 boxes_path=str(disk_scenes / "boxes"), seed=4, **AUG)
        if kind == "mae":
            it = module.mae_batch_iterator(ds, 2, 24, seed=1, workers=workers)
        else:
            it = module.detection_batch_iterator(ds, 2, 24, max_gt=16, seed=1,
                                                 workers=workers)
        out = [next(it) for _ in range(6)]  # three epochs of fresh draws
        it.close()
        return out

    serial = batches(datasets, 0)
    _equal_batches(batches(datasets, 3), serial)
    _equal_batches(serial, batches(jdata, 0))


def test_augment_draws_follow_scene_order_with_slow_loads(disk_scenes, monkeypatch):
    """The draws do not depend on which worker finishes first: scene 0's
    load is made the slowest. The JAX iterator under the same delay draws
    scene 0's augments last, so its workers=4 batch differs from its
    serial one (the fault the port does not copy)."""
    ds = SceneDataset(str(disk_scenes / "features"), boxes_path=str(disk_scenes / "boxes"),
                      seed=4, **AUG)
    load = ds.load_item

    def slow_first(i):
        if i == 0:
            time.sleep(0.05)
        return load(i)

    monkeypatch.setattr(ds, "load_item", slow_first)
    got = list(datasets.detection_batch_iterator(ds, 5, 24, max_gt=16, shuffle=False,
                                                 loop=False, workers=4))
    ref = jdata.SceneDataset(str(disk_scenes / "features"),
                             boxes_path=str(disk_scenes / "boxes"), seed=4, **AUG)
    want = list(jdata.detection_batch_iterator(ref, 5, 24, max_gt=16, shuffle=False,
                                               loop=False, workers=0))
    _equal_batches(got, want)

    jds = jdata.SceneDataset(str(disk_scenes / "features"),
                             boxes_path=str(disk_scenes / "boxes"), seed=4, **AUG)
    jload = jds._load

    def jslow_first(scene):
        if scene == "s0":
            time.sleep(0.05)
        return jload(scene)

    monkeypatch.setattr(jds, "_load", jslow_first)
    jax_threads = list(jdata.detection_batch_iterator(jds, 5, 24, max_gt=16, shuffle=False,
                                                      loop=False, workers=4))
    assert not all(np.array_equal(a[k], b[k]) for a, b in zip(jax_threads, want) for k in a)


# -- the datasets against JAX's ---------------------------------------------

def test_general_dataset_matches_jax(disk_scenes):
    ours, theirs = (m.GeneralDataset(str(disk_scenes / "scenes.csv")) for m in (datasets, jdata))
    assert ours.scenes == theirs.scenes and len(ours) == len(theirs) == 5
    for i in range(5):
        a, b = ours[i], theirs[i]
        assert set(a) == set(b) and ("boxes" in a) == bool(i % 2)
        for k in a:
            if k == "scene":
                assert a[k] == b[k]
            else:
                np.testing.assert_array_equal(a[k], b[k])


def test_concat_dataset_matches_jax(disk_scenes):
    feats = str(disk_scenes / "features")
    parts = lambda m: (m.SceneDataset(feats, scene_list=["s0", "s1"]), None,
                       m.GeneralDataset(str(disk_scenes / "scenes.csv")))
    ours, theirs = ConcatDataset(*parts(datasets)), jdata.ConcatDataset(*parts(jdata))
    assert len(ours) == len(theirs) == 7
    for i in range(7):
        np.testing.assert_array_equal(ours[i]["rgbsigma"], theirs[i]["rgbsigma"])
    assert not ours.augmented
    aug = ConcatDataset(SceneDataset(feats, boxes_path=str(disk_scenes / "boxes"), seed=2,
                                     **AUG), GeneralDataset(str(disk_scenes / "scenes.csv")))
    ref = jdata.ConcatDataset(jdata.SceneDataset(feats, boxes_path=str(disk_scenes / "boxes"),
                                                 seed=2, **AUG),
                              jdata.GeneralDataset(str(disk_scenes / "scenes.csv")))
    assert aug.augmented
    got = list(datasets.detection_batch_iterator(aug, 5, 24, max_gt=16, seed=3, loop=False,
                                                 workers=3))
    want = list(jdata.detection_batch_iterator(ref, 5, 24, max_gt=16, seed=3, loop=False))
    _equal_batches(got, want)


def test_split_hypersim_dataset_matches_jax(tmp_path):
    scenes = [f"ai_{i:03d}" for i in range(17)]
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    ours = np.load(split_hypersim_dataset(scenes, 0.6, 0.2, str(tmp_path / "a"), seed=3))
    theirs = np.load(jdata.split_hypersim_dataset(scenes, 0.6, 0.2, str(tmp_path / "b"), seed=3))
    for k in ("train_scenes", "val_scenes", "test_scenes"):
        np.testing.assert_array_equal(ours[k], theirs[k])
    assert len(ours["train_scenes"]) == 10
    with pytest.raises(ValueError):
        split_hypersim_dataset(scenes, 0.9, 0.2, str(tmp_path / "a"))


# -- the transfer -------------------------------------------------------------

def test_transfer_flattens_patches_and_casts_grids_only():
    """shard_batch's transfer half: patch-major leaves channel-flat, float32
    leaves with ndim >= 4 cast, boxes and sizes untouched."""
    batch = {"grids": np.random.rand(2, 2, 2, 2, 64, 4).astype(np.float32),
             "out_grids": np.random.rand(2, 8, 8, 8, 4).astype(np.float32),
             "gt_boxes": np.random.rand(2, 3, 7).astype(np.float32),
             "sizes": np.full((2, 3), 8, np.int32), "gt_valid": np.ones((2, 3), bool)}
    put = common.HostToDevice(torch.device("cpu"), "bfloat16")
    out = put.ready(put(batch))
    assert out["grids"].shape == (2, 2, 2, 2, 256) and out["grids"].dtype == torch.bfloat16
    assert out["out_grids"].dtype == torch.bfloat16
    assert out["gt_boxes"].dtype == torch.float32 and out["sizes"].dtype == torch.int32
    assert out["gt_valid"].dtype == torch.bool
    want = torch.from_numpy(batch["grids"]).to(torch.bfloat16).reshape(2, 2, 2, 2, 256)
    assert torch.equal(out["grids"], want)
    plain = common.HostToDevice(torch.device("cpu"))(batch)[0]
    assert plain["grids"].dtype == torch.float32
    np.testing.assert_array_equal(plain["grids"].numpy().reshape(batch["grids"].shape),
                                  batch["grids"])


@pytest.mark.parametrize("depth", [0, 2])
def test_overlap_batches_closes_its_thread(depth):
    src = ({"grids": np.full((1, 2, 2, 2, 4), i, np.float32)} for i in range(50))
    it = common.overlap_batches(src, torch.device("cpu"), depth)
    assert float(next(it)["grids"][0, 0, 0, 0, 0]) == 0
    assert float(next(it)["grids"][0, 0, 0, 0, 0]) == 1
    before = threading.active_count()
    it.close()
    time.sleep(0.05)
    assert threading.active_count() <= before


def test_device_data_refuses_host_augments():
    args = type("A", (), dict(device_data=True, flip_prob=0.5, rotate_prob=0.0,
                              rot_scale_prob=0.25, batch_size=2, seed=0, prefetch=0,
                              transfer_dtype="float32"))()
    with pytest.raises(SystemExit, match="augmentation is incompatible .*--flip_prob, "
                                         "--rot_scale_prob"):
        common.make_train_batches(args, torch.device("cpu"), lambda: iter([]))


# -- the drivers ---------------------------------------------------------------

MAE = ["--mode", "train", "--dataset", "synthetic", "--backbone_type", "swin_nano",
       "--resolution", "32", "--batch_size", "2", "--steps", "5", "--compute_dtype",
       "float32", "--device", "cpu", "--log_interval", "1", "--n_synthetic", "5",
       "--eval_interval", "100000", "--ckpt_interval", "100000"]


def _losses(tmp_path, tag, *flags):
    out = run_mae_pretrain.main([*MAE, "--checkpoint_dir", str(tmp_path / tag), *flags])
    return [h["loss"] for h in out["history"]]


def test_mae_feeds_give_bitwise_equal_losses(tmp_path):
    """Inline, the pipeline and the float32 device corpus feed the same
    scenes in the same order (5 scenes at batch 2: the epoch's tail dropped
    and reshuffled); bf16 transfer matches between host and device."""
    inline = _losses(tmp_path, "a", "--prefetch", "0", "--workers", "0")
    assert len(inline) == 5 and all(np.isfinite(inline))
    assert _losses(tmp_path, "b", "--prefetch", "2", "--workers", "2") == inline
    assert _losses(tmp_path, "c", "--device_data") == inline
    dev16 = _losses(tmp_path, "d", "--device_data", "--transfer_dtype", "bfloat16")
    assert _losses(tmp_path, "e", "--transfer_dtype", "bfloat16", "--prefetch", "1") == dev16
    assert dev16 != inline
    np.testing.assert_allclose(dev16, inline, rtol=2e-2)


def test_synthetic_hard_pretrains_on_jaxs_hard_grids():
    args = run_mae_pretrain.parse_args([*MAE, "--synthetic_hard", "--n_synthetic", "3",
                                        "--n_synthetic_val", "2"])
    train, val = run_mae_pretrain.build_datasets(args)
    for ds, n, seed in ((train, 3, 0), (val, 2, 10_000)):
        want = jdata.synthetic_detection_scenes(n, 32, seed, hard=True)
        assert len(ds) == n
        for i in range(n):
            np.testing.assert_array_equal(ds[i]["rgbsigma"], want[i]["rgbsigma"])
    plain = run_mae_pretrain.build_datasets(run_mae_pretrain.parse_args(MAE))[0]
    np.testing.assert_array_equal(plain[0]["rgbsigma"], jdata.synthetic_scenes(5, 32, 0)[0])


def test_log_dir_wandb_and_profile_dir(tmp_path, monkeypatch, caplog):
    """--log_dir writes jsonl; --wandb without wandb warns and goes on;
    --profile_dir writes a chrome trace of the first --log_interval steps
    and, beside it, the table of their spans."""
    monkeypatch.setitem(sys.modules, "wandb", None)  # not importable
    with caplog.at_level("WARNING"):
        out = run_mae_pretrain.main([*MAE, "--steps", "2", "--log_interval", "2",
                                     "--checkpoint_dir", str(tmp_path / "ck"),
                                     "--log_dir", str(tmp_path / "logs"), "--wandb",
                                     "--profile_dir", str(tmp_path / "prof")])
    assert out["steps"] == 2
    assert "wandb requested but not installed" in caplog.text
    lines = (tmp_path / "logs" / "metrics_mae_swin_nano.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [2]
    traces = [p for p in (tmp_path / "prof").glob("train_*.json")
              if not p.name.endswith(".spans.json")]
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    # beside it, the port's span table of the same steps
    spans = json.loads(traces[0].with_suffix(".spans.json").read_text())
    assert spans["steps"] == 2


def test_benchmark_profile_dir_traces_the_timed_steps(tmp_path):
    out = run_mae_pretrain.main([*MAE, "--mode", "benchmark", "--profile_dir",
                                 str(tmp_path / "prof"), "--prefetch", "1"])
    assert np.isfinite(out["loss"])
    traces = list((tmp_path / "prof").glob("mae_train_step_*.json"))
    assert sorted(p.name.endswith(".spans.json") for p in traces) == [False, True]


def test_fcos_trains_from_the_device_corpus(tmp_path):
    """run_fcos with --device_data --transfer_dtype bfloat16: the corpus
    pass holds every scene once; the step takes bf16 grids and float32
    boxes; the same scenes as the host feed."""
    base = ["--mode", "train", "--dataset", "synthetic", "--backbone_type", "swin_nano",
            "--resolution", "32", "--batch_size", "2", "--steps", "2", "--compute_dtype",
            "float32", "--device", "cpu", "--log_interval", "1", "--n_synthetic", "3",
            "--synthetic_hard", "--rotated_bbox", "--pre_nms_top_n", "64",
            "--fpn_post_nms_top_n", "32", "--eval_interval", "100000",
            "--ckpt_interval", "100000"]
    dev = run_fcos.main([*base, "--device_data", "--checkpoint_dir", str(tmp_path / "a")])
    host = run_fcos.main([*base, "--prefetch", "0", "--workers", "0",
                          "--checkpoint_dir", str(tmp_path / "b")])
    assert [h["loss"] for h in dev["history"]] == [h["loss"] for h in host["history"]]
    bf16 = run_fcos.main([*base, "--device_data", "--transfer_dtype", "bfloat16",
                          "--checkpoint_dir", str(tmp_path / "c")])
    assert all(np.isfinite(h["loss"]) for h in bf16["history"])
    args = run_fcos.parse_args([*base, "--flip_prob", "0.5", "--device_data",
                                "--dataset", "front3d", "--features_path", str(tmp_path)])
    with pytest.raises(SystemExit, match="--flip_prob"):
        common.make_train_batches(args, torch.device("cpu"), lambda: iter([]))
