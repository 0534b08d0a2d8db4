"""The port's L0 CLI, `python -m nerf_mae_torch.run_nerf`, and its PNG
codec (nerf_mae_torch/nerf/images.py) on the CPU.

- The codec reads what Pillow writes bit for bit (8-bit RGB and RGBA,
  16-bit grayscale), decodes each of the five row filters, and Pillow reads
  what it writes.
- load_scene equals scripts/run_nerf.load_scene (rgb, poses, focal, depth
  in mm with invalid bands; --downscale and a depth map of another size go
  through Pillow in both).
- `--task extract` from parameters bridged from a JAX tree equals the JAX
  CLI's `--task extract` on the same scene and parameters: the same npz
  keys, dtypes and --ngp_frame metadata, the grid at rtol 2e-3 / atol 2e-4
  (the golden feature tolerance).
- `--task train_extract` writes those keys and dtypes, and its
  --params_out reloads to the same grid; extract without --params_out and
  --device cuda without a card raise clear errors.
"""

import json
import os
import pickle
import struct
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from nerf_mae_torch import run_nerf
from nerf_mae_torch.convert import nerf_params_from_jax
from nerf_mae_torch.nerf import images
from nerf_mae_tpu.nerf.model import NeRFMLP as JNeRFMLP

torch.set_num_threads(1)
SCRIPTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scripts")
GOLDEN = dict(rtol=2e-3, atol=2e-4)


def jax_run_nerf():
    sys.path.insert(0, SCRIPTS)
    import run_nerf as jrun

    return jrun


def pil_png(arr, path):
    Image.fromarray(arr).save(path)
    return path


@pytest.mark.parametrize("kind", ["rgb", "rgba", "gray16"])
def test_png_reads_what_pillow_writes(kind, tmp_path):
    rs = np.random.RandomState(0)
    shape = {"rgb": (9, 13, 3), "rgba": (9, 13, 4), "gray16": (9, 13)}[kind]
    if kind == "gray16":
        arr = rs.randint(0, 65536, shape).astype(np.uint16)
    else:  # a smooth ramp plus noise, so Pillow's adaptive filter picks several kinds
        base = np.add.outer(np.arange(9) * 9, np.arange(13) * 5)[..., None]
        arr = (base + rs.randint(0, 4, shape)).astype(np.uint8)
    path = pil_png(arr, tmp_path / "a.png")
    got = images.read_png(str(path))
    want = np.asarray(Image.open(path))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, arr)


def _filtered_png(arr: np.ndarray, kinds) -> bytes:
    """An 8-bit RGB PNG whose row y is written with filter kinds[y]."""
    h, w, c = arr.shape
    raw = bytearray()
    prev = np.zeros(w * c, np.int64)
    for y in range(h):
        row = arr[y].reshape(-1).astype(np.int64)
        left = np.concatenate([np.zeros(c, np.int64), row[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        k = kinds[y]
        if k == 0:
            f = row
        elif k == 1:
            f = row - left
        elif k == 2:
            f = row - prev
        elif k == 3:
            f = row - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
            f = row - pred
        raw.append(k)
        raw.extend((f % 256).astype(np.uint8).tobytes())
        prev = row

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


def test_png_decodes_all_five_row_filters(tmp_path):
    arr = np.random.RandomState(1).randint(0, 256, (10, 6, 3)).astype(np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_filtered_png(arr, [0, 1, 2, 3, 4, 4, 3, 2, 1, 0]))
    np.testing.assert_array_equal(np.asarray(Image.open(path)), arr)
    np.testing.assert_array_equal(images.read_png(str(path)), arr)


@pytest.mark.parametrize("dtype, shape", [(np.uint8, (7, 11, 3)), (np.uint8, (7, 11, 4)),
                                          (np.uint16, (7, 11))])
def test_pillow_reads_what_the_codec_writes(dtype, shape, tmp_path):
    arr = np.random.RandomState(2).randint(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    path = str(tmp_path / "w.png")
    images.write_png(path, arr)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), arr)
    np.testing.assert_array_equal(images.read_png(path), arr)
    with pytest.raises(ValueError):
        images.write_png(path, arr.astype(np.float32))


def write_scene(d, n=3, h=8, w=12, depth_hw=None, ngp=False):
    """n frames with 16-bit mm depth maps (rows 0-1 invalid), seeded poses."""
    rs = np.random.RandomState(3)
    os.makedirs(f"{d}/images", exist_ok=True)
    os.makedirs(f"{d}/depth", exist_ok=True)
    frames = []
    for i in range(n):
        pil_png((rs.rand(h, w, 3) * 255).astype(np.uint8), f"{d}/images/f{i}.png")
        dh, dw = depth_hw or (h, w)
        dep = rs.randint(800, 3000, (dh, dw)).astype(np.uint16)
        dep[:2] = 0  # invalid band
        pil_png(dep, f"{d}/depth/f{i}.png")
        ang = 2 * np.pi * i / n
        pose = np.eye(4)
        pose[:3, 3] = [2 * np.cos(ang), 2 * np.sin(ang), 0.3]
        frames.append({"file_path": f"images/f{i}.png", "transform_matrix": pose.tolist()})
    meta = {"camera_angle_x": 0.9, "frames": frames}
    if ngp:
        meta.update(room_bbox=[[-1.0, -0.8, -0.4], [1.0, 0.9, 0.6]], scale=0.6,
                    offset=[0.5, 0.4, 0.55])
    with open(f"{d}/transforms.json", "w") as f:
        json.dump(meta, f)
    return d


@pytest.mark.parametrize("case", ["same_size", "downscale_and_resample"])
def test_load_scene_matches_scripts(case, tmp_path):
    jrun = jax_run_nerf()
    d = write_scene(str(tmp_path), depth_hw=(16, 24) if case != "same_size" else None)
    down = 1 if case == "same_size" else 2
    got = run_nerf.load_scene(d, "transforms.json", down, depth_dir=f"{d}/depth")
    want = jrun.load_scene(d, "transforms.json", down, depth_dir=f"{d}/depth")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert np.asarray(g).dtype == np.asarray(w).dtype
    depths, valid = got[3], got[4]
    if down == 1:
        assert not valid[:, :2].any() and valid[:, 2:].all()
    assert depths.max() < 3.0 and depths[valid].min() >= 0.8  # mm -> m
    _, _, _, d0, v0 = run_nerf.load_scene(d, "transforms.json", 1)
    assert d0 is None and v0 is None


def _jax_params(n_views=3):
    m = JNeRFMLP()
    k1, k2 = jax.random.split(jax.random.PRNGKey(4))
    init = lambda k: m.init(k, jnp.zeros((1, 1, 3)), jnp.zeros((1, 1, 3)))["params"]
    return jax.device_get({"coarse": init(k1), "fine": init(k2)})


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def test_extract_matches_the_jax_cli(tmp_path, monkeypatch):
    """Bridged parameters, --ngp_frame, 8x256 at max_res 8 on a 3-view scene."""
    monkeypatch.setenv("NERF_MAE_NO_COMP_CACHE", "1")
    jrun = jax_run_nerf()
    d = write_scene(str(tmp_path / "scene"), ngp=True)
    jp = _jax_params()
    with open(tmp_path / "jax.pkl", "wb") as f:
        pickle.dump(jp, f)
    flags = ["--task", "extract", "--scene_dir", d, "--scene_id", "s", "--ngp_frame",
             "--max_res", "8"]
    jrun.main(flags + ["--params_out", str(tmp_path / "jax.pkl"), "--extract_dir",
                       str(tmp_path / "jax")])
    trainer = run_nerf.make_trainer(run_nerf.parse_args(flags), 1.0, torch.device("cpu"))
    params, _ = trainer.init(0, n_views=3)
    torch.save(nerf_params_from_jax(jp, params), tmp_path / "port.pt")
    out = run_nerf.main(flags + ["--params_out", str(tmp_path / "port.pt"), "--extract_dir",
                                 str(tmp_path / "port"), "--device", "cpu"])
    assert out["npz"] == str(tmp_path / "port" / "s.npz")
    got, want = _npz(tmp_path / "port" / "s.npz"), _npz(tmp_path / "jax" / "s.npz")
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        if k == "rgbsigma":
            np.testing.assert_allclose(got[k], want[k], **GOLDEN)
        else:
            np.testing.assert_array_equal(got[k], want[k])
    assert list(got["resolution"]) == [8, 7, 4]
    np.testing.assert_allclose(got["bbox_min"], (np.array([-1.0, -0.8, -0.4], np.float32)
                                                 * 0.6 + [0.5, 0.4, 0.55])[[1, 2, 0]])


def test_train_extract_writes_the_jax_keys_and_reloads(tmp_path):
    d = write_scene(str(tmp_path / "scene"), ngp=True)
    flags = ["--scene_dir", d, "--scene_id", "s", "--ngp_frame", "--max_res", "6",
             "--steps", "2", "--ray_batch", "32", "--n_samples", "8", "--n_importance", "4",
             "--depth_dir", f"{d}/depth", "--device", "cpu", "--params_out",
             str(tmp_path / "p.pt")]
    out = run_nerf.main(["--task", "train_extract", "--extract_dir", str(tmp_path / "a")]
                        + flags)
    assert np.isfinite(out["psnr"])
    got = _npz(tmp_path / "a" / "s.npz")
    assert set(got) == {"rgbsigma", "resolution", "bbox_min", "bbox_max", "scale", "offset",
                        "from_mitsuba"}
    dtypes = {k: v.dtype.kind for k, v in got.items()}
    assert dtypes == {"rgbsigma": "f", "resolution": "i", "bbox_min": "f", "bbox_max": "f",
                      "scale": "f", "offset": "f", "from_mitsuba": "b"}
    assert got["rgbsigma"].dtype == np.float32 and got["bbox_min"].dtype == np.float64
    assert got["rgbsigma"].shape == (6, 5, 3, 4) and np.isfinite(got["rgbsigma"]).all()
    run_nerf.main(["--task", "extract", "--extract_dir", str(tmp_path / "b")] + flags)
    np.testing.assert_array_equal(_npz(tmp_path / "b" / "s.npz")["rgbsigma"], got["rgbsigma"])


def test_extract_without_params_and_cuda_without_a_card_raise(tmp_path):
    d = write_scene(str(tmp_path))
    with pytest.raises(SystemExit, match="--params_out"):
        run_nerf.main(["--task", "extract", "--scene_dir", d, "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            run_nerf.main(["--task", "train", "--scene_dir", d, "--steps", "1"])
    assert run_nerf.parse_args(["--scene_dir", d]).device == "cuda"
