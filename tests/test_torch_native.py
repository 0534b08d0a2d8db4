"""The port's native collate (nerf_mae_torch/data/native.py, its own copy
csrc/collate.cpp) against its numpy paths and the JAX package's native
module, on the same grids: every function equal (rotate_scale within the
JAX test's float32-position tolerance). The port's library is built with
g++ into a temporary directory."""

import numpy as np
import pytest

from nerf_mae_tpu.data import native as jnative
from nerf_mae_tpu.data.datasets import rotate_and_scale_scene as j_rotate_and_scale
from nerf_mae_tpu.ops.patchify import patchify_np as j_patchify_np
from nerf_mae_torch.data import datasets, native


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The port's library built into a temporary directory."""
    mp = pytest.MonkeyPatch()
    mp.setattr(native, "BUILD_ROOT", tmp_path_factory.mktemp("collate"))
    mp.setattr(native, "_lib", None)
    assert native.available(), "native library failed to build"
    yield native
    mp.undo()


@pytest.fixture()
def numpy_path(monkeypatch):
    """The port's numpy paths (as without g++)."""
    monkeypatch.setattr(native, "_lib", False)
    assert not native.available()
    return native


@pytest.fixture(scope="module")
def grid():
    return np.random.RandomState(0).rand(10, 12, 8, 4).astype(np.float32)


def test_builds_into_the_source_hash_directory(built):
    path = native.lib_path()
    assert path.exists() and path.parent.parent == native.BUILD_ROOT
    assert "native" not in str(path.relative_to(native.BUILD_ROOT))


def test_missing_compiler_falls_back_to_numpy_with_a_warning(monkeypatch, tmp_path, caplog):
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ on the path
    with caplog.at_level("WARNING"):
        assert not native.available()
    assert "native collate unavailable" in caplog.text
    g = np.random.RandomState(3).rand(5, 6, 7, 4).astype(np.float32)
    np.testing.assert_array_equal(native.pad_to_cube(g, 8),
                                  np.pad(g, [(0, 3), (0, 2), (0, 1), (0, 0)]))


@pytest.mark.parametrize("path", ["built", "numpy_path"])
def test_pad_to_cube(request, grid, path):
    mod = request.getfixturevalue(path)
    out = mod.pad_to_cube(grid, 16)
    assert out.shape == (16, 16, 16, 4)
    np.testing.assert_array_equal(out[:10, :12, :8], grid)
    assert (out[10:] == 0).all() and (out[:, 12:] == 0).all()
    np.testing.assert_array_equal(out, jnative.pad_to_cube(grid, 16))
    out = mod.pad_to_cube(grid, 6)  # crop
    np.testing.assert_array_equal(out, grid[:6, :6, :6])


@pytest.mark.parametrize("path", ["built", "numpy_path"])
@pytest.mark.parametrize("axis", [0, 1])
def test_flip(request, grid, path, axis):
    mod = request.getfixturevalue(path)
    got = mod.flip_axis(grid, axis)
    np.testing.assert_array_equal(got, np.flip(grid, axis))
    np.testing.assert_array_equal(got, jnative.flip_axis(grid, axis))


@pytest.mark.parametrize("path", ["built", "numpy_path"])
def test_rot90(request, grid, path):
    mod = request.getfixturevalue(path)
    got = mod.rot90_wl(grid)
    np.testing.assert_array_equal(got, np.flip(np.swapaxes(grid, 0, 1), 0))
    np.testing.assert_array_equal(got, jnative.rot90_wl(grid))


@pytest.mark.parametrize("path", ["built", "numpy_path"])
def test_rotate_scale_matches_numpy(request, path):
    mod = request.getfixturevalue(path)
    g = np.random.RandomState(1).rand(9, 9, 9, 4).astype(np.float32)
    got = mod.rotate_scale(g, 0.2, 1.05)
    want, _ = j_rotate_and_scale(g, None, 0.2, 1.05)
    np.testing.assert_allclose(got, want, atol=1e-5)
    if path == "numpy_path":  # the same numpy arithmetic as JAX's
        np.testing.assert_array_equal(got, want)
    else:  # the same C++ as JAX's native
        np.testing.assert_array_equal(got, jnative.rotate_scale(g, 0.2, 1.05))


@pytest.mark.parametrize("path", ["built", "numpy_path"])
def test_rotate_scale_identity(request, grid, path):
    mod = request.getfixturevalue(path)
    np.testing.assert_allclose(mod.rotate_scale(grid, 0.0, 1.0), grid, atol=1e-6)


@pytest.mark.parametrize("path", ["built", "numpy_path"])
def test_pad_to_patches_matches_numpy(request, path):
    mod = request.getfixturevalue(path)
    g = np.random.RandomState(2).rand(9, 7, 11, 4).astype(np.float32)
    got = mod.pad_to_patches(g, 12, 4)
    assert got.shape == (3, 3, 3, 64, 4)
    np.testing.assert_array_equal(got, j_patchify_np(jnative.pad_to_cube(g, 12)[None], 4)[0])
    np.testing.assert_array_equal(got, jnative.pad_to_patches(g, 12, 4))


def test_flip_axis_rejects_the_height_axis(built, grid):
    with pytest.raises(ValueError, match="axis 0 or 1"):
        native.flip_axis(grid, 2)


@pytest.mark.parametrize("path", ["built", "numpy_path"])
def test_mae_batch_iterator_patch_major(request, path):
    request.getfixturevalue(path)
    scenes = [np.random.RandomState(i).rand(14, 16, 12, 4).astype(np.float32)
              for i in range(4)]
    ds = [{"rgbsigma": s} for s in scenes]
    b = next(datasets.mae_batch_iterator(ds, 2, 16, shuffle=False, loop=False,
                                         patch_major=4, workers=2))
    assert b["grids"].shape == (2, 4, 4, 4, 64, 4)
    np.testing.assert_array_equal(b["sizes"][0], [14, 16, 12])
    b2 = next(datasets.mae_batch_iterator(ds, 2, 16, shuffle=False, loop=False))
    np.testing.assert_array_equal(b["grids"], j_patchify_np(b2["grids"], 4))
