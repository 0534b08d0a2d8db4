"""ctypes bindings of the host-side collate library (counterpart of
nerf_mae_tpu/data/native.py).

`csrc/collate.cpp` is built with `g++ -O3 -march=native -shared -fPIC` at
first use into `build/collate/<source hash>/libcollate.so` (git-ignored),
never at import. The ctypes calls release the GIL, so the feed's thread
pool (data/pipeline.py ScenePool) assembles scenes in parallel. Where g++
is missing or the build fails, every function takes its numpy path (the
same values) and a warning is logged once.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from nerf_mae_torch.ops.patchify import patchify_np

logger = logging.getLogger(__name__)

SRC = Path(__file__).resolve().parent.parent / "csrc" / "collate.cpp"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "collate"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
# None: not built yet; False: unavailable (numpy paths); else the handle
_lib = None


def lib_path() -> Path:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + SRC.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libcollate.so"


def _build() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib or None
    with _lock:
        if _lib is not None:
            return _lib or None
        try:
            path = lib_path()
            if not path.exists():
                path.parent.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(f".so.{os.getpid()}.tmp")
                subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                               check=True, capture_output=True)
                os.replace(tmp, path)
                logger.info("built %s", path)
            lib = ctypes.CDLL(str(path))
            i64 = ctypes.c_int64
            fp = ctypes.POINTER(ctypes.c_float)
            lib.pad_to_cube.argtypes = [fp, i64, i64, i64, i64, fp, i64]
            lib.flip_axis.argtypes = [fp, i64, i64, i64, i64, ctypes.c_int, fp]
            lib.rot90_wl.argtypes = [fp, i64, i64, i64, i64, fp]
            lib.rotate_scale.argtypes = [fp, i64, i64, i64, i64,
                                         ctypes.c_float, ctypes.c_float, fp]
            lib.pad_to_patches.argtypes = [fp, i64, i64, i64, i64, fp, i64, i64]
            for fn in (lib.pad_to_cube, lib.flip_axis, lib.rot90_wl,
                       lib.rotate_scale, lib.pad_to_patches):
                fn.restype = None
            _lib = lib
        except (OSError, subprocess.CalledProcessError) as e:
            # no toolchain or a failed build: the numpy paths
            logger.warning("native collate unavailable (%s); using numpy", e)
            _lib = False
    return _lib or None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _grid(g: np.ndarray) -> np.ndarray:
    g = np.ascontiguousarray(g, np.float32)
    if g.ndim != 4:
        raise ValueError(f"expected a (W, L, H, C) grid, got shape {g.shape}")
    return g


def available() -> bool:
    """Whether the native library is built and loaded (building it now)."""
    return _build() is not None


def pad_to_cube(g: np.ndarray, resolution: int) -> np.ndarray:
    """Crop-to-fit + zero-pad a (W, L, H, C) grid to resolution^3."""
    lib = _build()
    g = _grid(g)
    if lib is None:
        out = np.zeros((resolution,) * 3 + (g.shape[3],), np.float32)
        cw, cl, ch = (min(s, resolution) for s in g.shape[:3])
        out[:cw, :cl, :ch] = g[:cw, :cl, :ch]
        return out
    out = np.empty((resolution,) * 3 + (g.shape[3],), np.float32)
    lib.pad_to_cube(_ptr(g), *g.shape, _ptr(out), resolution)
    return out


def pad_to_patches(g: np.ndarray, resolution: int, patch: int) -> np.ndarray:
    """Fused pad-to-cube + patchify: (w, l, h, c) scene -> [t, t, t, p^3, c]
    patch-major layout (t = resolution // patch) in one memory pass; numpy
    path: pad_to_cube then patchify_np."""
    lib = _build()
    g = _grid(g)
    if lib is None:
        return patchify_np(pad_to_cube(g, resolution)[None], patch)[0]
    t = resolution // patch
    out = np.empty((t, t, t, patch ** 3, g.shape[3]), np.float32)
    lib.pad_to_patches(_ptr(g), *g.shape, _ptr(out), resolution, patch)
    return out


def flip_axis(g: np.ndarray, axis: int) -> np.ndarray:
    """np.flip along spatial axis 0 or 1, contiguous."""
    if axis not in (0, 1):
        raise ValueError(f"flip_axis flips axis 0 or 1, got {axis}")
    lib = _build()
    g = _grid(g)
    if lib is None:
        return np.ascontiguousarray(np.flip(g, axis))
    out = np.empty_like(g)
    lib.flip_axis(_ptr(g), *g.shape, axis, _ptr(out))
    return out


def rot90_wl(g: np.ndarray) -> np.ndarray:
    """rot90 in the (w, l) plane: flip(swapaxes(g, 0, 1), 0)."""
    lib = _build()
    g = _grid(g)
    if lib is None:
        return np.ascontiguousarray(np.flip(np.swapaxes(g, 0, 1), 0))
    out = np.empty((g.shape[1], g.shape[0], g.shape[2], g.shape[3]), np.float32)
    lib.rot90_wl(_ptr(g), *g.shape, _ptr(out))
    return out


def rotate_scale(g: np.ndarray, angle: float, scale: float) -> np.ndarray:
    """The grid resampled under a z-rotation + uniform scale (trilinear,
    zero padding); numpy path: datasets.rotate_and_scale_scene."""
    lib = _build()
    g = _grid(g)
    if lib is None:
        from nerf_mae_torch.data.datasets import rotate_and_scale_scene

        return rotate_and_scale_scene(g, None, angle, scale)[0]
    out = np.empty_like(g)
    lib.rotate_scale(_ptr(g), *g.shape, ctypes.c_float(angle),
                     ctypes.c_float(scale), _ptr(out))
    return out
