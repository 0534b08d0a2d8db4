"""Scene data on the host, numpy only (copies of the pieces of
nerf_mae_tpu/data/datasets.py that the port needs).

density_to_alpha / scannet_density_to_alpha (reference:
nerf_rpn/datasets.py:246-248, :410-414); the scene datasets on disk
(`load_split`, `SceneDataset`: a features directory of rgbsigma npz files
plus box, super-resolution or semantic targets) and their augmentations
(`augment_scene`, `rotate_and_scale_scene`); synthetic_scenes, pad_to_cube
and mae_batch_iterator, the pretraining feed. The native collate, the
prefetch pool and the device-resident corpus are not part of the port yet.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from nerf_mae_torch.ops.patchify import patchify_np

logger = logging.getLogger(__name__)


def density_to_alpha(density: np.ndarray) -> np.ndarray:
    """Instant-NGP-style (exp activation) density -> opacity."""
    return np.clip(1.0 - np.exp(-np.exp(density) / 100.0), 0.0, 1.0)


def scannet_density_to_alpha(density: np.ndarray) -> np.ndarray:
    """Dense-depth-prior NeRF (ReLU activation) variant."""
    return np.clip(1.0 - np.exp(-np.clip(density, 0, None) / 100.0), 0.0, 1.0)


def load_split(split_npz: str) -> Dict[str, List[str]]:
    """Reads {train,val,test}_scenes arrays from a split npz
    (reference: run_swin_mae3d.py:413-424)."""
    with np.load(split_npz, allow_pickle=True) as f:
        return {
            k.replace("_scenes", ""): [str(s) for s in f[k]]
            for k in f.files
            if k.endswith("_scenes")
        }


def _load_rgbsigma(path: str, normalize_density: bool, alpha_fn) -> np.ndarray:
    with np.load(path) as f:
        rgbsigma = np.array(f["rgbsigma"])
    if rgbsigma.dtype == np.uint8:
        # uint8 grids already store quantized [0,1] values; density->alpha
        # does not apply (the reference applies it before the cast, which
        # truncates alpha to 0/1; it is skipped instead)
        return rgbsigma.astype(np.float32) / 255.0
    rgbsigma = rgbsigma.astype(np.float32)
    if normalize_density:
        rgbsigma[..., -1] = alpha_fn(rgbsigma[..., -1])
    return rgbsigma  # (W, L, H, C) channel-last


class SceneDataset:
    """Scene-level dataset over a features dir (+ optional targets).

    target kinds (mutually exclusive, like the reference's dataset variants
    datasets.py:265-348):
      boxes_path    -> per-scene [N, 6|7] box arrays (detection)
      out_feat_path -> high-res rgbsigma npz (super-resolution)
      sem_feat_path -> voxel semantic label npy (segmentation)
    """

    def __init__(
        self,
        features_path: str,
        scene_list: Optional[Sequence[str]] = None,
        boxes_path: Optional[str] = None,
        out_feat_path: Optional[str] = None,
        sem_feat_path: Optional[str] = None,
        normalize_density: bool = True,
        dataset_type: str = "front3d",  # front3d | hypersim | scannet | general
        flip_prob: float = 0.0,
        rotate_prob: float = 0.0,
        rot_scale_prob: float = 0.0,
        percent_train: float = 1.0,
        preload: bool = False,
        seed: int = 0,
    ):
        self.features_path = features_path
        self.boxes_path = boxes_path
        self.out_feat_path = out_feat_path
        self.sem_feat_path = sem_feat_path
        self.normalize_density = normalize_density
        self.alpha_fn = (
            scannet_density_to_alpha if dataset_type == "scannet" else density_to_alpha
        )
        self.flip_prob = flip_prob
        self.rotate_prob = rotate_prob
        self.rot_scale_prob = rot_scale_prob
        self._rng = np.random.RandomState(seed)

        if scene_list is None:
            scene_list = sorted(
                f[:-4] for f in os.listdir(features_path) if f.endswith(".npz")
            )
        scene_list = list(scene_list)[: int(percent_train * len(scene_list))]
        # drop scenes with missing files / empty boxes (reference:
        # datasets.py:127-143)
        kept = []
        for s in scene_list:
            if not os.path.isfile(os.path.join(features_path, s + ".npz")):
                logger.warning("%s has no feature file", s)
                continue
            if boxes_path is not None:
                b = np.load(os.path.join(boxes_path, s + ".npy"))
                if b.shape[0] == 0:
                    logger.warning("%s has no boxes", s)
                    continue
            kept.append(s)
        self.scenes = kept
        self._cache = {}
        if preload:
            for s in self.scenes:
                self._cache[s] = self._load(s)

    def __len__(self) -> int:
        return len(self.scenes)

    def _load(self, scene: str) -> Dict:
        out: Dict = {"scene": scene}
        out["rgbsigma"] = _load_rgbsigma(
            os.path.join(self.features_path, scene + ".npz"),
            self.normalize_density,
            self.alpha_fn,
        )
        if self.boxes_path is not None:
            out["boxes"] = np.load(
                os.path.join(self.boxes_path, scene + ".npy")
            ).astype(np.float32)
        if self.out_feat_path is not None:
            out["out_rgbsigma"] = _load_rgbsigma(
                os.path.join(self.out_feat_path, scene + ".npz"),
                self.normalize_density,
                self.alpha_fn,
            )
        if self.sem_feat_path is not None:
            out["semantics"] = np.load(
                os.path.join(self.sem_feat_path, scene + ".npy")
            ).astype(np.int32)
        return out

    def __getitem__(self, index: int) -> Dict:
        scene = self.scenes[index]
        item = self._cache.get(scene)
        if item is None:
            item = self._load(scene)
        item = dict(item)  # shallow copy before augmentation
        if self.flip_prob > 0 or self.rotate_prob > 0 or self.rot_scale_prob > 0:
            item = augment_scene(
                item,
                self._rng,
                self.flip_prob,
                self.rotate_prob,
                self.rot_scale_prob,
            )
        return item


def augment_scene(
    item: Dict,
    rng: np.random.RandomState,
    flip_prob: float,
    rotate_prob: float,
    rot_scale_prob: float,
) -> Dict:
    """z-up flips / rot90 / small rotation+scale, channel-last grids.

    Box math mirrors the reference's augment_rpn_inputs
    (reference: datasets.py:172-245) on spatial axes (0, 1) of (W, L, H, C).
    """
    g = item["rgbsigma"]
    boxes = item.get("boxes")

    if rng.rand() < rotate_prob:
        g = np.flip(np.swapaxes(g, 0, 1), axis=0)
        if boxes is not None:
            boxes = boxes.copy()
            if boxes.shape[1] == 6:
                boxes[:, [0, 1, 3, 4]] = boxes[:, [1, 0, 4, 3]]
                boxes[:, [0, 3]] = g.shape[0] - boxes[:, [3, 0]]
            else:
                boxes[:, [0, 1, 3, 4]] = boxes[:, [1, 0, 4, 3]]
                boxes[:, 0] = g.shape[0] - boxes[:, 0]

    for axis in (0, 1):
        if rng.rand() < flip_prob:
            g = np.flip(g, axis=axis)
            if boxes is not None:
                boxes = boxes.copy()
                if boxes.shape[1] == 6:
                    boxes[:, [axis, axis + 3]] = (
                        g.shape[axis] - boxes[:, [axis + 3, axis]]
                    )
                else:
                    boxes[:, axis] = g.shape[axis] - boxes[:, axis]
                    boxes[:, -1] = -boxes[:, -1]

    if boxes is not None and boxes.shape[1] == 7 and rng.rand() < rot_scale_prob:
        angle = rng.uniform(-np.pi / 18, np.pi / 18)
        scale = rng.uniform(0.9, 1.1)
        g, boxes = rotate_and_scale_scene(np.ascontiguousarray(g), boxes, angle, scale)

    item["rgbsigma"] = np.ascontiguousarray(g)
    if boxes is not None:
        item["boxes"] = boxes
    return item


def rotate_and_scale_scene(
    g: np.ndarray, boxes: Optional[np.ndarray], angle: float, scale: float
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Resample the grid under a z-rotation + uniform scale, trilinear with
    zero padding, align-corners convention; boxes follow analytically
    (reference: datasets.py:478-524)."""
    res = g.shape[:3]
    xform = (
        np.array(
            [
                [np.cos(angle), -np.sin(angle), 0],
                [np.sin(angle), np.cos(angle), 0],
                [0, 0, 1],
            ],
            dtype=np.float64,
        )
        * scale
    )
    # voxel-centered coords: index i -> (2i/(n-1) - 1) * n/2
    axes = [
        (2.0 * np.arange(n) / max(n - 1, 1) - 1.0) * n / 2.0 for n in res
    ]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)  # [W,L,H,3]
    sample = grid.reshape(-1, 3) @ xform.T  # positions to sample, same coords
    # back to fractional indices (align_corners=True)
    idx = np.empty_like(sample)
    for a in range(3):
        idx[:, a] = (sample[:, a] / (res[a] / 2.0) + 1.0) / 2.0 * (res[a] - 1)

    out = _trilinear_gather_zeros(g, idx).reshape(*res, g.shape[3])

    if boxes is not None:
        boxes = boxes.copy()
        boxes[:, 6] = boxes[:, 6] - angle
        boxes[:, 3:6] = boxes[:, 3:6] / scale
        center = np.asarray(res, np.float32)[None] / 2
        offset = boxes[:, :3] - center
        boxes[:, :3] = offset @ (xform.astype(np.float32) / (scale * scale)) + center
    return out.astype(g.dtype), boxes


def _trilinear_gather_zeros(g: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Trilinear sample of g [W, L, H, C] at fractional indices idx [M, 3];
    out-of-range reads contribute zero (grid_sample 'zeros' padding)."""
    res = g.shape[:3]
    f = np.floor(idx).astype(np.int64)
    w = (idx - f).astype(np.float32)
    out = np.zeros((idx.shape[0], g.shape[3]), np.float32)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                c = f + np.array([dx, dy, dz])
                weight = (
                    (w[:, 0] if dx else 1 - w[:, 0])
                    * (w[:, 1] if dy else 1 - w[:, 1])
                    * (w[:, 2] if dz else 1 - w[:, 2])
                )
                inside = (
                    (c[:, 0] >= 0) & (c[:, 0] < res[0])
                    & (c[:, 1] >= 0) & (c[:, 1] < res[1])
                    & (c[:, 2] >= 0) & (c[:, 2] < res[2])
                )
                cc = np.clip(c, 0, np.array(res) - 1)
                vals = g[cc[:, 0], cc[:, 1], cc[:, 2], :].astype(np.float32)
                out += vals * (weight * inside)[:, None]
    return out


def synthetic_scenes(n: int, resolution: int = 160, seed: int = 0,
                     min_size: Optional[int] = None) -> List[np.ndarray]:
    """Random rgbsigma scenes (channel-last) with box-shaped opaque blobs,
    for tests and benchmarks without real data (the JAX package's draws,
    number for number)."""
    rng = np.random.RandomState(seed)
    lo = min_size or int(resolution * 0.8)
    scenes = []
    for _ in range(n):
        size = rng.randint(lo, resolution + 1, 3)
        g = np.zeros((*size, 4), np.float32)
        for _ in range(rng.randint(3, 9)):
            c = rng.randint(0, size - 1, 3)
            e = rng.randint(4, max(min(size) // 3, 5), 3)
            s0 = np.maximum(c - e, 0)
            s1 = np.minimum(c + e, size)
            g[s0[0]: s1[0], s0[1]: s1[1], s0[2]: s1[2], :3] = rng.rand(3)
            g[s0[0]: s1[0], s0[1]: s1[1], s0[2]: s1[2], 3] = rng.uniform(0.3, 1.0)
        scenes.append(g)
    return scenes


def synthetic_detection_scenes(n: int, resolution: int = 160, seed: int = 0,
                               min_size: Optional[int] = None, obb: bool = False,
                               hard: bool = False) -> List[Dict]:
    """Synthetic scenes with box annotations of their blobs (AABB [N, 6], or
    OBB [N, 7] with theta = 0): {"rgbsigma", "boxes"} dicts, the JAX
    package's draws number for number. hard=True is its low-data
    distribution: more and smaller objects, unlabelled clutter (floor and
    wall slabs, debris), faint objects and background alpha noise."""
    rng = np.random.RandomState(seed)
    lo = min_size or int(resolution * 0.8)
    scenes = []
    for _ in range(n):
        size = rng.randint(lo, resolution + 1, 3)
        g = np.zeros((*size, 4), np.float32)
        if hard:
            fh = rng.randint(2, 5)
            g[:, :, :fh, :3] = rng.rand(3) * 0.5
            g[:, :, :fh, 3] = rng.uniform(0.4, 0.9)
            ww = rng.randint(2, 4)
            g[:ww, :, :, :3] = rng.rand(3) * 0.5
            g[:ww, :, :, 3] = rng.uniform(0.4, 0.9)
            for _ in range(rng.randint(4, 9)):  # debris clutter, unlabelled
                c = rng.randint(3, size - 3, 3)
                e = rng.randint(1, 3, 3)
                s0, s1 = np.maximum(c - e, 0), np.minimum(c + e, size)
                g[s0[0]:s1[0], s0[1]:s1[1], s0[2]:s1[2], :3] = rng.rand(3)
                g[s0[0]:s1[0], s0[1]:s1[1], s0[2]:s1[2], 3] = rng.uniform(0.3, 0.8)
            g[..., 3] += rng.rand(*size) * 0.05
        boxes = []
        for _ in range(rng.randint(4, 10) if hard else rng.randint(2, 6)):
            c = rng.randint(6, size - 6, 3)
            if hard:
                e = rng.randint(2, max(min(size) // 8, 5), 3)
            else:
                e = rng.randint(3, max(min(size) // 4, 4), 3)
            s0 = np.maximum(c - e, 0)
            s1 = np.minimum(c + e, size)
            g[s0[0]:s1[0], s0[1]:s1[1], s0[2]:s1[2], :3] = rng.rand(3)
            alpha = rng.uniform(0.3, 1.0) if hard else rng.uniform(0.5, 1.0)
            g[s0[0]:s1[0], s0[1]:s1[1], s0[2]:s1[2], 3] = alpha
            if obb:
                boxes.append([*((s0 + s1) / 2), *(s1 - s0).astype(np.float32), 0.0])
            else:
                boxes.append([*s0, *s1])
        if hard:
            np.clip(g[..., 3], 0.0, 1.0, out=g[..., 3])
        scenes.append({"rgbsigma": g, "boxes": np.asarray(boxes, np.float32)})
    return scenes


def pad_boxes(boxes: np.ndarray, max_gt: int) -> Tuple[np.ndarray, np.ndarray]:
    """[N, 6|7] -> ([max_gt, 6|7], valid [max_gt]) with zero padding."""
    d = boxes.shape[1] if boxes.size else 6
    out = np.zeros((max_gt, d), np.float32)
    valid = np.zeros((max_gt,), bool)
    n = min(len(boxes), max_gt)
    if n:
        out[:n] = boxes[:n]
        valid[:n] = True
    return out, valid


def detection_batch_iterator(dataset: Sequence, batch_size: int, resolution: int,
                             max_gt: int = 64, shuffle: bool = True, seed: int = 0,
                             drop_last: bool = True, loop: bool = True
                             ) -> Iterator[Dict[str, np.ndarray]]:
    """Yields {"grids": [B, R, R, R, 4] float32, "sizes": [B, 3] int32,
    "gt_boxes": [B, G, 6|7] float32, "gt_valid": [B, G] bool}, in the JAX
    iterator's order; scenes are loaded inline."""
    rng = np.random.RandomState(seed)
    n = len(dataset)
    while True:
        order = rng.permutation(n) if shuffle else np.arange(n)
        for start in range(0, n, batch_size):
            sel = order[start: start + batch_size]
            if len(sel) < batch_size and drop_last:
                continue
            items = [dataset[int(j)] for j in sel]
            box_dim = max((i["boxes"].shape[1] for i in items if i.get("boxes") is not None),
                          default=6)
            grids = np.zeros((len(sel), resolution, resolution, resolution, 4), np.float32)
            sizes = np.zeros((len(sel), 3), np.int32)
            gt = np.zeros((len(sel), max_gt, box_dim), np.float32)
            gv = np.zeros((len(sel), max_gt), bool)
            for i, item in enumerate(items):
                grids[i], sizes[i] = pad_to_cube(item["rgbsigma"], resolution)
                if item.get("boxes") is not None:
                    gt[i], gv[i] = pad_boxes(item["boxes"], max_gt)
            yield {"grids": grids, "sizes": sizes, "gt_boxes": gt, "gt_valid": gv}
        if not loop:
            return


def pad_to_cube(g: np.ndarray, resolution: int) -> Tuple[np.ndarray, np.ndarray]:
    """Crop-to-fit + zero-pad a (W, L, H, C) grid to resolution^3; returns
    (grid, size [3] int32)."""
    size = np.minimum(np.asarray(g.shape[:3], np.int64), resolution).astype(np.int32)
    g = g[:resolution, :resolution, :resolution]
    out = np.zeros((resolution, resolution, resolution, g.shape[3]), np.float32)
    out[: size[0], : size[1], : size[2]] = g
    return out, size


def mae_batch_iterator(
    dataset: Sequence,
    batch_size: int,
    resolution: int,
    shuffle: bool = True,
    seed: int = 0,
    drop_last: bool = True,
    loop: bool = True,
    patch_major: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yields {"grids": [B, R, R, R, 4] float32, "sizes": [B, 3] int32}
    forever (or one epoch if loop=False), in the JAX iterator's order.
    `dataset[i]["rgbsigma"]` is a channel-last grid. patch_major=p emits
    grids in the patch-major layout [B, t, t, t, p^3, 4] (t = R // p)."""
    rng = np.random.RandomState(seed)
    n = len(dataset)
    if patch_major:
        t = resolution // patch_major
        grid_shape = (t, t, t, patch_major ** 3, 4)
    else:
        grid_shape = (resolution, resolution, resolution, 4)

    def load(j):
        g, size = pad_to_cube(dataset[int(j)]["rgbsigma"], resolution)
        if patch_major:
            g = patchify_np(g[None], patch_major)[0]
        return g, size

    while True:
        order = rng.permutation(n) if shuffle else np.arange(n)
        for start in range(0, n, batch_size):
            sel = order[start: start + batch_size]
            if len(sel) < batch_size and drop_last:
                continue
            grids = np.zeros((len(sel),) + grid_shape, np.float32)
            sizes = np.zeros((len(sel), 3), np.int32)
            for i, j in enumerate(sel):
                grids[i], sizes[i] = load(j)
            yield {"grids": grids, "sizes": sizes}
        if not loop:
            return
