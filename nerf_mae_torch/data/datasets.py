"""Scene data on the host, numpy only (the port's copy of
nerf_mae_tpu/data/datasets.py).

density_to_alpha / scannet_density_to_alpha (reference:
nerf_rpn/datasets.py:246-248, :410-414); the scene datasets on disk
(`load_split`, `SceneDataset`: a features directory of rgbsigma npz files
plus box, super-resolution or semantic targets; `GeneralDataset` over a
csv; `ConcatDataset`; `split_hypersim_dataset`) and their augmentations
(`augment_scene`, `rotate_and_scale_scene`); the synthetic scenes; and the
batch iterators of the training feed, `mae_batch_iterator` and
`detection_batch_iterator`. Those assemble a batch's scenes on a thread
pool (`workers=`) with the native collate (data/native.py: pad-to-cube and
the fused pad + patchify).

Augment randomness is drawn in scene order whatever the number of workers:
a scene is loaded on the pool, its augment parameters are drawn from the
dataset's generator on the calling thread in the batch's order (the order
in which the JAX package's serial iterator draws them), and applied on the
pool. So `workers=N` gives the batches of `workers=0`, which are the JAX
package's. (Its iterators draw inside the pool's threads, so under
workers > 0 its draws follow thread scheduling.)

Data parallelism (the reference's DistributedSampler): given `rank` and
`world`, an iterator yields rank r's rows [r*b, (r+1)*b) of each global
batch of `batch_size` (b = batch_size / world) and loads only those scenes.
Every rank draws the augment parameters of the whole batch, in its order,
and applies its own, so its rows equal those of the single-process batch.

Host spans (tracing.py), on whichever thread does the work:
nerf_mae.feed.read (a scene from disk), nerf_mae.feed.augment and
nerf_mae.feed.collate (a scene's pad, and the batch's assembly).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from nerf_mae_torch import tracing
from nerf_mae_torch.data import native
from nerf_mae_torch.data.pipeline import ScenePool
from nerf_mae_torch.parallel.mesh import batch_rows

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
        # datasets.py:127-143); the box width of each scene decides its
        # augment draws (rot + scale for OBBs only)
        kept = []
        self._obb = {}
        for s in scene_list:
            if not os.path.isfile(os.path.join(features_path, s + ".npz")):
                logger.warning("%s has no feature file", s)
                continue
            if boxes_path is not None:
                b = np.load(os.path.join(boxes_path, s + ".npy"))
                if b.shape[0] == 0:
                    logger.warning("%s has no boxes", s)
                    continue
                self._obb[s] = b.shape[1] == 7
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

    @property
    def augmented(self) -> bool:
        """Whether items are augmented (fresh randomness per visit)."""
        return self.flip_prob > 0 or self.rotate_prob > 0 or self.rot_scale_prob > 0

    def load_item(self, index: int) -> Dict:
        """The scene's item before augmentation (a shallow copy)."""
        scene = self.scenes[index]
        item = self._cache.get(scene)
        if item is None:
            with tracing.span("nerf_mae.feed.read", events=False):
                item = self._load(scene)
        return dict(item)

    def draw_augment(self, index: int) -> Tuple:
        """The next augment parameters for scene `index` from the dataset's
        generator (the draws augment_scene makes); its boxes' width, read
        when the dataset was made, is all it needs of the scene."""
        return draw_augment(self._rng, self.flip_prob, self.rotate_prob,
                            self.rot_scale_prob,
                            obb=self._obb.get(self.scenes[index], False))

    @staticmethod
    def apply_augment(item: Dict, draws: Tuple) -> Dict:
        with tracing.span("nerf_mae.feed.augment", events=False):
            return apply_augment(item, draws)

    def __getitem__(self, index: int) -> Dict:
        item = self.load_item(index)
        if self.augmented:
            item = self.apply_augment(item, self.draw_augment(index))
        return item


def draw_augment(rng: np.random.RandomState, flip_prob: float, rotate_prob: float,
                 rot_scale_prob: float, obb: bool) -> Tuple:
    """(rotate, (flip0, flip1), rot_scale: (angle, scale) or None): the
    draws of augment_scene, in its order; rot+scale is drawn for OBB boxes
    only."""
    rotate = rng.rand() < rotate_prob
    flips = tuple(bool(rng.rand() < flip_prob) for _ in (0, 1))
    rot_scale = None
    if obb and rng.rand() < rot_scale_prob:
        angle = rng.uniform(-np.pi / 18, np.pi / 18)
        rot_scale = (angle, rng.uniform(0.9, 1.1))
    return bool(rotate), flips, rot_scale


def apply_augment(item: Dict, draws: Tuple) -> Dict:
    """z-up flips / rot90 / small rotation+scale of draw_augment's draws,
    channel-last grids.

    Box math mirrors the reference's augment_rpn_inputs
    (reference: datasets.py:172-245) on spatial axes (0, 1) of (W, L, H, C).
    """
    rotate, flips, rot_scale = draws
    g = item["rgbsigma"]
    boxes = item.get("boxes")

    if rotate:
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
        if flips[axis]:
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

    if rot_scale is not None:
        g, boxes = rotate_and_scale_scene(np.ascontiguousarray(g), boxes, *rot_scale)

    item["rgbsigma"] = np.ascontiguousarray(g)
    if boxes is not None:
        item["boxes"] = boxes
    return item


def augment_scene(
    item: Dict,
    rng: np.random.RandomState,
    flip_prob: float,
    rotate_prob: float,
    rot_scale_prob: float,
) -> Dict:
    """draw_augment from `rng`, then apply_augment."""
    boxes = item.get("boxes")
    draws = draw_augment(rng, flip_prob, rotate_prob, rot_scale_prob,
                         obb=boxes is not None and boxes.shape[1] == 7)
    return apply_augment(item, draws)


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


def _fetch(dataset, sel, pool, finish, own: slice = slice(None)):
    """[finish(dataset[j]) for j in sel[own]], assembled on `pool` in order.
    For a dataset with host augments (`augmented`) the augment parameters
    of every scene of `sel` are drawn here in its order, the `own` scenes
    loaded on the pool and their draws applied there, so the draws depend
    neither on the number of workers nor on the rank."""
    def collate(item):
        with tracing.span("nerf_mae.feed.collate", events=False):
            return finish(item)

    if not getattr(dataset, "augmented", False):
        return pool.map(lambda j: collate(dataset[int(j)]), sel[own])
    draws = [dataset.draw_augment(int(j)) for j in sel][own]
    items = pool.map(lambda j: dataset.load_item(int(j)), sel[own])
    return pool.map(lambda a: collate(dataset.apply_augment(*a)), list(zip(items, draws)))


def detection_batch_iterator(dataset: Sequence, batch_size: int, resolution: int,
                             max_gt: int = 64, shuffle: bool = True, seed: int = 0,
                             drop_last: bool = True, loop: bool = True, workers: int = 0,
                             rank: int = 0, world: int = 1
                             ) -> Iterator[Dict[str, np.ndarray]]:
    """Yields {"grids": [B, R, R, R, 4] float32, "sizes": [B, 3] int32,
    "gt_boxes": [B, G, 6|7] float32, "gt_valid": [B, G] bool}, in the JAX
    iterator's order; workers > 0 loads and pads scenes on a thread pool.
    world > 1: rank's rows of each batch (module doc)."""
    rng = np.random.RandomState(seed)
    n = len(dataset)
    pool = ScenePool(workers)
    finish = lambda item: (item, pad_to_cube(item["rgbsigma"], resolution))
    try:
        while True:
            order = rng.permutation(n) if shuffle else np.arange(n)
            for start in range(0, n, batch_size):
                sel = order[start: start + batch_size]
                if len(sel) < batch_size and drop_last:
                    continue
                pairs = _fetch(dataset, sel, pool, finish, batch_rows(len(sel), rank, world))
                box_dim = max((item["boxes"].shape[1] for item, _ in pairs
                               if item.get("boxes") is not None), default=6)
                b = len(pairs)
                with tracing.span("nerf_mae.feed.collate", events=False):
                    grids = np.zeros((b, resolution, resolution, resolution, 4), np.float32)
                    sizes = np.zeros((b, 3), np.int32)
                    gt = np.zeros((b, max_gt, box_dim), np.float32)
                    gv = np.zeros((b, max_gt), bool)
                    for i, (item, padded) in enumerate(pairs):
                        grids[i], sizes[i] = padded
                        if item.get("boxes") is not None:
                            gt[i], gv[i] = pad_boxes(item["boxes"], max_gt)
                yield {"grids": grids, "sizes": sizes, "gt_boxes": gt, "gt_valid": gv}
            if not loop:
                return
    finally:
        pool.close()


def pad_to_cube(g: np.ndarray, resolution: int) -> Tuple[np.ndarray, np.ndarray]:
    """Crop-to-fit + zero-pad a (W, L, H, C) grid to resolution^3 (the
    native collate's copy); returns (grid, size [3] int32)."""
    size = np.minimum(np.asarray(g.shape[:3], np.int64), resolution).astype(np.int32)
    return native.pad_to_cube(g, resolution), size


def mae_batch_iterator(
    dataset: Sequence,
    batch_size: int,
    resolution: int,
    shuffle: bool = True,
    seed: int = 0,
    drop_last: bool = True,
    loop: bool = True,
    workers: int = 0,
    patch_major: int = 0,
    rank: int = 0,
    world: int = 1,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yields {"grids": [B, R, R, R, 4] float32, "sizes": [B, 3] int32}
    forever (or one epoch if loop=False), in the JAX iterator's order.
    `dataset[i]["rgbsigma"]` is a channel-last grid. patch_major=p emits
    grids in the patch-major layout [B, t, t, t, p^3, 4] (t = R // p) from
    the native fused pad + patchify. workers > 0 assembles the scenes on a
    thread pool. world > 1: rank's rows of each batch (module doc)."""
    rng = np.random.RandomState(seed)
    n = len(dataset)
    pool = ScenePool(workers)
    if patch_major:
        t = resolution // patch_major
        grid_shape = (t, t, t, patch_major ** 3, 4)

        def finish(item):
            g = item["rgbsigma"]
            size = np.minimum(g.shape[:3], resolution).astype(np.int32)
            return native.pad_to_patches(g, resolution, patch_major), size
    else:
        grid_shape = (resolution, resolution, resolution, 4)
        finish = lambda item: pad_to_cube(item["rgbsigma"], resolution)

    try:
        while True:
            order = rng.permutation(n) if shuffle else np.arange(n)
            for start in range(0, n, batch_size):
                sel = order[start: start + batch_size]
                if len(sel) < batch_size and drop_last:
                    continue
                own = batch_rows(len(sel), rank, world)
                scenes = _fetch(dataset, sel, pool, finish, own)
                with tracing.span("nerf_mae.feed.collate", events=False):
                    grids = np.zeros((len(scenes),) + grid_shape, np.float32)
                    sizes = np.zeros((len(scenes), 3), np.int32)
                    for i, (g, size) in enumerate(scenes):
                        grids[i], sizes[i] = g, size
                yield {"grids": grids, "sizes": sizes}
            if not loop:
                return
    finally:
        pool.close()


class GeneralDataset:
    """CSV-driven dataset: columns scene,rgbsigma_path,boxes_path
    (reference: datasets.py:417-451 GeneralRPNDataset)."""

    def __init__(self, csv_path: str, normalize_density: bool = True):
        import csv

        with open(csv_path) as f:
            self.rows = list(csv.DictReader(f))
        self.normalize_density = normalize_density
        self.scenes = [r["scene"] for r in self.rows]

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, index: int) -> Dict:
        row = self.rows[index]
        out = {
            "scene": row["scene"],
            "rgbsigma": _load_rgbsigma(row["rgbsigma_path"], self.normalize_density,
                                       density_to_alpha),
        }
        bp = row.get("boxes_path")
        if bp and bp != "None":
            out["boxes"] = np.load(bp).astype(np.float32)
        return out


class ConcatDataset:
    """Concatenation of scene datasets for multi-dataset pretraining (the
    reference trains on Front3D + HM3D + Hypersim jointly,
    README.md:254-258); augmented members keep their serial draws."""

    def __init__(self, *datasets):
        self.datasets = [d for d in datasets if d is not None and len(d) > 0]
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def _locate(self, index: int) -> Tuple[int, int]:
        d = int(np.searchsorted(self._offsets, index, side="right") - 1)
        return d, index - int(self._offsets[d])

    def __getitem__(self, index):
        d, j = self._locate(index)
        return self.datasets[d][j]

    @property
    def augmented(self) -> bool:
        return any(getattr(d, "augmented", False) for d in self.datasets)

    def load_item(self, index: int):
        d, j = self._locate(index)
        sub = self.datasets[d]
        return d, (sub.load_item(j) if getattr(sub, "augmented", False) else sub[j])

    def draw_augment(self, index: int):
        d, j = self._locate(index)
        sub = self.datasets[d]
        return sub.draw_augment(j) if getattr(sub, "augmented", False) else None

    def apply_augment(self, located, draws):
        d, item = located
        return item if draws is None else self.datasets[d].apply_augment(item, draws)


def split_hypersim_dataset(
    scenes: Sequence[str],
    train_ratio: float,
    val_ratio: float,
    output_path: str,
    seed: Optional[int] = None,
) -> str:
    """Shuffle scenes into train/val/test splits and write
    hypersim_split.npz (reference: nerf_rpn/datasets.py:453-476, with an
    explicit seed). Returns the npz path."""
    if train_ratio + val_ratio > 1.0:
        raise ValueError("train_ratio + val_ratio must be <= 1.0")
    shuffled = list(scenes)
    np.random.RandomState(seed).shuffle(shuffled)
    n_train = int(len(shuffled) * train_ratio)
    n_val = int(len(shuffled) * (train_ratio + val_ratio))
    out = os.path.join(output_path, "hypersim_split.npz")
    np.savez(out, train_scenes=np.array(shuffled[:n_train]),
             val_scenes=np.array(shuffled[n_train:n_val]),
             test_scenes=np.array(shuffled[n_val:]))
    return out
