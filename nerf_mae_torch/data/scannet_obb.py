"""ScanNet oriented-bounding-box generation (L0 data production; the port's
copy of nerf_mae_tpu/data/scannet_obb.py, numpy only).

Re-implements the reference's OBB-annotation pipeline (SURVEY row 39):

  - minimum-area oriented rectangle of a 2D point set via rotating calipers
    over the convex hull (reference: data/scannet/MinimumBoundingBox.py:92-130,
    which scans every hull edge and keeps the minimum bounding area — the
    classic rotating-calipers argument that the optimum is flush with a hull
    edge);
  - per-instance 7-DoF OBB [cx, cy, cz, w, l, h, theta]: min-area rectangle of
    the xy-projection + z extent (reference: data/scannet/generate_bbox.py:10-27);
  - world->grid rescale + label/size filtering of the fitted boxes
    (reference: data/scannet/filter_bbox.py:26-66).

Everything here is vectorized numpy (hull-edge loop becomes one batched
projection matmul) and, unlike the reference (scipy ConvexHull raises on
degenerate input), handles collinear / duplicate / tiny point sets by
degrading gracefully to zero-extent boxes.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "convex_hull_2d",
    "min_area_rect",
    "instance_obb",
    "filter_obbs",
    "SCANNET_EXCLUDED_LABELS",
]


def convex_hull_2d(points: np.ndarray) -> np.ndarray:
    """Convex hull of [N, 2] points, CCW order, via Andrew's monotone chain.

    Returns the hull vertices [H, 2] without the closing duplicate. Degenerate
    inputs (N < 3, all-collinear) return the 2 extreme points (or 1 point).
    Unlike scipy's qhull (used by the reference), this never raises on
    degenerate geometry — important for single-voxel / sliver instances.
    """
    pts = np.asarray(points, dtype=np.float64)
    if pts.ndim != 2 or pts.shape[1] != 2:
        raise ValueError(f"convex_hull_2d expects [N, 2], got {pts.shape}")
    pts = np.unique(pts, axis=0)  # sorts lexicographically (x, then y)
    n = pts.shape[0]
    if n <= 2:
        return pts

    def half(idx_pts):
        chain: List[np.ndarray] = []
        for p in idx_pts:
            while len(chain) >= 2:
                o, a = chain[-2], chain[-1]
                if (a[0] - o[0]) * (p[1] - o[1]) - (a[1] - o[1]) * (p[0] - o[0]) <= 0:
                    chain.pop()
                else:
                    break
            chain.append(p)
        return chain

    lower = half(pts)
    upper = half(pts[::-1])
    hull = np.asarray(lower[:-1] + upper[:-1])
    return hull


def min_area_rect(
    points: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Minimum-area oriented rectangle of [N, 2] points.

    Returns (center_xy [2], size [2] = (length_parallel, length_orthogonal),
    angle) where `angle` is the direction of the `length_parallel` side,
    matching the reference's conventions (MinimumBoundingBox.py:92-130:
    unit vector of the winning hull edge; center reconstructed from rotated
    coordinates via to_xy_coordinates:43-47).

    The reference loops over hull edges in Python; here all E candidate
    orientations are evaluated with one [E, 2] x [2, H] projection batch.
    Degenerate inputs (collinear or < 3 unique points) fall back to the
    extreme-point direction with zero orthogonal extent instead of raising.
    """
    hull = convex_hull_2d(points)
    h = hull.shape[0]
    if h == 1:
        return hull[0].copy(), np.zeros(2), 0.0
    if h == 2:
        d = hull[1] - hull[0]
        ang = float(np.arctan2(d[1], d[0]))
        return (hull[0] + hull[1]) / 2.0, np.array([np.hypot(*d), 0.0]), ang

    edges = np.roll(hull, -1, axis=0) - hull           # [E, 2]
    lens = np.linalg.norm(edges, axis=1)
    keep = lens > 1e-12
    u = edges[keep] / lens[keep, None]                 # [E', 2] unit parallel
    o = np.stack([-u[:, 1], u[:, 0]], axis=1)          # orthogonal
    proj_p = u @ hull.T                                # [E', H]
    proj_o = o @ hull.T
    min_p, max_p = proj_p.min(1), proj_p.max(1)
    min_o, max_o = proj_o.min(1), proj_o.max(1)
    len_p, len_o = max_p - min_p, max_o - min_o
    areas = len_p * len_o
    i = int(np.argmin(areas))

    ang = float(np.arctan2(u[i, 1], u[i, 0]))
    # rectangle center in the (parallel, orthogonal) frame -> world xy
    cp = min_p[i] + len_p[i] / 2.0
    co = min_o[i] + len_o[i] / 2.0
    center = cp * u[i] + co * o[i]
    return center, np.array([len_p[i], len_o[i]]), ang


def instance_obb(vertices: np.ndarray) -> np.ndarray:
    """7-DoF OBB of an instance point cloud [N, 3].

    [cx, cy, cz, w, l, h, theta]: minimum-area rectangle of the xy projection
    (w = length parallel to theta, l = orthogonal), z center/extent from the
    z range (reference: generate_bbox.py:10-27 find_minimum_bounding_box).
    """
    v = np.asarray(vertices, dtype=np.float64)
    if v.ndim != 2 or v.shape[1] != 3 or v.shape[0] == 0:
        raise ValueError(f"instance_obb expects non-empty [N, 3], got {v.shape}")
    min_z, max_z = float(v[:, 2].min()), float(v[:, 2].max())
    center_xy, size_xy, angle = min_area_rect(v[:, :2])
    return np.concatenate(
        [center_xy, [(min_z + max_z) / 2.0], size_xy, [max_z - min_z], [angle]]
    )


# Label exclusion list for ScanNet OBB filtering — data constant from the
# reference (filter_bbox.py:8-23): architectural / flat / tiny clutter
# categories that make poor detection targets.
SCANNET_EXCLUDED_LABELS = frozenset([
    'shower curtain rod', 'paper towel', 'ledge', 'tape', 'paper towel roll',
    'light switch', 'rug', 'faucet', 'ceiling light', 'oven mitt', 'blinds',
    'clothing', 'structure', 'clothes hangers', 'clothes', 'vent', 'tray',
    'closet wall', 'handrail', 'bathroom stall', 'kitchen apron', 'thermostat',
    'swiffer', 'sign', 'hose', 'whiteboard eraser', 'closet rod',
    'toilet paper', 'loofa', 'windowsill', 'tube', 'shower door', 'broom',
    'hair dryer', 'tv stand', 'books', 'bath walls', 'rolled poster', 'floor',
    'clothes hanger', 'fire alarm', 'dustpan', 'stairs', 'bike lock',
    'lamp base', 'slippers', 'hanging', 'globe', 'doorframe', 'plunger',
    'window', 'book', 'sink', 'toilet paper dispenser', 'shower walls',
    'stair', 'shower floor', 'soap dispenser', 'toothbrush', 'banner', 'cup',
    'doors', 'power outlet', 'hand towel', 'curtains', 'clock', 'pipes',
    'wall hanging', 'mouse', 'alarm clock', 'bathroom stall door',
    'closet doors', 'towel', 'grab bar', 'closet door', 'shower wall',
    'blackboard', 'paper towel dispenser', 'food display', 'mug', 'mat',
    'toilet paper holder', 'ceiling', 'whiteboard', 'bulletin board',
    'tissue box', 'mail', 'scale', 'rope', 'music book', 'mirror',
    'decoration', 'painting', 'shower', 'staircase', 'poster', 'pantry walls',
    'curtain', 'shower head', 'light', 'smoke detector', 'pipe', 'paper bag',
    'laundry detergent', 'stair rail', 'projector screen', 'cutting board',
    'stapler', 'divider', 'mirror doors', 'paper', 'board', 'hair brush',
    'hand sanitzer dispenser', 'controller', 'plate', 'flip flops', 'shoe',
    'door', 'soap dish', 'toilet flush button', 'picture', 'power strip',
    'wall',
])


def filter_obbs(
    obbs: np.ndarray,
    labels: Sequence[str],
    min_pts: np.ndarray,
    max_pts: np.ndarray,
    resolution: np.ndarray,
    min_size: float = 8.0,
    excluded_labels: Optional[frozenset] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Rescale world-space OBBs into grid coordinates and filter.

    Mirrors filter_bbox.py:26-59: the scene bounds are the min/max over all
    instances' AABB corners; centers and sizes map linearly onto the
    [0, resolution) grid (per-axis anisotropic scale — the reference applies
    it to the rotated w/l/h directly, an approximation we reproduce for
    parity); boxes with an excluded label or min(w, l, h) < min_size are
    dropped.

    Returns (filtered_obbs [K, 7] in grid coords, keep mask [M] over input).
    """
    obbs = np.asarray(obbs, dtype=np.float64).copy()
    if obbs.ndim != 2 or obbs.shape[1] != 7:
        raise ValueError(f"filter_obbs expects [M, 7], got {obbs.shape}")
    if len(labels) != obbs.shape[0]:
        raise ValueError("labels / obbs length mismatch")
    excluded = (SCANNET_EXCLUDED_LABELS if excluded_labels is None
                else excluded_labels)

    min_pts = np.asarray(min_pts, dtype=np.float64).reshape(-1, 3)
    max_pts = np.asarray(max_pts, dtype=np.float64).reshape(-1, 3)
    bbox_min = min_pts.min(axis=0)
    bbox_max = max_pts.max(axis=0)
    res = np.asarray(resolution, dtype=np.float64)
    extent = bbox_max - bbox_min

    obbs[:, 3:6] = obbs[:, 3:6] / extent * res
    obbs[:, :3] = (obbs[:, :3] - bbox_min) / extent * res

    keep = np.ones(obbs.shape[0], dtype=bool)
    for i, lab in enumerate(labels):
        if lab in excluded or obbs[i, 3:6].min() < min_size:
            keep[i] = False
    return obbs[keep], keep
