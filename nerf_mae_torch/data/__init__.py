"""The port's data: scene datasets and the training feed (counterpart of
nerf_mae_tpu/data/).

- `datasets`: scenes on disk and synthetic, their augments, and the batch
  iterators, which assemble scenes on a thread pool (`workers=`);
- `native`: the C++ collate (pad-to-cube, fused pad + patchify, flips,
  rot90, rotate + scale), built with g++ at first use, numpy without it;
- `pipeline`: the prefetch thread and the scene pool;
- `device_cache`: the corpus held on the card, batches as device gathers.

common.make_train_batches wires them behind the drivers' --workers,
--prefetch, --transfer_dtype and --device_data.
"""

from nerf_mae_torch.data.datasets import (
    ConcatDataset,
    GeneralDataset,
    SceneDataset,
    _trilinear_gather_zeros,
    apply_augment,
    augment_scene,
    density_to_alpha,
    detection_batch_iterator,
    draw_augment,
    load_split,
    mae_batch_iterator,
    pad_boxes,
    pad_to_cube,
    rotate_and_scale_scene,
    scannet_density_to_alpha,
    split_hypersim_dataset,
    synthetic_detection_scenes,
    synthetic_scenes,
)
from nerf_mae_torch.data.pipeline import PrefetchIterator, ScenePool, prefetch

__all__ = [
    "ConcatDataset", "GeneralDataset", "PrefetchIterator", "SceneDataset", "ScenePool",
    "apply_augment", "augment_scene", "density_to_alpha", "detection_batch_iterator",
    "draw_augment", "load_split", "mae_batch_iterator", "pad_boxes", "pad_to_cube",
    "prefetch", "rotate_and_scale_scene", "scannet_density_to_alpha",
    "split_hypersim_dataset", "synthetic_detection_scenes", "synthetic_scenes",
]
