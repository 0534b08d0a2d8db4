#!/bin/bash
# Voxel semantic segmentation, 19 Front3D classes on a CUDA card (the PyTorch
# port): launch/train_voxel_semantics.sh's flags, run by python -m
# nerf_mae_torch.run_voxel_semantics (DEVICE=cpu rehearses it on the CPU).
# Under torchrun (torchrun --nproc_per_node N -m
# nerf_mae_torch.run_voxel_semantics ...) it trains data-parallel,
# --batch_size being the global batch. To carry on a run of the JAX recipe,
# convert its newest step where it was written (python -m
# nerf_mae_torch.tools.orbax_to_npz <checkpoint_dir> --state --out state.npz)
# and pass --checkpoint state.npz.
set -e
DATA_ROOT=${DATA_ROOT:-dataset/front3d_sem}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader 2>/dev/null || true
python -m nerf_mae_torch.run_voxel_semantics \
  --device "${DEVICE:-cuda}" \
  --mode train --dataset front3d \
  --features_path "$DATA_ROOT/features" \
  --sem_feat_path "$DATA_ROOT/sem_voxels" \
  --dataset_split "$DATA_ROOT/3dfront_split.npz" \
  --mae_checkpoint checkpoints/mae_swin_s \
  --backbone_type swin_s --resolution 160 --num_classes 19 \
  --class_weights "$DATA_ROOT/class_weights.npy" \
  --batch_size 8 --num_epochs 500 --lr 1e-4 --weight_decay 1e-3 \
  --checkpoint_dir checkpoints/voxel_semantics "$@"
