#!/bin/bash
# Anchor-based RPN on a CUDA card (the PyTorch port): launch/train_rpn.sh's
# flags, run by python -m nerf_mae_torch.run_rpn (DEVICE=cpu rehearses it on
# the CPU). Under torchrun (torchrun --nproc_per_node N -m
# nerf_mae_torch.run_rpn ...) it trains data-parallel, --batch_size being the
# global batch. To carry on a run of the JAX recipe, convert its newest step
# where it was written (python -m nerf_mae_torch.tools.orbax_to_npz
# <checkpoint_dir> --state --out state.npz) and pass --checkpoint state.npz.
set -e
DATA_ROOT=${DATA_ROOT:-dataset/front3d_rpn}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader 2>/dev/null || true
python -m nerf_mae_torch.run_rpn \
  --device "${DEVICE:-cuda}" \
  --mode train --dataset front3d \
  --features_path "$DATA_ROOT/features" \
  --boxes_path "$DATA_ROOT/aabb" \
  --dataset_split "$DATA_ROOT/3dfront_split.npz" \
  --mae_checkpoint checkpoints/mae_swin_s \
  --backbone_type swin_s --resolution 160 \
  --batch_size 8 --num_epochs 1000 --lr 3e-4 --weight_decay 1e-3 \
  --checkpoint_dir checkpoints/rpn "$@"
