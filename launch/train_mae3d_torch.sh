#!/bin/bash
# MAE pretraining on a CUDA card (the PyTorch port): launch/train_mae3d.sh's
# flags, run by python -m nerf_mae_torch.run_mae_pretrain (DEVICE=cpu
# rehearses it on the CPU). Under torchrun (torchrun --nproc_per_node N -m
# nerf_mae_torch.run_mae_pretrain ...) it trains data-parallel, --batch_size
# being the global batch. To carry on a run of the JAX recipe, convert its
# newest step where it was written (python -m
# nerf_mae_torch.tools.orbax_to_npz <checkpoint_dir> --state --out state.npz)
# and pass --checkpoint state.npz.
set -e
DATA_ROOT=${DATA_ROOT:-dataset/front3d}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader 2>/dev/null || true
python -m nerf_mae_torch.run_mae_pretrain \
  --device "${DEVICE:-cuda}" \
  --mode train \
  --dataset front3d \
  --features_path "$DATA_ROOT/features" \
  --dataset_split "$DATA_ROOT/3dfront_split.npz" \
  --backbone_type swin_s \
  --resolution 160 --masking_prob 0.75 --masking_strategy random \
  --batch_size 32 --num_epochs 2000 \
  --lr 1e-4 --weight_decay 1e-3 --clip_grad_norm 0.1 \
  --flip_prob 0.5 --rotate_prob 0.5 \
  --log_interval 10 --eval_interval 200 --ckpt_interval 500 \
  --checkpoint_dir checkpoints/mae_swin_s --log_dir logs "$@"
