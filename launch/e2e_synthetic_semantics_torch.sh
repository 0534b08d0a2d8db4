#!/bin/bash
# End-to-end VoxelSemantics on one CUDA card (the PyTorch port): MAE-pretrain -> graft trunk ->
# semantics-finetune vs identical scratch -> eval mIoU on a held-out draw
# (reference: nerf_rpn/run_voxel_semantics.py:926-958).
# Results land in $OUT/eval_{mae,scratch}.json; PERF.md records them with the card's name and power
# limit. Mirrors launch/e2e_synthetic_semantics.sh, the JAX recipe.
set -euo pipefail
cd "$(dirname "$0")/.."

OUT=${OUT:-runs/e2e_synthetic_sem_torch}
RES=${RES:-64}
BB=${BB:-swin_s}
N_CLASSES=${N_CLASSES:-6}
N_SCENES=${N_SCENES:-128}
N_FT=${N_FT:-16}
N_VAL=${N_VAL:-16}
MAE_STEPS=${MAE_STEPS:-800}
SEM_STEPS=${SEM_STEPS:-400}
BATCH=${BATCH:-8}
DEVICE=${DEVICE:-cuda}   # DEVICE=cpu rehearses the recipe at a tiny size
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader 2>/dev/null || true

echo "=== 1/4: MAE pretrain ($MAE_STEPS steps @ $RES^3) ==="
python -m nerf_mae_torch.run_mae_pretrain --mode train --device "$DEVICE" --dataset synthetic --transfer_dtype bfloat16 \
    --n_synthetic "$N_SCENES" --backbone_type "$BB" --resolution "$RES" \
    --batch_size "$BATCH" --steps "$MAE_STEPS" --lr 1e-4 \
    --checkpoint_dir "$OUT/mae" --eval_interval 100000 \
    --ckpt_interval 100000 --log_interval 50

echo "=== 2/4: VoxelSemantics finetune from the MAE trunk ==="
python -m nerf_mae_torch.run_voxel_semantics --mode train --device "$DEVICE" --dataset synthetic --transfer_dtype bfloat16 \
    --n_synthetic "$N_FT" --seed 77 --backbone_type "$BB" \
    --resolution "$RES" --num_classes "$N_CLASSES" \
    --batch_size "$BATCH" --steps "$SEM_STEPS" --lr 3e-4 \
    --mae_checkpoint "$OUT/mae" --checkpoint_dir "$OUT/sem_mae" \
    --eval_interval 100000 --ckpt_interval 100000 --log_interval 50

echo "=== 3/4: VoxelSemantics from scratch (same budget) ==="
python -m nerf_mae_torch.run_voxel_semantics --mode train --device "$DEVICE" --dataset synthetic --transfer_dtype bfloat16 \
    --n_synthetic "$N_FT" --seed 77 --backbone_type "$BB" \
    --resolution "$RES" --num_classes "$N_CLASSES" \
    --batch_size "$BATCH" --steps "$SEM_STEPS" --lr 3e-4 \
    --checkpoint_dir "$OUT/sem_scratch" \
    --eval_interval 100000 --ckpt_interval 100000 --log_interval 50

echo "=== 4/4: eval mIoU on the held-out draw ==="
python -m nerf_mae_torch.run_voxel_semantics --mode eval --device "$DEVICE" --dataset synthetic \
    --n_synthetic "$N_FT" --n_synthetic_val "$N_VAL" --seed 77 \
    --backbone_type "$BB" --resolution "$RES" --num_classes "$N_CLASSES" \
    --batch_size "$BATCH" --checkpoint "$OUT/sem_mae" \
    --eval_json "$OUT/eval_mae.json"
python -m nerf_mae_torch.run_voxel_semantics --mode eval --device "$DEVICE" --dataset synthetic \
    --n_synthetic "$N_FT" --n_synthetic_val "$N_VAL" --seed 77 \
    --backbone_type "$BB" --resolution "$RES" --num_classes "$N_CLASSES" \
    --batch_size "$BATCH" --checkpoint "$OUT/sem_scratch" \
    --eval_json "$OUT/eval_scratch.json"

echo "=== results ==="
OUT="$OUT" python - <<'EOF'
import json, os
out = os.environ.get("OUT", "runs/e2e_synthetic_sem_torch")
mae = json.load(open(f"{out}/eval_mae.json"))
scr = json.load(open(f"{out}/eval_scratch.json"))
for k in sorted(set(mae) & set(scr)):
    print(f"{k:>20}: mae={mae[k]:.4f} scratch={scr[k]:.4f}")
EOF
