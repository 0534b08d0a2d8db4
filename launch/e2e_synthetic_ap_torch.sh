#!/bin/bash
# End-to-end §3.2 call stack on one CUDA card (the PyTorch port), synthetic-at-scale:
# MAE-pretrain -> graft trunk -> FCOS-finetune -> eval AP, against an
# identical FCOS trained from scratch — the paper's core claim is that the
# MAE trunk beats scratch (reference: README.md:205,
# nerf_rpn/run_fcos_pretrained.py:714-960). Results land in
# $OUT/eval_{mae,scratch}.json; PERF.md records the numbers with the card's name and
# power limit. Mirrors launch/e2e_synthetic_ap.sh, the JAX recipe.
set -euo pipefail
cd "$(dirname "$0")/.."

OUT=${OUT:-runs/e2e_synthetic_torch}
RES=${RES:-96}
BB=${BB:-swin_s}
N_SCENES=${N_SCENES:-128}     # unlabeled pretraining corpus
N_FT=${N_FT:-12}              # low-data finetune: the paper's claim regime
N_VAL=${N_VAL:-24}            # held-out eval draw
MAE_STEPS=${MAE_STEPS:-1500}
DET_STEPS=${DET_STEPS:-500}
BATCH=${BATCH:-8}
DEVICE=${DEVICE:-cuda}   # DEVICE=cpu rehearses the recipe at a tiny size
HARD=${HARD---synthetic_hard}   # export HARD= to opt out  # clutter slabs/debris + small faint objects
DEVDATA=${DEVDATA---device_data}   # export DEVDATA= to stream from host instead
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader 2>/dev/null || true

if [ -z "${SKIP_MAE:-}" ]; then
echo "=== 1/4: MAE pretrain ($MAE_STEPS steps @ $RES^3, $N_SCENES scenes) ==="
python -m nerf_mae_torch.run_mae_pretrain --mode train --device "$DEVICE" --dataset synthetic --transfer_dtype bfloat16 $DEVDATA $HARD \
    --n_synthetic "$N_SCENES" --backbone_type "$BB" --resolution "$RES" \
    --batch_size "$BATCH" --steps "$MAE_STEPS" --lr 1e-4 \
    --checkpoint_dir "$OUT/mae" --eval_interval 100000 \
    --ckpt_interval 100000 --log_interval 50
else
echo "=== 1/4: SKIP_MAE set — resuming from existing $OUT/mae checkpoint ==="
fi

echo "=== 2/4: FCOS finetune from the MAE trunk ($N_FT scenes) ==="
python -m nerf_mae_torch.run_fcos --mode train --device "$DEVICE" --dataset synthetic --transfer_dtype bfloat16 $DEVDATA $HARD \
    --n_synthetic "$N_FT" --seed 77 --backbone_type "$BB" --resolution "$RES" \
    --batch_size "$BATCH" --steps "$DET_STEPS" --lr 3e-4 \
    --mae_checkpoint "$OUT/mae" --checkpoint_dir "$OUT/fcos_mae" \
    --eval_interval 100000 --ckpt_interval 100000 --log_interval 50

echo "=== 3/4: FCOS from scratch (same budget, same $N_FT scenes) ==="
python -m nerf_mae_torch.run_fcos --mode train --device "$DEVICE" --dataset synthetic --transfer_dtype bfloat16 $DEVDATA $HARD \
    --n_synthetic "$N_FT" --seed 77 --backbone_type "$BB" --resolution "$RES" \
    --batch_size "$BATCH" --steps "$DET_STEPS" --lr 3e-4 \
    --checkpoint_dir "$OUT/fcos_scratch" \
    --eval_interval 100000 --ckpt_interval 100000 --log_interval 50

echo "=== 4/4: eval both on the held-out draw ($N_VAL scenes) ==="
python -m nerf_mae_torch.run_fcos --mode eval --device "$DEVICE" --dataset synthetic $HARD \
    --n_synthetic "$N_FT" --n_synthetic_val "$N_VAL" --seed 77 \
    --backbone_type "$BB" --resolution "$RES" \
    --batch_size "$BATCH" --checkpoint "$OUT/fcos_mae" \
    --eval_json "$OUT/eval_mae.json"
python -m nerf_mae_torch.run_fcos --mode eval --device "$DEVICE" --dataset synthetic $HARD \
    --n_synthetic "$N_FT" --n_synthetic_val "$N_VAL" --seed 77 \
    --backbone_type "$BB" --resolution "$RES" \
    --batch_size "$BATCH" --checkpoint "$OUT/fcos_scratch" \
    --eval_json "$OUT/eval_scratch.json"

echo "=== results ==="
OUT="$OUT" python - <<'EOF'
import json, os
out = os.environ.get("OUT", "runs/e2e_synthetic_torch")
mae = json.load(open(f"{out}/eval_mae.json"))
scr = json.load(open(f"{out}/eval_scratch.json"))
for k in sorted(set(mae) & set(scr)):
    print(f"{k:>28}: mae={mae[k]:.4f} scratch={scr[k]:.4f}")
EOF
