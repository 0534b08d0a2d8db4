"""Evaluation on the host (counterpart of nerf_mae_tpu/eval)."""
