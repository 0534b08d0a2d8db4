"""The benchmark of nerf_mae_torch on one NVIDIA H100 (see README.md)."""
