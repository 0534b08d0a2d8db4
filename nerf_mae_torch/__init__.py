"""nerf_mae_torch: the PyTorch / CUDA port of nerf_mae_tpu for NVIDIA Hopper.

Imports torch, numpy and the standard library only; the JAX package stays
the reference. Entry points run on the CUDA card unless the caller passes
device="cpu".
"""
