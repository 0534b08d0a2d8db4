"""Tensor ops of the port: numpy helpers, plain PyTorch ops and the
wrappers of the hand-written CUDA kernels."""
