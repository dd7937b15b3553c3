"""Kernel library of the port: each op with a hand-written CUDA kernel
(csrc/) and a plain PyTorch version beside it."""
