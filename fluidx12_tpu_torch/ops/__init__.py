"""Tensor helpers and the CUDA kernels (ops/cuda)."""
