"""Kernels of the PyTorch port: hand-written CUDA with plain PyTorch twins."""
