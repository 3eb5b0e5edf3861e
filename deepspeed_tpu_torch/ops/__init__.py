"""Kernels of the port (CUDA sources in ../csrc) and their plain PyTorch versions."""
