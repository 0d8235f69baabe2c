"""Selective scans (mamba1/mamba2): hand-written CUDA kernels, plain
versions, ops."""
