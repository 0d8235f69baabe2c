"""Blocked (flash) attention: hand-written CUDA kernel, plain version, ops."""
