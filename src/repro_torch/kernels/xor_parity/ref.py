"""Plain PyTorch version of the XOR-parity kernel.

The parity of a group of equal-length word buffers is the elementwise XOR
across the group axis; rebuilding a lost member is the same reduction over
(parity, survivors), XOR being its own inverse.  torch's ``uint32`` lacks
bitwise kernels on the CPU, so the words are XORed as their int32 bit
views (the bits are the same).
"""
from __future__ import annotations

import functools

import torch


def xor_reduce_ref(stacked: torch.Tensor) -> torch.Tensor:
    """XOR-reduce a ``(G, N)`` uint32 (or int32-bit-view) word matrix over
    axis 0; returns an ``(N,)`` int32 tensor holding the uint32 bits."""
    if stacked.dim() != 2 or stacked.dtype not in (torch.int32, torch.uint32):
        raise TypeError(f"expected 2-D int32/uint32 words, got "
                        f"{tuple(stacked.shape)} {stacked.dtype}")
    if stacked.shape[0] == 0:
        raise ValueError("empty parity group")
    words = stacked.view(torch.int32)
    return functools.reduce(torch.bitwise_xor,
                            [words[g] for g in range(words.shape[0])]).clone()
