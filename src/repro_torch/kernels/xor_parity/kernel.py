"""Hand-written CUDA XOR-parity kernel (``csrc/xor_parity.cu``) and its
wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/xor_parity/kernel.py::
xor_reduce``: the XOR over the group axis of a (G, N) word matrix, for the
node tier's XOR parity encode and single-loss rebuild.  Bound by
device-memory bytes (one XOR a word); see the source for the design.

``xor_reduce_cuda.launches`` counts the kernel launches of this process.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.checksum.kernel import _as_words


def xor_reduce_cuda(stacked: torch.Tensor) -> torch.Tensor:
    """XOR over axis 0 of a CUDA ``(G, N)`` uint32 word matrix (int32 bit
    view accepted); returns an ``(N,)`` int32 tensor holding the uint32
    bits.  Raises for a tensor that is not on a CUDA device."""
    if stacked.device.type != "cuda":
        raise ValueError(f"xor_reduce_cuda: CUDA tensor expected, got "
                         f"{stacked.device}")
    w = _as_words(stacked, 2, "xor_reduce_cuda")
    g, n = w.shape
    if g == 0:
        raise ValueError("xor_reduce_cuda: empty parity group")
    out = torch.empty(n, dtype=torch.int32, device=w.device)
    if n == 0:
        return out
    lib = _build.load("xor_parity")
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        rc = lib.craft_xor_reduce(w.data_ptr(), out.data_ptr(), g, n, stream)
    _build.check(rc, "xor_reduce_cuda")
    _build.count_launch(xor_reduce_cuda)
    return out


xor_reduce_cuda.launches = 0
