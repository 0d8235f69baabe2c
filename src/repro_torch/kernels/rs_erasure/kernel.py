"""Hand-written CUDA GF(2^8) matmul kernel (``csrc/rs_erasure.cu``) and its
wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/rs_erasure/kernel.py::
gf_matmul``: ``out[r] = XOR_i M[r][i]·x_i`` over GF(2^8) (poly 0x11B) on
(G, N) words that pack four field elements each.  The Pallas kernel is
traced once per static matrix; here the (R, G) byte matrix is a runtime
argument, copied to the card with each call and held in shared memory.
Bound by device-memory bytes for the node tier's matrices; see the source
for the design.

``gf_matmul_cuda.launches`` counts the kernel launches of this process.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.checksum.kernel import _as_words

MAX_COEF = 4096     # R * G bytes the kernel holds in shared memory


def gf_matmul_cuda(stacked: torch.Tensor, matrix) -> torch.Tensor:
    """GF(2^8) product of an ``(R, G)`` byte matrix with a CUDA ``(G, N)``
    uint32 word matrix (int32 bit view accepted); returns ``(R, N)`` int32
    words holding the uint32 bits.  Raises for a tensor that is not on a
    CUDA device and for a matrix the kernel cannot hold."""
    w = _as_words(stacked, 2, "gf_matmul_cuda")
    g, n = w.shape
    mat = np.asarray(matrix)
    if mat.ndim != 2 or mat.shape[1] != g or mat.shape[0] == 0 or g == 0:
        raise ValueError(f"gf_matmul_cuda: matrix {mat.shape} does not "
                         f"match G={g}")
    if mat.size and (mat.min() < 0 or mat.max() > 255):
        raise ValueError("gf_matmul_cuda: matrix entries must be GF(2^8) "
                         "bytes (0..255)")
    r = mat.shape[0]
    if r * g > MAX_COEF:
        raise ValueError(f"gf_matmul_cuda: a ({r}, {g}) matrix has {r * g} "
                         f"coefficients; the kernel holds at most {MAX_COEF}")
    if w.device.type != "cuda":
        raise ValueError(f"gf_matmul_cuda: CUDA tensor expected, got "
                         f"{w.device}")
    out = torch.empty((r, n), dtype=torch.int32, device=w.device)
    if n == 0:
        return out
    coef = torch.from_numpy(np.ascontiguousarray(mat, dtype=np.uint8)).to(
        w.device)
    lib = _build.load("rs_erasure")
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        rc = lib.craft_gf_matmul(w.data_ptr(), coef.data_ptr(),
                                 out.data_ptr(), r, g, n, stream)
    _build.check(rc, "gf_matmul_cuda")
    _build.count_launch(gf_matmul_cuda)
    return out


gf_matmul_cuda.launches = 0
