"""Plain PyTorch version of the Reed–Solomon GF(2^8) matmul kernel.

The erasure code works in GF(2^8) with the AES reduction polynomial
``x^8 + x^4 + x^3 + x + 1`` (0x11B).  Addition is XOR; multiplication here
is the classic log/exp table lookup with generator 3 (``a·b = exp[log a +
log b]``, the exp table doubled so the index sum needs no mod-255).  The
CUDA kernel computes the *same field product* without tables (bit-serial
xtime chains on packed words, see ``csrc/rs_erasure.cu``); the two must
agree bit for bit.

The tables are built once at import with plain numpy and exposed both as
numpy (host-side matrix algebra in ``ops.py``) and as torch tensors (this
version, which indexes them with ``.long()`` on uint8 bytes — torch has no
``>>`` on uint32 on the CPU, so it never works on packed words).
"""
from __future__ import annotations

import numpy as np
import torch

_POLY = 0x11B      # AES field: x^8 + x^4 + x^3 + x + 1
_GENERATOR = 3     # 2 is not primitive mod 0x11B; 3 is


def _build_tables():
    exp = np.zeros(510, dtype=np.uint8)
    log = np.zeros(256, dtype=np.uint8)   # log[0] is undefined (guarded)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        # multiply by the generator 3: x*2 ^ x, reduced by the field poly
        x2 = x << 1
        if x2 & 0x100:
            x2 ^= _POLY
        x = x2 ^ x
    exp[255:] = exp[:255]                 # doubled: no mod on log sums
    return exp, log


GF_EXP, GF_LOG = _build_tables()
_GF_EXP_T = torch.from_numpy(GF_EXP.copy())
_GF_LOG_T = torch.from_numpy(GF_LOG.astype(np.int64))


def gf_matmul_ref(stacked: torch.Tensor, matrix) -> torch.Tensor:
    """GF(2^8) matrix product of a byte matrix with stacked byte buffers.

    ``stacked`` is ``(G, N) uint8`` (one row per group member), ``matrix``
    a nested sequence/array of shape ``(R, G)`` with entries in 0..255.
    Returns ``(R, N) uint8`` where ``out[r] = XOR_i matrix[r][i] ·
    stacked[i]``.
    """
    if stacked.dim() != 2:
        raise ValueError(f"expected (G, N), got {tuple(stacked.shape)}")
    if stacked.dtype != torch.uint8:
        raise TypeError(f"expected uint8, got {stacked.dtype}")
    mat = np.asarray(matrix, dtype=np.uint8)
    if mat.ndim != 2 or mat.shape[1] != stacked.shape[0]:
        raise ValueError(f"matrix {mat.shape} does not match "
                         f"G={stacked.shape[0]}")
    exp_t = _GF_EXP_T.to(stacked.device)
    log_t = _GF_LOG_T.to(stacked.device)
    rows = []
    for r in range(mat.shape[0]):
        acc = torch.zeros(stacked.shape[1], dtype=torch.uint8,
                          device=stacked.device)
        for i in range(mat.shape[1]):
            c = int(mat[r, i])
            if c == 0:
                continue
            if c == 1:
                acc = acc ^ stacked[i]
                continue
            prod = exp_t[int(GF_LOG[c]) + log_t[stacked[i].long()]]
            prod = torch.where(stacked[i] == 0, torch.zeros_like(prod), prod)
            acc = acc ^ prod
        rows.append(acc)
    return torch.stack(rows)
