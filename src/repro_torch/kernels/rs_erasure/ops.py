"""Public ops for Reed–Solomon erasure coding: matrices, encode, decode.

The node tier groups k peers and stores m parity buffers (``CRAFT_RS_PARITY``)
so that **any** m simultaneously lost members are recoverable — the
generalization of the XOR tier's single-loss parity (``m=1`` here *is* XOR:
the coding matrix's first row is all ones).

Coding matrix.  ``rs_matrix(k, m)`` is a column-normalized Cauchy matrix
over GF(2^8): ``C[j][i] = 1 / (x_j ^ y_i)`` with distinct evaluation points,
columns scaled so row 0 is all ones.  Every square submatrix of a Cauchy
matrix is nonsingular, and row/column scaling preserves that, so the
systematic code [I; G] is MDS: any k of the k+m symbols reconstruct the
data, i.e. up to m erasures are always solvable.

Buffers are u32-lane padded exactly like the XOR ops (shared ``_pad_to_u32``
/ ``padded_len``) and the byte math runs where ``device`` says: the
hand-written CUDA kernel on a card, the log/exp-table plain version on the
CPU.  The tiny (≤ m×m) matrix inversion of the erasure solve runs on the
host in numpy.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.kernels.rs_erasure.kernel import gf_matmul_cuda
from repro_torch.kernels.rs_erasure.ref import GF_EXP, GF_LOG, gf_matmul_ref
from repro_torch.kernels.xor_parity.ops import (
    Device, _pad_to_u32, nbytes_of, padded_len, row_bytes, run_kernel,
    stack_on,
)

__all__ = ["GF_EXP", "GF_LOG", "_pad_to_u32", "padded_len", "gf_mul",
           "gf_inv", "rs_matrix", "gf_mat_inv", "gf_matmul", "encode_parity",
           "decode_lost"]


# --------------------------------------------------------------------------
# host-side GF(2^8) scalar/matrix algebra (tiny, numpy)
# --------------------------------------------------------------------------
def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(GF_EXP[int(GF_LOG[a]) + int(GF_LOG[b])])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("inverse of 0 in GF(2^8)")
    return int(GF_EXP[255 - int(GF_LOG[a])])


def rs_matrix(k: int, m: int) -> np.ndarray:
    """The (m, k) parity matrix: column-normalized Cauchy, row 0 all ones."""
    if k < 1 or m < 1:
        raise ValueError(f"need k >= 1 and m >= 1, got k={k} m={m}")
    if k + m > 256:
        raise ValueError(f"k + m must be <= 256 in GF(2^8), got {k + m}")
    ys = list(range(k))                   # data points: 0 .. k-1
    xs = [255 - j for j in range(m)]      # parity points: 255 .. 256-m
    cauchy = [[gf_inv(x ^ y) for y in ys] for x in xs]
    col_inv = [gf_inv(cauchy[0][i]) for i in range(k)]
    return np.array(
        [[gf_mul(cauchy[j][i], col_inv[i]) for i in range(k)]
         for j in range(m)],
        dtype=np.uint8,
    )


def gf_mat_inv(mat: np.ndarray) -> np.ndarray:
    """Invert a small GF(2^8) matrix (Gauss–Jordan; raises if singular)."""
    a = np.array(mat, dtype=np.uint8)
    n = a.shape[0]
    if a.shape != (n, n):
        raise ValueError(f"square matrix required, got {a.shape}")
    aug = np.concatenate([a, np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        pivot = next((r for r in range(col, n) if aug[r, col]), None)
        if pivot is None:
            raise ValueError("singular matrix over GF(2^8)")
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        inv = gf_inv(int(aug[col, col]))
        aug[col] = [gf_mul(inv, int(v)) for v in aug[col]]
        for r in range(n):
            if r != col and aug[r, col]:
                f = int(aug[r, col])
                aug[r] = [int(aug[r, c]) ^ gf_mul(f, int(aug[col, c]))
                          for c in range(2 * n)]
    return aug[:, n:]


# --------------------------------------------------------------------------
# bulk byte math: device dispatch
# --------------------------------------------------------------------------
def gf_matmul(stacked: torch.Tensor, matrix) -> torch.Tensor:
    """Apply an (R, G) byte matrix to a (G, W) word matrix; returns (R, W)
    int32 words.  The CUDA kernel for a CUDA tensor, the log/exp-table plain
    version for a CPU tensor — bit-identical by construction and by test."""
    if stacked.device.type == "cuda":
        return gf_matmul_cuda(stacked, matrix)
    if stacked.device.type != "cpu":
        raise ValueError(f"gf_matmul: unsupported device {stacked.device}")
    words = stacked.view(torch.int32).contiguous()
    out = gf_matmul_ref(words.view(torch.uint8), matrix)
    return out.view(torch.int32)


# --------------------------------------------------------------------------
# buffer-level encode / decode (what the node tier calls)
# --------------------------------------------------------------------------
def encode_parity(buffers: Sequence, m: int,
                  device: Device = "cuda") -> List[bytes]:
    """The m parity buffers of a k-member group (zero-padded to equal length).

    Each parity buffer is ``padded_len(max member size)`` bytes; row 0 is the
    plain XOR of the group (the m=1 code is the XOR tier's parity).
    """
    if not buffers:
        raise ValueError("empty erasure group")
    if m < 1:
        raise ValueError(f"need at least one parity buffer, got m={m}")
    n_pad = padded_len(max(nbytes_of(b) for b in buffers))
    stacked = stack_on(buffers, n_pad, device)
    parity = run_kernel(gf_matmul, stacked, rs_matrix(len(buffers), m))
    del stacked
    return [row_bytes(parity[j]) for j in range(m)]


def decode_lost(
    k: int,
    m: int,
    present: Dict[int, object],
    parities: Dict[int, object],
    sizes: Sequence[int],
    device: Device = "cuda",
) -> Dict[int, bytes]:
    """Rebuild the lost members of a group from survivors + parity buffers.

    ``present`` maps surviving member positions (0..k-1) to their payloads,
    ``parities`` maps available parity rows (0..m-1) to their buffers, and
    ``sizes`` gives every member's true byte length (from the parity
    manifest).  Any ``e = k - len(present)`` erasures are solvable as long
    as ``len(parities) >= e``; returns {lost position: exact original bytes}.

    Solve: with G the coding matrix, for each chosen parity row j the
    syndrome ``S_j = P_j  XOR  Σ_{i surviving} G[j][i]·D_i`` equals
    ``Σ_{i lost} G[j][i]·D_i``; the e×e submatrix of G over (chosen rows ×
    lost columns) is nonsingular (MDS), so the lost members are its inverse
    applied to the syndromes — a syndrome partial product, an XOR, and the
    inverse product, all on ``device``.
    """
    lost = sorted(set(range(k)) - set(present))
    if not lost:
        return {}
    rows = sorted(parities)[: len(lost)]
    if len(rows) < len(lost):
        raise ValueError(
            f"{len(lost)} members lost but only {len(parities)} parity "
            f"buffers available (m={m})"
        )
    if len(sizes) != k:
        raise ValueError(f"sizes must name all {k} members, got {len(sizes)}")
    g_mat = rs_matrix(k, m)
    n_pad = padded_len(max(sizes))
    surv = sorted(present)
    syndromes = stack_on([parities[j] for j in rows], n_pad, device)
    if surv:
        surv_stack = stack_on([present[i] for i in surv], n_pad, device)
        partial = run_kernel(gf_matmul, surv_stack, g_mat[np.ix_(rows, surv)])
        del surv_stack
        syndromes = syndromes ^ partial
        del partial
    a_inv = gf_mat_inv(g_mat[np.ix_(rows, lost)])
    rebuilt = run_kernel(gf_matmul, syndromes, a_inv)
    del syndromes
    return {pos: row_bytes(rebuilt[t])[: sizes[pos]]
            for t, pos in enumerate(lost)}
