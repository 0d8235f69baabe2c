"""Plain PyTorch version of the checksum kernel.

Definition over each row ``x`` of a (rows, wpc) uint32 word matrix, mod 2^32:

    s1 = sum_j x[j]
    s2 = sum_j (j + 1) * x[j]

torch's uint32 is only partly supported (``uint32.sum()`` promotes to int64
without wrapping, ``>>`` raises on the CPU), so the sums run in int64 on the
words' unsigned values and are masked back to 32 bits.  Rows are processed
in blocks so the int64 temporaries stay bounded on large matrices.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_BLOCK_WORDS = 1 << 23          # int64 temporaries per row block


def u32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor of the unsigned values of int32/uint32 words."""
    return x.view(torch.int32).to(torch.int64) & MASK


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as an int32 tensor of the same bits."""
    x = x & MASK
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def row_blocks(rows: int, wpc: int):
    """Row ranges whose int64 temporaries stay within the block budget."""
    step = max(1, _BLOCK_WORDS // max(1, wpc))
    for r0 in range(0, rows, step):
        yield r0, min(rows, r0 + step)


def digest_rows_i64(w: torch.Tensor) -> torch.Tensor:
    """(r, 2) int64 ``[s1, s2]`` (masked) of a (r, wpc) int64 value block."""
    idx = torch.arange(1, w.shape[1] + 1, dtype=torch.int64, device=w.device)
    s1 = w.sum(dim=1) & MASK
    s2 = ((w * idx) & MASK).sum(dim=1) & MASK
    return torch.stack([s1, s2], dim=1)


def checksum_rows_ref(words2: torch.Tensor) -> torch.Tensor:
    """Per-row ``[s1, s2]`` of a (rows, wpc) uint32 (or int32-bit-view) word
    matrix, as a (rows, 2) int32 tensor holding the uint32 bits."""
    if words2.dim() != 2 or words2.dtype not in (torch.int32, torch.uint32):
        raise TypeError(f"expected 2-D int32/uint32 words, got "
                        f"{tuple(words2.shape)} {words2.dtype}")
    rows, wpc = words2.shape
    out = torch.zeros((rows, 2), dtype=torch.int32, device=words2.device)
    if wpc == 0:
        return out
    for r0, r1 in row_blocks(rows, wpc):
        out[r0:r1] = to_i32(digest_rows_i64(u32(words2[r0:r1])))
    return out
