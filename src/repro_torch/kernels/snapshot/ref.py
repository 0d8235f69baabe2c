"""Plain PyTorch version of the fused snapshot pass.

One pass over a (n_chunks, wpc) uint32 word matrix gives, per chunk (row):

    s1      = sum_j x[j]                      (mod 2^32)
    s2      = sum_j (j + 1) * x[j]            (mod 2^32)
    dirty   = (s1 != prev_s1) | (s2 != prev_s2)
    hist[k] = # of nibbles (both 4-bit halves of every byte) equal to k

as uint32 columns ``[s1, s2, dirty, hist[0..15]]`` (just the first three
with ``with_hist=False``), returned as int32 bits.  The digest columns equal
the checksum of the same words.  Sums run in int64 on the unsigned values,
masked to 32 bits, over bounded row blocks (see ``checksum.ref``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.checksum.ref import (digest_rows_i64, row_blocks,
                                              to_i32, u32)

HIST_BINS = 16
META_COLS = 3 + HIST_BINS       # [s1, s2, dirty, hist[0..15]]
_SHIFTS = tuple(range(0, 32, 4))


def _nibble_hist(w: torch.Tensor) -> torch.Tensor:
    """(r, 16) int64 nibble counts of a (r, wpc) int64 value block."""
    r = w.shape[0]
    row_off = (torch.arange(r, device=w.device) * HIST_BINS)[:, None]
    counts = torch.zeros(r * HIST_BINS, dtype=torch.int64, device=w.device)
    for sh in _SHIFTS:
        nib = ((w >> sh) & 0xF) + row_off
        counts += torch.bincount(nib.reshape(-1), minlength=r * HIST_BINS)
    return counts.reshape(r, HIST_BINS)


def snapshot_ref(words2: torch.Tensor, prev: torch.Tensor, *,
                 with_hist: bool = True) -> torch.Tensor:
    """Fused per-chunk metadata of a (n_chunks, wpc) uint32 (or int32-bit-
    view) word matrix against the (n_chunks, 2) previous digests."""
    if words2.dim() != 2 or words2.dtype not in (torch.int32, torch.uint32):
        raise TypeError(f"expected 2-D int32/uint32 words, got "
                        f"{tuple(words2.shape)} {words2.dtype}")
    rows, wpc = words2.shape
    if tuple(prev.shape) != (rows, 2) or prev.dtype not in (torch.int32,
                                                            torch.uint32):
        raise TypeError(f"expected ({rows}, 2) int32/uint32 prev digests, "
                        f"got {tuple(prev.shape)} {prev.dtype}")
    width = META_COLS if with_hist else 3
    out = torch.zeros((rows, width), dtype=torch.int64, device=words2.device)
    pv = u32(prev)
    for r0, r1 in row_blocks(rows, wpc):
        w = u32(words2[r0:r1])
        dig = digest_rows_i64(w)
        out[r0:r1, :2] = dig
        out[r0:r1, 2] = (dig != pv[r0:r1]).any(dim=1).to(torch.int64)
        if with_hist:
            out[r0:r1, 3:] = _nibble_hist(w)
    return to_i32(out)
