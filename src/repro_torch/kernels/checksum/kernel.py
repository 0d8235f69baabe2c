"""Hand-written CUDA checksum kernel (``csrc/checksum.cu``) and its wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/checksum/kernel.py::checksum``
and its batched jnp form ``repro/kernels/checksum/ops.py::_rows_checksum``:
one kernel digests every row of a (rows, wpc) word matrix; a 1-D digest is
rows = 1.  The pass is bound by device-memory bytes (each word is read once
for three integer operations); see the source for the block design.

``checksum_rows.launches`` counts the kernel launches of this process.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def _as_words(x: torch.Tensor, ndim: int, what: str) -> torch.Tensor:
    if x.dtype not in (torch.int32, torch.uint32) or x.dim() != ndim:
        raise TypeError(f"{what}: expected {ndim}-D int32/uint32 words, got "
                        f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: words must be contiguous")
    return x.view(torch.int32)


def checksum_rows(words2: torch.Tensor) -> torch.Tensor:
    """Per-row ``[s1, s2]`` of a CUDA (rows, wpc) uint32 word matrix (int32
    bit view accepted); returns a (rows, 2) int32 tensor holding the uint32
    bits.  Raises for a tensor that is not on a CUDA device."""
    if words2.device.type != "cuda":
        raise ValueError(f"checksum_rows: CUDA tensor expected, got "
                         f"{words2.device}")
    w = _as_words(words2, 2, "checksum_rows")
    rows, wpc = w.shape
    out = torch.zeros((rows, 2), dtype=torch.int32, device=w.device)
    if rows == 0 or wpc == 0:
        return out
    lib = _build.load("checksum")
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        rc = lib.craft_checksum_rows(w.data_ptr(), out.data_ptr(), rows, wpc,
                                     stream)
    _build.check(rc, "checksum_rows")
    _build.count_launch(checksum_rows)
    return out


checksum_rows.launches = 0
