"""Hand-written CUDA snapshot kernel (``csrc/snapshot.cu``) and its wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/snapshot/kernel.py::snapshot``:
per chunk of a (n_chunks, wpc) word matrix, the Fletcher digest, the dirty
flag against the previous digest table (device-resident) and the 16-bin
nibble histogram, in one read of the words.  Bound by device-memory bytes
without the histogram; with it, by the per-thread shared-memory nibble
counts.  See the source for the design.

``snapshot_chunks_cuda.launches`` counts the kernel launches of this
process.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.checksum.kernel import _as_words
from repro_torch.kernels.snapshot.ref import META_COLS

_count_lock = threading.Lock()


def snapshot_chunks_cuda(words2: torch.Tensor, prev: torch.Tensor, *,
                         with_hist: bool = True) -> torch.Tensor:
    """Fused ``[s1, s2, dirty, hist…]`` (int32 bits) of a CUDA (n_chunks,
    wpc) word matrix against its (n_chunks, 2) previous digests.  Raises for
    a tensor that is not on a CUDA device."""
    if words2.device.type != "cuda" or prev.device != words2.device:
        raise ValueError(f"snapshot_chunks_cuda: words and prev must share a "
                         f"CUDA device, got {words2.device} / {prev.device}")
    w = _as_words(words2, 2, "snapshot_chunks_cuda")
    p = _as_words(prev, 2, "snapshot_chunks_cuda prev")
    n_chunks, wpc = w.shape
    if tuple(p.shape) != (n_chunks, 2):
        raise TypeError(f"expected ({n_chunks}, 2) prev digests, got "
                        f"{tuple(p.shape)}")
    if n_chunks == 0 or wpc == 0:
        raise ValueError(f"snapshot_chunks_cuda: empty word matrix "
                         f"{tuple(w.shape)}")
    out = torch.zeros((n_chunks, META_COLS if with_hist else 3),
                      dtype=torch.int32, device=w.device)
    lib = _build.load("snapshot")
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        rc = lib.craft_snapshot(w.data_ptr(), p.data_ptr(), out.data_ptr(),
                                n_chunks, wpc, int(bool(with_hist)), stream)
    _build.check(rc, "snapshot_chunks_cuda")
    with _count_lock:
        snapshot_chunks_cuda.launches += 1
    return out


snapshot_chunks_cuda.launches = 0
