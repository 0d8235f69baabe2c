"""Public snapshot ops: fused per-chunk metadata dispatched on the tensor's
device, plus the host-side helpers that turn raw nibble histograms into
compressibility estimates (the zstd-vs-raw gate, ``CRAFT_ZSTD_GATE_BITS``)."""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from repro_torch.kernels.snapshot.kernel import snapshot_chunks_cuda
from repro_torch.kernels.snapshot.ref import HIST_BINS, META_COLS, snapshot_ref

__all__ = ["HIST_BINS", "META_COLS", "snapshot_chunks", "snapshot_host",
           "chunk_entropy_bits", "host_nibble_hist"]


def snapshot_chunks(words2: torch.Tensor, prev_digests: torch.Tensor, *,
                    with_hist: bool = True) -> torch.Tensor:
    """Fused per-chunk ``[s1, s2, dirty, hist…]`` (int32 bits) of a
    (n_chunks, wpc) word matrix: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor.  The result stays on the words' device;
    callers keep the digest columns there as the next ``prev_digests``."""
    if words2.device.type == "cuda":
        return snapshot_chunks_cuda(words2, prev_digests, with_hist=with_hist)
    if words2.device.type == "cpu":
        return snapshot_ref(words2, prev_digests, with_hist=with_hist)
    raise ValueError(f"snapshot_chunks: unsupported device {words2.device}")


_weights_cache: dict = {}


def _word_weights(wpc: int) -> np.ndarray:
    w = _weights_cache.get(wpc)
    if w is None:
        w = _weights_cache[wpc] = np.arange(1, wpc + 1, dtype=np.uint32)
    return w


def snapshot_host(host_bytes: np.ndarray, chunk_bytes: int,
                  prev_digests: np.ndarray) -> np.ndarray:
    """Numpy snapshot pass: per-chunk ``[s1, s2, dirty]`` of a flat uint8
    buffer over the storage chunk grid (no histogram — the zstd gate falls
    back to per-dirty-chunk host counts).  The host twin of the fused
    kernel for shards that already live in host memory."""
    nbytes = host_bytes.size
    if nbytes % 4:
        raise ValueError(f"snapshot_host needs 4-byte-aligned size, "
                         f"got {nbytes}")
    words = host_bytes.view(np.uint32)
    wpc = chunk_bytes // 4
    n_chunks = max(1, -(-nbytes // chunk_bytes))
    full = words.size // wpc          # complete chunks; the rest is tail
    out = np.zeros((n_chunks, 3), dtype=np.uint32)
    if full:
        body = words[:full * wpc].reshape(full, wpc)
        with np.errstate(over="ignore"):
            out[:full, 0] = body.sum(axis=1, dtype=np.uint32)
            out[:full, 1] = (body * _word_weights(wpc)).sum(
                axis=1, dtype=np.uint32)
    tail = words[full * wpc:]
    if tail.size:        # zero-padding is digest-neutral, so weigh as-is
        with np.errstate(over="ignore"):
            out[-1, 0] = tail.sum(dtype=np.uint32)
            out[-1, 1] = (tail * _word_weights(wpc)[:tail.size]).sum(
                dtype=np.uint32)
    out[:, 2] = (out[:, :2] != prev_digests).any(axis=1)
    return out


def chunk_entropy_bits(hist: np.ndarray) -> np.ndarray:
    """Per-chunk order-0 entropy estimate in bits/byte from (n, 16) nibble
    histograms (each byte contributes its high and its low nibble, so a
    chunk's counts sum to ``2 * chunk_len``)."""
    h = np.asarray(hist, dtype=np.float64)
    tot = h.sum(axis=1, keepdims=True)
    p = np.divide(h, tot, out=np.zeros_like(h), where=tot > 0)
    logp = np.log2(p, out=np.zeros_like(p), where=p > 0)
    return -2.0 * (p * logp).sum(axis=1)


def host_nibble_hist(buf: Union[bytes, bytearray, memoryview, np.ndarray]
                     ) -> np.ndarray:
    """(16,) nibble histogram of a byte buffer — the host fallback of the
    kernel's histogram columns, for gating chunks that never saw a device."""
    a = (np.frombuffer(buf, dtype=np.uint8)
         if isinstance(buf, (bytes, bytearray, memoryview))
         else np.ascontiguousarray(buf).view(np.uint8).ravel())
    if a.size == 0:
        return np.zeros(HIST_BINS, dtype=np.int64)
    return (np.bincount(a >> 4, minlength=HIST_BINS)
            + np.bincount(a & 0xF, minlength=HIST_BINS)).astype(np.int64)
