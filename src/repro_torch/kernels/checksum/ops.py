"""Public checksum ops: byte-buffer digests dispatched on the device.

A tensor on a CUDA device goes to the hand-written kernel
(:func:`kernel.checksum_rows`) and nothing else: a failed build or launch
raises.  A CPU tensor goes to the plain version (:mod:`ref`).  Host bytes
are digested where ``device`` says: on CUDA they are copied to the card and
digested by the kernel (as the reference digests on the TPU); on the CPU
the identical modular sums run in numpy (``_rows_checksum_np``).
"""
from __future__ import annotations

import warnings
from typing import Tuple, Union

import numpy as np
import torch

from repro_torch.kernels.checksum.kernel import checksum_rows
from repro_torch.kernels.checksum.ref import checksum_rows_ref

Device = Union[str, torch.device]


def _is_cuda(device: Device) -> bool:
    return torch.device(device).type == "cuda"


def rows_checksum(words2: torch.Tensor) -> torch.Tensor:
    """Per-row ``[s1, s2]`` (int32 bits) of a (rows, wpc) word matrix: the
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if words2.device.type == "cuda":
        return checksum_rows(words2)
    if words2.device.type == "cpu":
        return checksum_rows_ref(words2)
    raise ValueError(f"rows_checksum: unsupported device {words2.device}")


def digest_array(x: torch.Tensor) -> Tuple[int, int]:
    """(s1, s2) digest of a 1-D uint32 (or int32-bit-view) word tensor."""
    if x.dim() != 1:
        raise TypeError(f"expected 1-D words, got {tuple(x.shape)}")
    s = rows_checksum(x.contiguous().reshape(1, -1))
    s1, s2 = (int(v) & 0xFFFFFFFF for v in s[0].tolist())
    return s1, s2


def _as_u8(buf) -> np.ndarray:
    return (
        np.frombuffer(buf, dtype=np.uint8)
        if isinstance(buf, (bytes, bytearray, memoryview))
        else np.ascontiguousarray(buf).view(np.uint8).ravel()
    )


def _to_device(words: np.ndarray, device: Device) -> torch.Tensor:
    """Copy host uint32 words (possibly a read-only view) to ``device``."""
    if words.ctypes.data % 4:       # a chunk cut at an odd byte offset
        words = words.copy()
    with warnings.catch_warnings():
        # read-only buffers are never written through: the copy reads them
        warnings.filterwarnings("ignore", message=".*not writable.*")
        host = torch.from_numpy(words.view(np.int32))
    return host.to(device)


def _rows_checksum_np(body: np.ndarray) -> list:
    """Host version of the per-row sums: numpy's wrapping uint32 arithmetic,
    no device copy."""
    idx = (np.arange(body.shape[1], dtype=np.uint32) + np.uint32(1))[None, :]
    with np.errstate(over="ignore"):
        s1 = np.sum(body, axis=1, dtype=np.uint32)
        s2 = np.sum(body * idx, axis=1, dtype=np.uint32)
    return [[int(a), int(b)] for a, b in zip(s1, s2)]


def _rows_digests(body: np.ndarray, device: Device) -> list:
    """``[[s1, s2], ...]`` of a (rows, wpc) host uint32 matrix on ``device``."""
    if _is_cuda(device):
        out = checksum_rows(_to_device(body, device)).cpu().numpy()
        return [[int(a), int(b)] for a, b in out.view(np.uint32)]
    return _rows_checksum_np(body)


def digest_bytes(buf: Union[bytes, bytearray, memoryview, np.ndarray],
                 device: Device = "cuda") -> Tuple[int, int]:
    """(s1, s2) digest of a raw byte buffer (zero-padded to 4-byte words)."""
    arr = _as_u8(buf)
    pad = (-arr.size) % 4
    if pad:
        arr = np.concatenate([arr, np.zeros(pad, dtype=np.uint8)])
    words = arr.view(np.uint32).reshape(1, -1)
    s1, s2 = _rows_digests(words, device)[0]
    return s1, s2


def digest_chunks(buf: Union[bytes, bytearray, np.ndarray],
                  chunk_bytes: int, device: Device = "cuda") -> list:
    """Per-chunk (s1, s2) digests of ``buf`` split every ``chunk_bytes``.

    Bit-identical to ``digest_bytes(chunk)`` on each slice (zero padding is
    digest-neutral), but the full-size chunks go through **one** batched
    pass instead of one call per chunk.  The ragged tail chunk (if any) is
    digested separately.  Returns ``[[s1, s2], ...]``.
    """
    arr = _as_u8(buf)
    chunk_bytes = int(chunk_bytes)
    if arr.size == 0:
        return []
    if chunk_bytes % 4:
        # word grid doesn't tile the chunk grid — one call per chunk
        return [
            list(digest_bytes(arr[off: off + chunk_bytes], device))
            for off in range(0, arr.size, chunk_bytes)
        ]
    n_full = arr.size // chunk_bytes
    out = []
    if n_full:
        body = arr[: n_full * chunk_bytes].view(np.uint32)
        out.extend(_rows_digests(body.reshape(n_full, chunk_bytes // 4),
                                 device))
    tail = arr[n_full * chunk_bytes:]
    if tail.size:
        out.append(list(digest_bytes(tail, device)))
    return out
