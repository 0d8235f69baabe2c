"""Public ops for XOR parity: padding, byte<->word views, device dispatch.

``parity_of_buffers`` / ``reconstruct_member`` take raw byte buffers (host
``bytes`` / ``np.uint8``), which is what the node tier stores, and run the
XOR where ``device`` says: on a CUDA device the padded words are copied to
the card and reduced by the hand-written kernel (as the reference reduces
on the TPU); on the CPU by the plain version.  A CUDA request goes to the
kernel and nothing else: a failed build or launch raises.

Each device pass records its stages (host padding, H2D, kernel, D2H) as
``parity_seconds{stage=...}`` in the metrics registry (``CRAFT_METRICS``).
"""
from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np
import torch

from repro_torch.core import metrics
from repro_torch.kernels.checksum.ops import _to_device
from repro_torch.kernels.xor_parity.kernel import xor_reduce_cuda
from repro_torch.kernels.xor_parity.ref import xor_reduce_ref

Device = Union[str, torch.device]
_LANE = 512  # pad byte payloads to 512 B = 128 uint32 lanes


def _pad_to_u32(buffers: Sequence[np.ndarray], n_pad: int) -> np.ndarray:
    """Stack uint8 buffers into a (G, n_pad/4) uint32 matrix, zero-padded.

    Buffers that already are exactly ``n_pad`` bytes (bytes-likes included —
    ``np.frombuffer`` is zero-copy) are viewed, not staged through a padded
    copy; only short or non-contiguous buffers pay for a zero-filled row.
    A single full-size buffer therefore stacks with no host copy at all.
    Shared with the RS erasure ops (``kernels/rs_erasure``), whose payloads
    go through the same u32-lane padding.
    """
    rows = []
    for b in buffers:
        if isinstance(b, (bytes, bytearray, memoryview)):
            arr = np.frombuffer(b, dtype=np.uint8)
        else:
            arr = np.ascontiguousarray(b).reshape(-1).view(np.uint8)
        if arr.size != n_pad:
            row = np.zeros(n_pad, dtype=np.uint8)
            row[: arr.size] = arr
            arr = row
        rows.append(arr.view(np.uint32))
    if len(rows) == 1:
        return rows[0].reshape(1, -1)
    return np.stack(rows)


def padded_len(nbytes: int) -> int:
    return ((nbytes + _LANE - 1) // _LANE) * _LANE


def nbytes_of(buf) -> int:
    return len(buf) if isinstance(buf, (bytes, bytearray)) else buf.nbytes


def timed(stage: str):
    """Add the block's seconds to ``parity_seconds{stage=...}``."""
    return metrics.timed("parity_seconds", stage=stage)


def stack_on(buffers: Sequence, n_pad: int, device: Device) -> torch.Tensor:
    """The zero-padded (G, n_pad/4) word matrix of ``buffers`` on ``device``
    (int32 bit view)."""
    with timed("pad"):
        host = _pad_to_u32(buffers, n_pad)
    with timed("h2d"):
        return _to_device(host, device)


def run_kernel(fn, *args) -> torch.Tensor:
    """``fn(*args)``, waiting for the card so the stage times separate."""
    with timed("kernel"):
        out = fn(*args)
        if out.device.type == "cuda":
            torch.cuda.current_stream(out.device).synchronize()
    return out


def row_bytes(words: torch.Tensor) -> bytes:
    """The bytes of a 1-D word tensor, copied to the host."""
    with timed("d2h"):
        return words.cpu().numpy().view(np.uint8).tobytes()


def xor_reduce(stacked: torch.Tensor) -> torch.Tensor:
    """XOR over axis 0 of a (G, N) word matrix: the kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if stacked.device.type == "cuda":
        return xor_reduce_cuda(stacked)
    if stacked.device.type == "cpu":
        return xor_reduce_ref(stacked)
    raise ValueError(f"xor_reduce: unsupported device {stacked.device}")


def parity_of_buffers(buffers: Sequence, device: Device = "cuda") -> bytes:
    """XOR parity of a group of byte buffers (zero-padded to equal length)."""
    if not buffers:
        raise ValueError("empty parity group")
    n_pad = padded_len(max(nbytes_of(b) for b in buffers))
    stacked = stack_on(buffers, n_pad, device)
    return row_bytes(run_kernel(xor_reduce, stacked))


def reconstruct_member(parity: bytes, survivors: Sequence, lost_size: int,
                       device: Device = "cuda") -> bytes:
    """Recover a lost member: XOR(parity, survivors...), truncated to size."""
    bufs: List = [parity, *survivors]
    n_pad = padded_len(max(nbytes_of(b) for b in bufs))
    stacked = stack_on(bufs, n_pad, device)
    member = row_bytes(run_kernel(xor_reduce, stacked))
    return member[:lost_size]
