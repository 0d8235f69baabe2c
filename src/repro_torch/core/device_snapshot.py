"""Device-resident snapshot pipeline (``CRAFT_DEVICE_SNAPSHOT``).

The host write path round-trips every checkpoint byte: a blocking
device→host copy per tensor, then a host-side digest pass, then (for delta
writes) a digest-compare.  This module keeps that work on the card: one
fused pass (``kernels.snapshot``) over the device-resident tensor produces
per-chunk Fletcher digests, a dirty mask against the previous snapshot's
digests (kept on the device between checkpoints), and the byte-nibble
histogram behind the zstd-vs-raw gate — and only the *dirty* chunks are
ever transferred to the host.

In ``staged`` mode (the default for CUDA tensors) host-side state per shard
is a **mirror**: a pinned (n_chunks, wpc) word buffer holding the exact
bytes of the last snapshot, patched chunk-wise from the device.  The mirror
always equals the tensor's bytes after ``snapshot()``, so every codec, tier
and delta base works unchanged downstream — the D2H traffic just shrinks to
the dirty fraction.  Dirty rows are gathered on the device and cross in one
transfer; the stream is synchronised before the mirror is handed out, so an
asynchronous writer never sees a half-copied chunk.  With
``double_buffer=True`` two mirrors alternate, so an asynchronous writer can
still be reading the previous version's mirror while the next snapshot
patches the other one; each mirror tracks its own per-chunk digest table
and fetches exactly the chunks that changed since *it* was last current.
The device word buffer of a shard is allocated once and refilled in place
every checkpoint.

Unstaged mode (CPU tensors by default): there is no transfer to shrink, so
no mirror exists; the metadata comes from the numpy pass over the bytes.
Torch tensors are mutable — an in-place update after ``snapshot()`` would
change the bytes under an in-flight asynchronous write — so this mode
hands the writer a private copy, never a view of the live tensor.

Fallbacks (host path, ``meta is None``): empty tensors, byte sizes not a
multiple of 4, complex dtypes, and any shape/dtype change — a reshape
resets the shard's state, which downstream means a full literal write.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import metrics, trace
from repro_torch.kernels.snapshot import ops as snapshot_ops

_LANES = 128


def _pack_words(x: torch.Tensor, n_chunks: int, wpc: int,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Copy ``x``'s bytes into a zero-padded (n_chunks, wpc) int32 word
    matrix on ``x``'s device (little-endian, so it matches the host's
    ``view(np.uint32)`` of the same bytes).  ``out``, when given, is the
    shard's word buffer from the previous snapshot, refilled in place."""
    flat = x.detach().reshape(-1)
    if flat.dtype == torch.bool:
        flat = flat.view(torch.uint8)   # same 1-byte 0/1 layout as numpy
    src = flat.view(torch.uint8)
    if out is None:
        out = torch.empty((n_chunks, wpc), dtype=torch.int32,
                          device=x.device)
    dst = out.view(-1).view(torch.uint8)
    dst[: src.numel()].copy_(src)
    dst[src.numel():].zero_()
    return out


def host_copies(tensors: list) -> list:
    """Private contiguous CPU copies of ``tensors``: every device→host copy
    is queued into pinned memory and each device's stream is synchronised
    once, so the copies are complete when this returns (span
    ``craft::cp.d2h``, ended after the synchronisation)."""
    out, sync = [], set()
    with trace.TRACER.span("craft::cp.d2h") as sp:
        for t in tensors:
            t = t.detach()
            if t.device.type == "cpu":
                out.append(t.clone(memory_format=torch.contiguous_format))
                continue
            h = torch.empty(t.shape, dtype=t.dtype,
                            pin_memory=t.device.type == "cuda")
            h.copy_(t, non_blocking=True)
            out.append(h)
            sync.add(t.device)
        for dev in sync:
            torch.cuda.current_stream(dev).synchronize()
        if sp.armed:
            sp.set(bytes=sum(h.numel() * h.element_size() for h in out))
    return out


def _u8_np(t: torch.Tensor) -> np.ndarray:
    """Flat uint8 numpy view of a contiguous CPU tensor's bytes."""
    return t.reshape(-1).view(torch.uint8).numpy()


class _ShardState:
    __slots__ = ("shape", "dtype", "n_chunks", "wpc", "prev_digests",
                 "words", "mirrors", "mirror_digs", "flip")

    def __init__(self, shape, dtype, n_chunks, wpc, buffers):
        self.shape = shape
        self.dtype = dtype
        self.n_chunks = n_chunks
        self.wpc = wpc
        self.prev_digests = None        # (n_chunks, 2) digests of last pass
        self.words = None               # device word buffer, reused
        self.mirrors = [None] * buffers
        self.mirror_digs = [None] * buffers
        self.flip = 0


class DeviceSnapshotter:
    """Per-checkpointable device snapshot state (one instance per Cp object,
    shards keyed by the caller — see ``TorchTensorCp`` / ``PytreeCp``)."""

    def __init__(self, chunk_bytes: int, *, with_hist: bool = True,
                 double_buffer: bool = True, staged: Optional[bool] = None):
        self.chunk_bytes = int(chunk_bytes)
        self.with_hist = with_hist
        self.buffers = 2 if double_buffer else 1
        # staged: device words buffer + host mirror (None = auto: CUDA
        # tensors stage, CPU tensors take a private copy instead)
        self.staged = staged
        self._state: dict = {}

    def reset(self) -> None:
        self._state.clear()

    def _grid(self, nbytes: int) -> Tuple[int, int]:
        """(n_chunks, words_per_chunk) matching the storage chunk grid; a
        single-chunk array pads only to the lane multiple, not a full chunk."""
        n_chunks = max(1, -(-nbytes // self.chunk_bytes))
        if n_chunks == 1:
            words = nbytes // 4
            wpc = max(_LANES, -(-words // _LANES) * _LANES)
        else:
            wpc = self.chunk_bytes // 4
        return n_chunks, wpc

    def snapshot(self, key, arr: torch.Tensor
                 ) -> Tuple[torch.Tensor, Optional[dict]]:
        """Snapshot one tensor.  Returns ``(host_tensor, meta)`` where
        ``host_tensor`` is a CPU tensor equal to ``arr`` bit-for-bit that
        later in-place updates of ``arr`` do not change, and ``meta`` is the
        device-produced chunk metadata for ``IOContext.record_device_meta``
        — or ``None`` when the tensor took the plain host path."""
        dtype = arr.dtype
        nbytes = arr.numel() * arr.element_size()
        if (nbytes == 0 or nbytes % 4 or self.chunk_bytes % 4
                or arr.is_complex()):
            self._state.pop(key, None)
            return host_copies([arr])[0], None
        shape = tuple(arr.shape)
        n_chunks, wpc = self._grid(nbytes)

        st = self._state.get(key)
        if st is not None and (st.shape != shape or st.dtype != dtype
                               or st.n_chunks != n_chunks or st.wpc != wpc):
            st = None                   # reshape/regrid → full reset
        first = st is None
        if first:
            st = _ShardState(shape, dtype, n_chunks, wpc, self.buffers)
            self._state[key] = st

        staged = (self.staged if self.staged is not None
                  else arr.device.type == "cuda")
        if not staged:
            # private copy (snapshot-stable against in-place updates) and
            # the numpy snapshot pass over its bytes
            host = host_copies([arr])[0]
            prev_np = (st.prev_digests if st.prev_digests is not None
                       else np.zeros((n_chunks, 2), np.uint32))
            meta_host = snapshot_ops.snapshot_host(
                _u8_np(host), self.chunk_bytes, prev_np)
            cur_dig = meta_host[:, :2]
            st.prev_digests = cur_dig
        else:
            dev = arr.device
            words2 = _pack_words(arr, n_chunks, wpc, st.words)
            st.words = words2
            prev = (st.prev_digests if st.prev_digests is not None
                    else torch.zeros((n_chunks, 2), dtype=torch.int32,
                                     device=dev))
            meta_dev = snapshot_ops.snapshot_chunks(
                words2, prev, with_hist=self.with_hist)
            st.prev_digests = meta_dev[:, :2].contiguous()
            meta_host = meta_dev.cpu().numpy().view(np.uint32)
            cur_dig = meta_host[:, :2]
            # Patch this round's mirror: fetch exactly the chunks whose
            # digest changed since the mirror was last current (a superset
            # of the device dirty column when double buffering skips a
            # round).
            mi = st.flip
            st.flip = (st.flip + 1) % self.buffers
            mirror = st.mirrors[mi]
            if mirror is None:
                mirror = st.mirrors[mi] = torch.empty(
                    (n_chunks, wpc), dtype=torch.int32,
                    pin_memory=dev.type == "cuda")
                rows = np.arange(n_chunks)
            else:
                rows = np.flatnonzero(
                    (cur_dig != st.mirror_digs[mi]).any(axis=1))
            if rows.size == n_chunks:
                mirror.copy_(words2, non_blocking=True)   # one full transfer
            elif rows.size:
                idx = torch.from_numpy(rows)
                gathered = words2.index_select(0, idx.to(dev))
                staging = torch.empty(gathered.shape, dtype=torch.int32,
                                      pin_memory=dev.type == "cuda")
                staging.copy_(gathered, non_blocking=True)  # one transfer
                if dev.type == "cuda":
                    torch.cuda.current_stream(dev).synchronize()
                mirror.index_copy_(0, idx, staging)
            if dev.type == "cuda":
                # the mirror is complete before it reaches any writer thread
                torch.cuda.current_stream(dev).synchronize()
            st.mirror_digs[mi] = cur_dig.copy()
            host = (mirror.view(-1).view(torch.uint8)[:nbytes]
                    .view(dtype).reshape(shape))

        entropy = None
        if staged and self.with_hist:     # numpy pass carries no histogram
            hist = meta_host[:, 3:].astype(np.int64)
            pad_bytes = n_chunks * wpc * 4 - nbytes
            if pad_bytes:       # padded zero bytes: 2 spurious bin-0 nibbles
                hist[-1, 0] -= 2 * pad_bytes
            entropy = [float(e)
                       for e in snapshot_ops.chunk_entropy_bits(hist)]
        meta = {
            "nbytes": nbytes,
            "chunk_bytes": self.chunk_bytes,
            "rdigests": cur_dig.astype(np.int64).tolist(),
            "dirty": (None if first
                      else meta_host[:, 2].astype(bool).tolist()),
            "entropy_bits": entropy,
        }
        if metrics.REGISTRY.enabled:   # keep the unset path numpy-free
            if meta["dirty"] is not None:
                metrics.set_gauge(
                    "snapshot_dirty_fraction",
                    sum(meta["dirty"]) / max(1, n_chunks))
            if staged:
                metrics.inc("snapshot_d2h_bytes", int(rows.size) * wpc * 4)
                metrics.inc("snapshot_d2h_bytes_saved",
                            (n_chunks - int(rows.size)) * wpc * 4)
        return host, meta
