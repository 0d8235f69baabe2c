"""N→M reshard planning — mapping shard extents across topologies.

A checkpoint written on N ranks stores, per rank, a rectangular *extent* of
each global array (the shard ``index`` in ``array-<rank>.json``).  Restoring
onto M≠N ranks means every new rank must assemble *its* extent from pieces of
the old ranks' files.  This module is the pure geometry: extents are tuples of
``(lo, hi)`` per dimension, and the planner turns "destination extent ×
source extents" into byte-range reads against each source file's C-order
payload — which :class:`~repro_torch.core.storage.ChunkRangeReader` then serves
chunk by chunk.

The invariant the hypothesis property test pins down: for any chunk grid and
any disjoint tiling of the global array by source extents, the read plan for
a destination extent covers every destination byte **exactly once**, and the
assembled bytes equal the source array's slice.
"""
from __future__ import annotations

import itertools
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cpbase import CheckpointError

Extent = Tuple[Tuple[int, int], ...]     # ((lo, hi), ...) per dimension


def resolve_index(index, shape: Sequence[int]) -> Extent:
    """Normalize a stored shard ``index`` (``[[start, stop|None], ...]`` or a
    tuple of slices) into a clamped ``((lo, hi), ...)`` extent over ``shape``.

    Short indices are padded with full dimensions (numpy basic-indexing
    semantics, which is also how the writers produced them); a 0-d shape
    yields the empty extent ``()``.
    """
    shape = tuple(int(s) for s in shape)
    ext: List[Tuple[int, int]] = []
    idx = tuple(index) if index is not None else ()
    for d, size in enumerate(shape):
        if d < len(idx):
            ent = idx[d]
            if isinstance(ent, slice):
                start, stop = ent.start, ent.stop
            else:
                start, stop = ent[0], ent[1]
            lo = 0 if start is None else int(start)
            hi = size if stop is None else int(stop)
        else:
            lo, hi = 0, size
        lo = max(0, min(lo, size))
        hi = max(lo, min(hi, size))
        ext.append((lo, hi))
    return tuple(ext)


def extent_size(ext: Extent) -> int:
    """Number of elements in an extent (1 for the 0-d extent ``()``)."""
    n = 1
    for lo, hi in ext:
        n *= hi - lo
    return n


def _strides(ext: Extent) -> List[int]:
    """C-order element strides of an extent's own (packed) buffer."""
    strides = [0] * len(ext)
    acc = 1
    for d in range(len(ext) - 1, -1, -1):
        strides[d] = acc
        acc *= ext[d][1] - ext[d][0]
    return strides


def overlap_runs(src: Extent, dst: Extent) -> List[Tuple[int, int, int]]:
    """Contiguous element runs shared by two extents of one global array.

    Returns ``[(src_off, dst_off, length), ...]`` where the offsets are
    element offsets into each extent's *own* packed C-order buffer.  Runs are
    maximal along the innermost dimensions: the largest suffix of dimensions
    where the intersection spans both extents entirely collapses into the run
    length, so a 1-D overlap is always a single run and higher-dimensional
    overlaps degrade gracefully to one run per outer-coordinate tuple.
    """
    nd = len(src)
    if nd != len(dst):
        raise CheckpointError(
            f"extent rank mismatch: {len(src)} vs {len(dst)}")
    if nd == 0:
        return [(0, 0, 1)]
    inter: List[Tuple[int, int]] = []
    for (slo, shi), (dlo, dhi) in zip(src, dst):
        lo, hi = max(slo, dlo), min(shi, dhi)
        if hi <= lo:
            return []
        inter.append((lo, hi))
    # k = first dim of the maximal fully-covered suffix
    k = nd
    while k > 0:
        d = k - 1
        if inter[d] == src[d] == dst[d]:
            k = d
        else:
            break
    sstr, dstr = _strides(src), _strides(dst)
    if k == 0:
        return [(0, 0, extent_size(src))]
    run_axis = k - 1
    inner = 1
    for d in range(k, nd):
        inner *= inter[d][1] - inter[d][0]
    run_len = (inter[run_axis][1] - inter[run_axis][0]) * inner
    runs: List[Tuple[int, int, int]] = []
    outer = [range(lo, hi) for lo, hi in inter[:run_axis]]
    for coord in itertools.product(*outer):
        soff = sum((c - src[d][0]) * sstr[d] for d, c in enumerate(coord))
        doff = sum((c - dst[d][0]) * dstr[d] for d, c in enumerate(coord))
        soff += (inter[run_axis][0] - src[run_axis][0]) * sstr[run_axis]
        doff += (inter[run_axis][0] - dst[run_axis][0]) * dstr[run_axis]
        runs.append((soff, doff, run_len))
    return runs


def plan_reads(sources: Sequence[Tuple[Extent, object]], dst: Extent,
               itemsize: int) -> List[Tuple[object, int, int, int]]:
    """Byte-level read plan: ``[(key, src_byte_off, dst_byte_off, nbytes)]``
    covering ``dst`` from the given ``(extent, key)`` sources.  Purely the
    flattened form of :func:`overlap_runs`; coverage is the caller's (and the
    property test's) concern.
    """
    plan = []
    for src_ext, key in sources:
        for soff, doff, ln in overlap_runs(src_ext, dst):
            plan.append((key, soff * itemsize, doff * itemsize, ln * itemsize))
    return plan


def assemble_extent(dst: Extent, dtype, sources: Sequence[Tuple[Extent, object]],
                    open_reader: Callable[[object], object],
                    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Assemble the destination extent from source shard files.

    ``sources`` is ``[(extent, key), ...]``; ``open_reader(key)`` returns an
    object with ``read(start, stop) -> bytes-like`` over that shard's
    uncompressed C-order payload (a :class:`ChunkRangeReader`).  Readers are
    opened lazily — a source that doesn't overlap ``dst`` is never touched.

    Returns ``(block, covered)`` where ``block`` is the packed ndarray of the
    extent's shape and ``covered`` a flat bool mask over its elements (None
    for empty extents).  Overlapping sources are tolerated — a disjoint
    tiling writes each byte exactly once, a replicated source merely
    overwrites with identical bytes.
    """
    dtype = np.dtype(dtype)
    dshape = tuple(hi - lo for lo, hi in dst)
    out = np.empty(dshape, dtype=dtype)
    n = out.size
    flat = out.reshape(-1).view(np.uint8)
    covered = np.zeros(n, dtype=bool) if n else None
    isz = dtype.itemsize
    readers: dict = {}
    for src_ext, key in sources:
        runs = overlap_runs(src_ext, dst)
        if not runs:
            continue
        reader = readers.get(id(key))
        if reader is None:
            reader = open_reader(key)
            readers[id(key)] = reader
        for soff, doff, ln in runs:
            data = reader.read(soff * isz, (soff + ln) * isz)
            flat[doff * isz:(doff + ln) * isz] = np.frombuffer(
                data, dtype=np.uint8)
            covered[doff:doff + ln] = True
    return out, covered
