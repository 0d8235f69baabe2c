"""Versioned, atomic checkpoint storage (paper §2.6) + the array codec.

Directory layout (paper Fig. 4):

    <base>/<cpName>/
        meta.json            -- latest complete version, history, checksums
        v-<K>/               -- one directory per checkpoint version
            <key>/...        -- one subdirectory per checkpointable object

Atomicity protocol: a version is staged in ``.tmp-v-<K>/``, every file is
fsync'd, the directory is atomically renamed to ``v-<K>``, and only then is
``meta.json`` updated (itself via tmp+rename).  A crash at any point leaves
either the previous complete version or a garbage ``.tmp-*`` dir that is swept
on the next run — never a torn checkpoint.  The shared directory mechanics
live in :mod:`repro_torch.core.tiers`; :class:`VersionStore` is the concrete
:class:`~repro_torch.core.tiers.StorageTier` used for the PFS path and as the local
store of the node tier.

On-disk array format (one ``.bin`` file per array / shard)
----------------------------------------------------------

Every file starts ``CRFT`` + u64(header_len) + JSON header.  The header's
``fmt`` field selects the codec:

* **v0 (legacy, fmt absent)** — monolithic: u64 crc32 digest, then the whole
  payload (optionally zstd-compressed) as one blob.  Still readable; written
  only when ``IOContext.codec_version == 0``.
* **v1 (chunked, fmt=1)** — the payload is split into fixed-size chunks
  (default 4 MiB, ``CRAFT_CHUNK_BYTES``).  Each chunk is independently
  compressed (zstd, when available and enabled) and digested with the blocked
  Fletcher checksum from ``repro_torch.kernels.checksum`` — the CUDA kernel
  when ``IOContext.device`` is a CUDA device, numpy on the CPU — instead of
  host zlib.  The header records per
  chunk ``{clen, ulen, digest}`` so a reader can verify integrity chunk by
  chunk and reject truncated files explicitly.  Chunk *encoding* fans out
  across the IO worker pool via ``IOContext.fanout``.
* **v2 (chunk-delta, fmt=2)** — the incremental codec (``CRAFT_DELTA``).
  Every chunk's *raw* bytes are digested first (``rdigest``); a chunk whose
  raw digest matches the previous version's manifest (threaded in via
  ``IOContext.delta_prev``) is recorded as ``{ref: <base_version>, ulen,
  rdigest}`` and **its bytes are not written** — a mostly-clean array costs
  one digest pass plus a small manifest instead of a full encode + IO.
  Dirty chunks are stored exactly like v1 literals (``{clen, ulen, digest,
  rdigest}``).  At read time refs resolve against ``IOContext.base_dirs``:
  the same relative path inside the base version's directory, chasing at
  most the chain length (``CRAFT_DELTA_MAX_CHAIN`` bounds it via
  compaction); a missing base raises an explicit :class:`CheckpointError`.
  A delta-chain restore is bit-identical to a full-codec restore.

Arrays reach the codec as numpy arrays or CPU torch tensors.  Dtypes numpy
cannot name without ``ml_dtypes`` (``bfloat16``, the ``float8_*`` family)
keep their on-disk names and travel on the host as same-width unsigned
views: :func:`read_array` returns that view, :func:`read_tensor` the torch
tensor of the named dtype.

A context with a file table (``IOContext.files``, the memory tier) keeps
each file as a table entry instead: an array with its dtype name, or a JSON
file's bytes.  The functions below then put and take entries, under the
same chaos gate and retries as a file write, and touch no file.
"""
from __future__ import annotations

import dataclasses
import errno
import fnmatch
import json
import os
import shutil
import threading
import uuid
import warnings
import zlib
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

try:  # optional transparent compression (beyond-paper extension)
    import zstandard as _zstd
except ImportError:  # pragma: no cover
    _zstd = None

from repro_torch.core import tiers, trace
from repro_torch.core.cpbase import CheckpointError, IOContext
from repro_torch.core.tiers import StorageTier, fsync_dir  # re-export (legacy API)

_MAGIC = b"CRFT"
CODEC_V0 = 0
CODEC_V1 = 1
CODEC_V2 = 2
DEFAULT_CHUNK_BYTES = 4 * 1024 * 1024
_MAX_REF_HOPS = 64       # hard bound on delta-chain chasing (cycle guard)


# Dtypes without a plain numpy name: on-disk name -> (torch dtype, the
# same-width unsigned numpy dtype that carries the bytes on the host).
_EXTENDED = {
    "bfloat16": (torch.bfloat16, np.dtype(np.uint16)),
    "float8_e4m3fn": (torch.float8_e4m3fn, np.dtype(np.uint8)),
    "float8_e5m2": (torch.float8_e5m2, np.dtype(np.uint8)),
    "float8_e4m3fnuz": (torch.float8_e4m3fnuz, np.dtype(np.uint8)),
    "float8_e5m2fnuz": (torch.float8_e5m2fnuz, np.dtype(np.uint8)),
}
_TORCH_NAMES = {
    torch.bool: "bool", torch.uint8: "uint8", torch.int8: "int8",
    torch.int16: "int16", torch.int32: "int32", torch.int64: "int64",
    torch.uint16: "uint16", torch.uint32: "uint32", torch.uint64: "uint64",
    torch.float16: "float16", torch.float32: "float32",
    torch.float64: "float64", torch.complex64: "complex64",
    torch.complex128: "complex128",
    **{tdt: name for name, (tdt, _) in _EXTENDED.items()},
}
_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _dtype_to_name(dt) -> str:
    """On-disk dtype name of a numpy or torch dtype ("float32", "bfloat16")."""
    if isinstance(dt, torch.dtype):
        return _TORCH_NAMES[dt]
    return np.dtype(dt).name


def _dtype_from_name(name: str) -> np.dtype:
    """Host numpy dtype of an on-disk name — the same-width unsigned dtype
    for names numpy cannot hold without ``ml_dtypes``."""
    if name in _EXTENDED:
        return _EXTENDED[name][1]
    return np.dtype(name)


def torch_dtype_from_name(name: str) -> torch.dtype:
    """The torch dtype of an on-disk dtype name."""
    if name in _EXTENDED:
        return _EXTENDED[name][0]
    for tdt, n in _TORCH_NAMES.items():
        if n == name:
            return tdt
    raise CheckpointError(f"dtype {name!r} has no torch counterpart")


def host_array(arr):
    """``(numpy array, on-disk dtype name)`` of a numpy array or a CPU torch
    tensor; tensors come back as a zero-copy numpy view of their bytes."""
    if not isinstance(arr, torch.Tensor):
        arr = np.asarray(arr)
        return arr, _dtype_to_name(arr.dtype)
    if arr.device.type != "cpu":
        raise CheckpointError(
            f"the codec writes host tensors, got one on {arr.device}")
    t = arr.detach().contiguous()
    name = _TORCH_NAMES[t.dtype]
    if name in _EXTENDED or t.dtype in (torch.uint16, torch.uint32,
                                        torch.uint64):
        width = t.element_size()
        view = t.view(_SIGNED[width]).numpy().view(np.dtype(f"uint{8 * width}"))
        return view, name
    return t.numpy(), name


def as_tensor(arr: np.ndarray, name: str) -> torch.Tensor:
    """CPU torch tensor of the named dtype sharing ``arr``'s bytes (a host
    array as :func:`read_array` returns it)."""
    tdt = torch_dtype_from_name(name)
    if not arr.flags.c_contiguous:      # (ascontiguousarray would turn a
        arr = arr.copy(order="C")       # 0-d array into a 1-d one)
    if arr.dtype.kind == "u" and arr.dtype.itemsize > 1:
        arr = arr.view(np.dtype(f"int{8 * arr.dtype.itemsize}"))
    with warnings.catch_warnings():
        # a read-only array (the memory tier's resident copy) is only read
        # through the tensor; callers that keep it clone it
        warnings.filterwarnings("ignore", message=".*not writable.*")
        t = torch.from_numpy(arr)
    return t if t.dtype == tdt else t.view(tdt)


# Per-worker (de)compressor reuse: constructing a ZstdCompressor per chunk
# costs more than compressing a small chunk.  zstandard objects are not safe
# for concurrent use, so the cache is thread-local (one instance per IO
# worker per level); keying on id(_zstd) keeps the cache coherent when tests
# swap the module in.
_zstd_tls = threading.local()


def _compressor(level: int):
    cache = getattr(_zstd_tls, "cache", None)
    if cache is None:
        cache = _zstd_tls.cache = {}
    key = ("c", id(_zstd), int(level))
    c = cache.get(key)
    if c is None:
        c = cache[key] = _zstd.ZstdCompressor(level=int(level))
    return c


def _decompressor():
    cache = getattr(_zstd_tls, "cache", None)
    if cache is None:
        cache = _zstd_tls.cache = {}
    key = ("d", id(_zstd))
    d = cache.get(key)
    if d is None:
        d = cache[key] = _zstd.ZstdDecompressor()
    return d


def _gate_allows_zstd(i: int, raw, ctx: IOContext, dm: Optional[dict]) -> bool:
    """Per-chunk compressibility gate (CRAFT_ZSTD_GATE_BITS): skip the zstd
    attempt when the chunk's order-0 entropy estimate says the bytes look
    incompressible.  The estimate comes from the device snapshot's fused
    histogram when available, else from a host nibble count — both are far
    cheaper than a doomed compress pass."""
    bits = float(ctx.zstd_gate_bits)
    if bits <= 0:
        return True
    from repro_torch.kernels.snapshot import ops as snapshot_ops

    if dm is not None and dm.get("entropy_bits") is not None:
        return float(dm["entropy_bits"][i]) < bits
    hist = snapshot_ops.host_nibble_hist(raw)
    return float(snapshot_ops.chunk_entropy_bits(hist[None])[0]) < bits


def _digest_chunk(data, ctx: IOContext) -> List[int]:
    """Blocked Fletcher digest [s1, s2] via the checksum ops on ``ctx.device``."""
    from repro_torch.kernels.checksum import ops as checksum_ops

    s1, s2 = checksum_ops.digest_bytes(data, ctx.device)
    return [int(s1), int(s2)]


def _digest_all_chunks(flat, chunk_bytes: int,
                       ctx: IOContext) -> List[List[int]]:
    """Batched per-chunk digests (one kernel launch for the whole array)."""
    from repro_torch.kernels.checksum import ops as checksum_ops

    return checksum_ops.digest_chunks(flat, chunk_bytes, ctx.device)


def _as_byte_view(arr: np.ndarray) -> np.ndarray:
    """Contiguous flat uint8 view of an array (copy only if non-contiguous)."""
    arr = np.ascontiguousarray(arr)
    if arr.nbytes == 0:
        return np.empty(0, dtype=np.uint8)
    return arr.reshape(-1).view(np.uint8).reshape(-1)


def _manifest_name(path: Path, ctx: IOContext) -> str:
    """Checksum-manifest key: path relative to the staging root (collision-
    free across checkpoint keys), falling back to the bare file name."""
    if ctx.rel_root is not None:
        try:
            return str(path.relative_to(ctx.rel_root))
        except ValueError:
            pass
    return path.name


def run_jobs(jobs, ctx: IOContext) -> list:
    """Run independent IO jobs through ``ctx.fanout`` when available, else
    inline — the single dispatch point for per-array and per-chunk fanout."""
    if ctx.fanout is not None and len(jobs) > 1:
        return ctx.fanout(trace.TRACER.carry(jobs))
    return [job() for job in jobs]


def _retrying(fn, ctx: IOContext):
    """Run a file operation under the context's transient-retry policy."""
    if not ctx.io_retries:
        return fn()
    from repro_torch.core import health

    return health.retry_call(fn, ctx.io_retries, ctx.io_retry_backoff_ms,
                             on_retry=ctx.record_retry)


def _table_key(path: Path, ctx: IOContext) -> str:
    """Key of ``path`` in ``ctx.files``: the path relative to the root."""
    return str(Path(path).relative_to(ctx.rel_root))


def _table_put(path: Path, value, nbytes: int, ctx: IOContext,
               tearable: bool = False) -> None:
    """Put one entry into ``ctx.files`` under the chaos gate and retries a
    file write sees; a torn write puts nothing."""

    def attempt():
        if ctx.chaos is not None:
            ctx.chaos.check("write", nbytes=nbytes, path=path)
            if tearable and ctx.chaos.torn_limit(nbytes) is not None:
                raise OSError(errno.EIO, f"chaos: torn write {path}")
        ctx.files[_table_key(path, ctx)] = value

    _retrying(attempt, ctx)


def _table_get(path: Path, ctx: IOContext):
    value = ctx.files.get(_table_key(path, ctx))
    if value is None:
        raise CheckpointError(f"missing checkpoint file {path}")
    return value


def make_dir(path: Path, ctx: IOContext) -> None:
    """Create the directory ``path`` for a version's files (a file table
    needs none)."""
    if ctx.files is None:
        path.mkdir(parents=True, exist_ok=True)


def exists(path: Path, ctx: Optional[IOContext] = None) -> bool:
    """Is there a file at ``path`` (an entry, with a file table)?"""
    if ctx is None or ctx.files is None:
        return path.exists()
    return _table_key(path, ctx) in ctx.files


def glob(dir_path: Path, pattern: str,
         ctx: Optional[IOContext] = None) -> List[Path]:
    """The files directly under ``dir_path`` whose names match ``pattern``
    (the table's entries, with a file table)."""
    if ctx is None or ctx.files is None:
        return list(dir_path.glob(pattern))
    parent = Path(_table_key(dir_path, ctx))
    return [ctx.rel_root / k for k in ctx.files
            if Path(k).parent == parent
            and fnmatch.fnmatchcase(Path(k).name, pattern)]


def _atomic_write_file(path: Path, parts, ctx: IOContext) -> None:
    """tmp → write parts → fsync → rename, with chaos + retry.

    All fault handling for array/manifest payload files funnels through
    here: the chaos gate runs per attempt (a ``count=N`` EIO rule is
    consumed by retries), a ``torn`` rule writes only a byte prefix of the
    tmp file and fails the attempt (the ``.tmp-`` name is the reason a torn
    file can never be confused with a published one), and transient errors
    retry with backoff.  Encoding happened before this call — retries redo
    only the file IO, never the codec work.
    """
    total = sum(len(p) for p in parts)

    def attempt():
        if ctx.chaos is not None:
            ctx.chaos.check("write", nbytes=total, path=path)
        tmp = path.with_name(f".tmp-{path.name}-{uuid.uuid4().hex[:8]}")
        torn = ctx.chaos.torn_limit(total) if ctx.chaos is not None else None
        try:
            with open(tmp, "wb") as fh:
                if torn is not None:
                    budget = torn
                    for part in parts:
                        cut = memoryview(part)[:budget]
                        fh.write(cut)
                        budget -= len(cut)
                        if budget <= 0:
                            break
                    fh.flush()
                    raise OSError(
                        errno.EIO,
                        f"chaos: torn write ({torn}/{total} bytes) {path}")
                for part in parts:
                    fh.write(part)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
        except BaseException:
            tmp.unlink(missing_ok=True)
            raise

    _retrying(attempt, ctx)


# --------------------------------------------------------------------------
# array codec — v1 chunked writer, v0 legacy writer, version-dispatching reader
# --------------------------------------------------------------------------
def write_array(path: Path, arr, ctx: IOContext) -> None:
    """Serialize ``arr`` (numpy array or CPU tensor) to ``path`` using the
    codec ``ctx`` selects."""
    arr, name = host_array(arr)
    if ctx.files is not None:
        _table_put(path, (arr, name), int(arr.nbytes), ctx, tearable=True)
        ctx.record_io(int(arr.nbytes), chunks=1)
    elif ctx.codec_version == CODEC_V0:
        _write_array_v0(path, arr, name, ctx)
    elif ctx.codec_version == CODEC_V1:
        _write_array_v1(path, arr, name, ctx)
    else:
        _write_array_v2(path, arr, name, ctx)


def _write_array_v0(path: Path, arr: np.ndarray, dtype_name: str,
                    ctx: IOContext) -> None:
    arr = np.ascontiguousarray(arr)
    if ctx.compress == "zstd":
        if _zstd is None:  # pragma: no cover
            raise CheckpointError("CRAFT_COMPRESS=zstd but zstandard missing")
        payload = _compressor(ctx.zstd_level).compress(arr.tobytes())
    else:
        # uncompressed: digest + write straight off the byte view — tobytes()
        # would copy the whole payload for nothing
        payload = _as_byte_view(arr)
    header = json.dumps(
        {
            "dtype": dtype_name,
            "shape": list(arr.shape),
            "compress": ctx.compress,
        }
    ).encode()
    digest = zlib.crc32(payload) if ctx.checksum != "none" else 0
    _atomic_write_file(
        path,
        [_MAGIC, len(header).to_bytes(8, "little"), header,
         digest.to_bytes(8, "little"), payload],
        ctx,
    )
    ctx.record_checksum(_manifest_name(path, ctx), digest)
    ctx.record_io(len(payload), chunks=1)


def _write_array_v1(path: Path, arr: np.ndarray, dtype_name: str,
                    ctx: IOContext) -> None:
    shape = list(np.shape(arr))  # before ascontiguousarray 0-d→1-d promotion
    arr = np.ascontiguousarray(arr)
    flat = _as_byte_view(arr)
    chunk_bytes = max(1, int(ctx.chunk_bytes))
    compress = ctx.compress
    if compress == "zstd" and _zstd is None:  # pragma: no cover
        raise CheckpointError("CRAFT_COMPRESS=zstd but zstandard missing")
    want_digest = ctx.checksum != "none"
    n = flat.size
    offsets = list(range(0, n, chunk_bytes)) if n else []
    dm = ctx.lookup_device_meta(
        _manifest_name(path, ctx), n, chunk_bytes, len(offsets))

    # Uncompressed chunks are digested over their raw bytes: the device
    # snapshot's fused digests serve directly when present, else the whole
    # array goes through one batched kernel dispatch; compressed chunks are
    # digested post-compression inside the fanout jobs.
    if want_digest and compress != "zstd" and n:
        raw_digests = (dm["rdigests"] if dm is not None
                       else _digest_all_chunks(flat, chunk_bytes, ctx))
    else:
        raw_digests = []

    def encode(i: int, off: int):
        raw = flat[off: off + chunk_bytes]
        if compress == "zstd" and _gate_allows_zstd(i, raw, ctx, dm):
            # the compressor reads the buffer protocol directly — no
            # tobytes() copy of the uncompressed chunk
            stored = _compressor(ctx.zstd_level).compress(raw)
            digest = _digest_chunk(stored, ctx) if want_digest else [0, 0]
        elif compress == "zstd":
            # gated: incompressible-looking chunk stored raw inside the
            # zstd file; its stored-bytes digest is the raw digest
            stored = memoryview(raw)
            digest = ([int(d) for d in dm["rdigests"][i]] if dm is not None
                      else _digest_chunk(raw, ctx)) if want_digest else [0, 0]
            return stored, {"clen": len(stored), "ulen": int(raw.size),
                            "digest": digest, "enc": "raw"}
        else:
            stored = memoryview(raw)
            digest = ([int(d) for d in raw_digests[i]]
                      if want_digest else [0, 0])
        return stored, {"clen": len(stored), "ulen": int(raw.size),
                        "digest": digest}

    encoded = run_jobs(
        [lambda i=i, off=off: encode(i, off)
         for i, off in enumerate(offsets)], ctx)
    chunks_meta = [meta for _, meta in encoded]
    header = json.dumps(
        {
            "fmt": CODEC_V1,
            "dtype": dtype_name,
            "shape": shape,
            "compress": compress,
            "checksum": "fletcher" if want_digest else "none",
            "chunk_bytes": chunk_bytes,
            "nbytes": int(n),
            "chunks": chunks_meta,
        }
    ).encode()
    _atomic_write_file(
        path,
        [_MAGIC, len(header).to_bytes(8, "little"), header,
         *(stored for stored, _ in encoded)],
        ctx,
    )
    # whole-file digest for the manifest: fold per-chunk digests
    folded = 0
    for meta in chunks_meta:
        folded = zlib.crc32(
            meta["digest"][0].to_bytes(4, "little")
            + meta["digest"][1].to_bytes(4, "little"),
            folded,
        )
    ctx.record_checksum(_manifest_name(path, ctx), folded)
    ctx.record_io(sum(m["clen"] for m in chunks_meta), chunks=len(chunks_meta))


def _write_array_v2(path: Path, arr: np.ndarray, dtype_name: str,
                    ctx: IOContext) -> None:
    """Chunk-delta writer (fmt=2): digest every chunk, diff against the
    previous version's manifest, store only the dirty chunks.

    The raw-chunk digest pass runs even with ``ctx.checksum == "none"`` —
    it *is* the change detector — and fans out across the worker pool with
    the dirty-chunk encodes (one job per chunk via ``run_jobs``).
    """
    shape = list(np.shape(arr))  # before ascontiguousarray 0-d→1-d promotion
    arr = np.ascontiguousarray(arr)
    flat = _as_byte_view(arr)
    chunk_bytes = max(1, int(ctx.chunk_bytes))
    compress = ctx.compress
    if compress == "zstd" and _zstd is None:  # pragma: no cover
        raise CheckpointError("CRAFT_COMPRESS=zstd but zstandard missing")
    n = flat.size
    offsets = list(range(0, n, chunk_bytes)) if n else []
    rel = _manifest_name(path, ctx)
    # Previous-version manifest for this file — usable only when the byte
    # layout is unchanged (same total size, same chunk grid); a reshaped or
    # regridded array falls back to a full literal write.
    prev = None
    if ctx.delta_prev is not None:
        cand = ctx.delta_prev.get(rel)
        if (
            cand is not None
            and int(cand.get("nbytes", -1)) == int(n)
            and int(cand.get("chunk_bytes", -1)) == chunk_bytes
            and len(cand.get("rdigests", ())) == len(offsets)
        ):
            prev = cand

    # Change-detection pass: the fused device snapshot already digested
    # every chunk next to the data — consume those digests when the grid
    # matches; otherwise digest every raw chunk in one batched kernel
    # dispatch.  This is the whole per-version cost of a clean chunk.
    dm = ctx.lookup_device_meta(rel, n, chunk_bytes, len(offsets))
    raw_digests = (dm["rdigests"] if dm is not None
                   else (_digest_all_chunks(flat, chunk_bytes, ctx)
                         if n else []))

    def encode(i: int, off: int):
        raw = flat[off: off + chunk_bytes]
        rdigest = [int(d) for d in raw_digests[i]]
        if prev is not None and list(prev["rdigests"][i]) == rdigest:
            # clean chunk: reference the base version instead of re-writing
            return None, {"ref": int(ctx.delta_base), "ulen": int(raw.size),
                          "rdigest": rdigest}
        if compress == "zstd" and _gate_allows_zstd(i, raw, ctx, dm):
            stored = _compressor(ctx.zstd_level).compress(raw)
            digest = _digest_chunk(stored, ctx)
        elif compress == "zstd":
            # gated raw chunk inside a zstd file: stored == raw bytes
            stored = memoryview(raw)
            return stored, {"clen": len(stored), "ulen": int(raw.size),
                            "digest": rdigest, "rdigest": rdigest,
                            "enc": "raw"}
        else:
            stored = memoryview(raw)
            digest = rdigest          # stored bytes == raw bytes
        return stored, {"clen": len(stored), "ulen": int(raw.size),
                        "digest": digest, "rdigest": rdigest}

    encoded = run_jobs(
        [lambda i=i, off=off: encode(i, off)
         for i, off in enumerate(offsets)], ctx)
    chunks_meta = [meta for _, meta in encoded]
    header = json.dumps(
        {
            "fmt": CODEC_V2,
            "dtype": dtype_name,
            "shape": shape,
            "compress": compress,
            "checksum": "fletcher",   # v2 always digests (delta detector)
            "chunk_bytes": chunk_bytes,
            "nbytes": int(n),
            "chunks": chunks_meta,
        }
    ).encode()
    _atomic_write_file(
        path,
        [_MAGIC, len(header).to_bytes(8, "little"), header,
         *(stored for stored, _ in encoded if stored is not None)],
        ctx,
    )
    # manifest digest: fold the raw digests (stable across literal/ref form)
    folded = 0
    for meta in chunks_meta:
        folded = zlib.crc32(
            meta["rdigest"][0].to_bytes(4, "little")
            + meta["rdigest"][1].to_bytes(4, "little"),
            folded,
        )
    ctx.record_checksum(rel, folded)
    n_ref = sum(1 for m in chunks_meta if "ref" in m)
    ctx.record_chunks(rel, {
        "rdigests": [m["rdigest"] for m in chunks_meta],
        "ulens": [m["ulen"] for m in chunks_meta],
        "nbytes": int(n),
        "chunk_bytes": chunk_bytes,
        "refs": n_ref,
    })
    ctx.record_io(sum(m.get("clen", 0) for m in chunks_meta),
                  chunks=len(chunks_meta), ref_chunks=n_ref)


def read_tensor(path: Path, ctx: IOContext) -> torch.Tensor:
    """:func:`read_array` as a CPU torch tensor of the stored dtype."""
    return as_tensor(read_array(path, ctx), read_dtype_name(path, ctx))


def read_dtype_name(path: Path, ctx: Optional[IOContext] = None) -> str:
    """On-disk dtype name of an array file (header-only read)."""
    if ctx is not None and ctx.files is not None:
        return _table_get(path, ctx)[1]
    with open(path, "rb") as fh:
        return _parse_stream_header(fh, path)["dtype"]


def read_array(path: Path, ctx: IOContext) -> np.ndarray:
    """Read an array written by any codec version (v0 legacy or v1 chunked).
    Dtypes numpy cannot name come back as their same-width unsigned view.

    A file table's array is returned as a read-only view, unverified (the
    memory tier digests its payloads itself) — callers that need ownership
    of the buffer must copy.
    """
    if ctx.files is not None:
        view = _table_get(path, ctx)[0].view()
        view.setflags(write=False)
        return view
    if not path.exists():
        raise CheckpointError(f"missing checkpoint file {path}")

    def attempt():
        if ctx.chaos is not None:
            ctx.chaos.check("read", path=path)
        with open(path, "rb") as fh:
            header = _parse_stream_header(fh, path)
            fmt = header.get("fmt", CODEC_V0)
            if fmt == CODEC_V0:
                return _read_payload_v0(fh, header, path, ctx)
            if fmt == CODEC_V1:
                return _read_payload_v1(fh, header, path, ctx)
            if fmt == CODEC_V2:
                return _read_payload_v2(fh, header, path, ctx)
            raise CheckpointError(
                f"{path}: format v{fmt} is newer than this reader understands"
            )

    arr = _retrying(attempt, ctx)
    ctx.record_read(int(arr.nbytes))
    return arr


def _parse_stream_header(fh, path: Path) -> dict:
    """Parse magic + length-prefixed JSON header; fh is left at the payload."""
    if fh.read(4) != _MAGIC:
        raise CheckpointError(f"bad magic in {path}")
    raw_hlen = fh.read(8)
    if len(raw_hlen) != 8:
        raise CheckpointError(f"truncated header in {path}")
    hlen = int.from_bytes(raw_hlen, "little")
    raw_header = fh.read(hlen)
    if len(raw_header) != hlen:
        raise CheckpointError(f"truncated header in {path}")
    try:
        return json.loads(raw_header.decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise CheckpointError(f"corrupt header in {path}: {exc}") from exc


def read_chunk_manifest(path: Path) -> Optional[dict]:
    """Header-only read of a chunked array file (delta-diff priming).

    Returns ``{"fmt", "chunk_bytes", "nbytes", "compress", "chunks"}`` for a
    v1/v2 file, or None when the file is not a chunked CRFT array (v0 blobs,
    JSON manifests, foreign files).  Never reads the payload.
    """
    try:
        with open(path, "rb") as fh:
            if fh.read(4) != _MAGIC:
                return None
            fh.seek(0)
            header = _parse_stream_header(fh, path)
    except (OSError, CheckpointError):
        return None
    if header.get("fmt", CODEC_V0) not in (CODEC_V1, CODEC_V2):
        return None
    return {
        "fmt": header["fmt"],
        "chunk_bytes": int(header.get("chunk_bytes", 0)),
        "nbytes": int(header.get("nbytes", 0)),
        "compress": header.get("compress", "none"),
        "checksum": header.get("checksum", "none"),
        "chunks": header.get("chunks", []),
    }


def _restore_shape(payload: bytes, header: dict, path: Path) -> np.ndarray:
    dtype = _dtype_from_name(header["dtype"])
    shape = header["shape"]
    expected = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    if len(payload) != expected:
        raise CheckpointError(
            f"truncated payload in {path}: got {len(payload)} bytes, "
            f"expected {expected} for {header['dtype']}{tuple(shape)}"
        )
    arr = np.frombuffer(bytearray(payload), dtype=dtype)
    return arr.reshape(shape)


def _read_payload_v0(fh, header: dict, path: Path, ctx: IOContext) -> np.ndarray:
    raw_digest = fh.read(8)
    if len(raw_digest) != 8:
        raise CheckpointError(f"truncated payload in {path}")
    digest = int.from_bytes(raw_digest, "little")
    payload = fh.read()
    if ctx.checksum != "none" and digest and zlib.crc32(payload) != digest:
        raise CheckpointError(f"checksum mismatch in {path}")
    if header["compress"] == "zstd":
        if _zstd is None:  # pragma: no cover
            raise CheckpointError("file is zstd-compressed but zstandard missing")
        try:
            payload = _decompressor().decompress(payload)
        except _zstd.ZstdError as exc:
            raise CheckpointError(f"corrupt zstd payload in {path}: {exc}") from exc
    return _restore_shape(payload, header, path)


def _read_payload_v1(fh, header: dict, path: Path, ctx: IOContext) -> np.ndarray:
    verify = ctx.checksum != "none" and header.get("checksum", "none") != "none"
    # phase 1: sequential file IO — read every chunk's stored bytes
    raw_chunks = []
    for i, meta in enumerate(header["chunks"]):
        stored = fh.read(meta["clen"])
        if len(stored) != meta["clen"]:
            raise CheckpointError(
                f"truncated payload in {path}: chunk {i} got "
                f"{len(stored)}/{meta['clen']} bytes"
            )
        raw_chunks.append(stored)
    if fh.read(1):
        raise CheckpointError(f"trailing bytes after last chunk in {path}")

    # phase 2: digest verification + decompression fan out across the pool
    def decode(i: int) -> bytes:
        stored, meta = raw_chunks[i], header["chunks"][i]
        if verify and _digest_chunk(stored, ctx) != list(meta["digest"]):
            raise CheckpointError(f"checksum mismatch in {path} (chunk {i})")
        if header["compress"] == "zstd" and meta.get("enc") != "raw":
            if _zstd is None:  # pragma: no cover
                raise CheckpointError(
                    "file is zstd-compressed but zstandard missing")
            try:
                stored = _decompressor().decompress(stored)
            except _zstd.ZstdError as exc:
                raise CheckpointError(
                    f"corrupt zstd chunk {i} in {path}: {exc}"
                ) from exc
        if len(stored) != meta["ulen"]:
            raise CheckpointError(
                f"corrupt chunk {i} in {path}: inflated to {len(stored)} "
                f"bytes, expected {meta['ulen']}"
            )
        return stored

    parts = run_jobs(
        [lambda i=i: decode(i) for i in range(len(raw_chunks))], ctx)
    out = b"".join(parts)
    if len(out) != header["nbytes"]:
        raise CheckpointError(
            f"truncated payload in {path}: got {len(out)} bytes, "
            f"expected {header['nbytes']}"
        )
    return _restore_shape(out, header, path)


def _decompress_chunk(stored: bytes, compress: str, path: Path, i: int,
                      meta: Optional[dict] = None) -> bytes:
    if compress != "zstd" or (meta is not None and meta.get("enc") == "raw"):
        return stored
    if _zstd is None:  # pragma: no cover
        raise CheckpointError("file is zstd-compressed but zstandard missing")
    try:
        return _decompressor().decompress(stored)
    except _zstd.ZstdError as exc:
        raise CheckpointError(f"corrupt zstd chunk {i} in {path}: {exc}") from exc


def _read_payload_v2(fh, header: dict, path: Path, ctx: IOContext) -> np.ndarray:
    """Delta-aware reader: literal chunks come from this file, ref chunks are
    resolved from the base versions' copies of the same relative path."""
    verify = ctx.checksum != "none"
    chunks = header["chunks"]
    # phase 1: sequential file IO — slurp every *literal* chunk's bytes
    raw_chunks: List[Optional[bytes]] = []
    for i, meta in enumerate(chunks):
        if "ref" in meta:
            raw_chunks.append(None)
            continue
        stored = fh.read(meta["clen"])
        if len(stored) != meta["clen"]:
            raise CheckpointError(
                f"truncated payload in {path}: chunk {i} got "
                f"{len(stored)}/{meta['clen']} bytes"
            )
        raw_chunks.append(stored)
    if fh.read(1):
        raise CheckpointError(f"trailing bytes after last chunk in {path}")

    # phase 2: verify/decompress literals and resolve refs across the pool
    hcache: dict = {}   # str(base file) -> (header, per-chunk payload offsets)
    rel = None
    if ctx.rel_root is not None:
        try:
            rel = path.relative_to(ctx.rel_root)
        except ValueError:
            rel = None

    def decode(i: int) -> bytes:
        meta = chunks[i]
        if "ref" in meta:
            return _resolve_ref_chunk(
                rel, path, ctx, int(meta["ref"]), i, int(meta["ulen"]),
                list(meta["rdigest"]), verify, hcache)
        stored = raw_chunks[i]
        if verify and _digest_chunk(stored, ctx) != list(meta["digest"]):
            raise CheckpointError(f"checksum mismatch in {path} (chunk {i})")
        out = _decompress_chunk(stored, header["compress"], path, i, meta)
        if len(out) != meta["ulen"]:
            raise CheckpointError(
                f"corrupt chunk {i} in {path}: inflated to {len(out)} "
                f"bytes, expected {meta['ulen']}"
            )
        return out

    parts = run_jobs([lambda i=i: decode(i) for i in range(len(chunks))], ctx)
    out = b"".join(parts)
    if len(out) != header["nbytes"]:
        raise CheckpointError(
            f"truncated payload in {path}: got {len(out)} bytes, "
            f"expected {header['nbytes']}"
        )
    return _restore_shape(out, header, path)


def _resolve_ref_chunk(
    rel: Optional[Path], orig_path: Path, ctx: IOContext, version: int,
    idx: int, ulen: int, rdigest: list, verify: bool, hcache: dict,
    hops: int = 0,
) -> bytes:
    """Fetch chunk ``idx`` from the base version's copy of the same file,
    chasing further refs down the chain; every failure mode is an explicit
    :class:`CheckpointError` naming the broken base."""
    if hops > _MAX_REF_HOPS:
        raise CheckpointError(
            f"{orig_path}: delta chain exceeds {_MAX_REF_HOPS} hops at chunk "
            f"{idx} (corrupt chain)"
        )
    if ctx.base_dirs is None or rel is None:
        raise CheckpointError(
            f"{orig_path}: chunk {idx} is a delta ref to base v-{version} but "
            "no base-version directories are available (read the file through "
            "Checkpoint, which materializes the chain)"
        )
    bdir = ctx.base_dirs.get(int(version))
    if bdir is None:
        raise CheckpointError(
            f"{orig_path}: delta base v-{version} is absent from the chain "
            f"(have {sorted(ctx.base_dirs)})"
        )
    bpath = Path(bdir) / rel
    cached = hcache.get(str(bpath))
    if cached is None:
        if not bpath.exists():
            raise CheckpointError(
                f"{orig_path}: delta base file {bpath} is missing "
                f"(base v-{version} incomplete)"
            )
        with open(bpath, "rb") as bfh:
            bheader = _parse_stream_header(bfh, bpath)
            data_off = bfh.tell()
        if bheader.get("fmt", CODEC_V0) not in (CODEC_V1, CODEC_V2):
            raise CheckpointError(
                f"{orig_path}: delta base {bpath} is not a chunked array file"
            )
        offs = []
        off = data_off
        for c in bheader["chunks"]:
            offs.append(off)
            off += int(c.get("clen", 0))
        cached = (bheader, offs)
        hcache[str(bpath)] = cached
    bheader, offs = cached
    bchunks = bheader["chunks"]
    if idx >= len(bchunks) or int(bchunks[idx].get("ulen", -1)) != ulen:
        raise CheckpointError(
            f"{orig_path}: delta base {bpath} chunk grid mismatch at chunk "
            f"{idx} (chain corrupt)"
        )
    bmeta = bchunks[idx]
    if "ref" in bmeta:      # the base chunk is itself a ref — keep chasing
        return _resolve_ref_chunk(rel, orig_path, ctx, int(bmeta["ref"]),
                                  idx, ulen, rdigest, verify, hcache, hops + 1)
    with open(bpath, "rb") as bfh:
        bfh.seek(offs[idx])
        stored = bfh.read(int(bmeta["clen"]))
    if len(stored) != int(bmeta["clen"]):
        raise CheckpointError(
            f"truncated delta base chunk {idx} in {bpath}")
    if verify and _digest_chunk(stored, ctx) != list(bmeta["digest"]):
        raise CheckpointError(
            f"checksum mismatch in delta base {bpath} (chunk {idx})")
    out = _decompress_chunk(stored, bheader.get("compress", "none"),
                            bpath, idx, bmeta)
    if len(out) != ulen:
        raise CheckpointError(
            f"corrupt delta base chunk {idx} in {bpath}: inflated to "
            f"{len(out)} bytes, expected {ulen}"
        )
    if verify:
        # bit-identity guard: the resolved raw bytes must match the digest
        # the referring version recorded.  For an uncompressed (or gated-
        # raw) base chunk the stored digest already is the raw digest
        # (metadata compare only).
        raw_dig = (list(bmeta["digest"])
                   if bheader.get("compress", "none") != "zstd"
                   or bmeta.get("enc") == "raw"
                   else _digest_chunk(out, ctx))
        if raw_dig != list(rdigest):
            raise CheckpointError(
                f"delta ref mismatch: base {bpath} chunk {idx} content "
                "diverged from the referring version's digest (stale base)"
            )
    return out


# --------------------------------------------------------------------------
# chunk-range reads — the elastic reshard-on-restore primitive
# --------------------------------------------------------------------------
class ChunkRangeReader:
    """Byte-range reads of one array file's *uncompressed payload*.

    The elastic restore path maps a restoring rank's global shard extent
    onto the writing topology's per-file chunk grids; this reader serves the
    resulting byte ranges by verifying/decoding only the chunks a range
    overlaps:

    * **v1/v2 files** never pay a full decode — each touched chunk is read
      at its payload offset, digest-checked, decompressed, and cached for
      subsequent ranges; v2 ``ref`` chunks are chased through the delta base
      versions with the same machinery as the full reader.
    * **file-table entries** (``ctx.files``, the memory tier) slice the
      array already resident in RAM — no file IO at all.
    * **v0 monolithic blobs** have no chunk grid: the first range triggers
      one full decode (digest over the whole payload) which later ranges
      slice.

    ``rel``/``base_dirs`` override the delta-ref resolution root for files
    living under a *peer* node's version tree (``IOContext.aux_dirs``),
    where ``ctx.rel_root``/``ctx.base_dirs`` would point at the wrong tree.
    Thread-safe: range reads may fan out across the IO worker pool.
    """

    def __init__(self, path: Path, ctx: IOContext,
                 rel: Optional[Path] = None,
                 base_dirs: Optional[dict] = None):
        self.path = Path(path)
        self.ctx = ctx
        self._lock = threading.Lock()
        self._chunk_cache: dict = {}     # chunk idx -> decoded bytes
        self._hcache: dict = {}          # delta-base header/offset cache
        self._flat: Optional[np.ndarray] = None   # whole decoded payload
        self.header: Optional[dict] = None
        if ctx.files is not None:
            self._flat = _as_byte_view(_table_get(self.path, ctx)[0])
            self.nbytes = int(self._flat.size)
            return
        if not self.path.exists():
            raise CheckpointError(f"missing checkpoint file {self.path}")
        with open(self.path, "rb") as fh:
            self.header = _parse_stream_header(fh, self.path)
            data_off = fh.tell()
        fmt = self.header.get("fmt", CODEC_V0)
        if fmt == CODEC_V0:
            dtype = _dtype_from_name(self.header["dtype"])
            self.nbytes = int(
                np.prod(self.header["shape"], dtype=np.int64)) * dtype.itemsize
            self._offs: List[int] = []
        elif fmt in (CODEC_V1, CODEC_V2):
            self.nbytes = int(self.header["nbytes"])
            # per-chunk *stored* offsets: header end + cumulative clen
            # (ref chunks store no bytes — clen defaults to 0)
            self._offs = []
            off = data_off
            for c in self.header["chunks"]:
                self._offs.append(off)
                off += int(c.get("clen", 0))
        else:
            raise CheckpointError(
                f"{self.path}: format v{fmt} is newer than this reader "
                "understands"
            )
        # delta-ref resolution context: explicit rel/base_dirs for aux-dir
        # files, else derived from the ctx the way the full reader does
        if rel is not None:
            self._rel: Optional[Path] = Path(rel)
        elif ctx.rel_root is not None:
            try:
                self._rel = self.path.relative_to(ctx.rel_root)
            except ValueError:
                self._rel = None
        else:
            self._rel = None
        eff_bases = base_dirs if base_dirs is not None else ctx.base_dirs
        self._ref_ctx = (ctx if eff_bases is ctx.base_dirs
                         else dataclasses.replace(ctx, base_dirs=eff_bases))

    def read(self, start: int, stop: int) -> memoryview:
        """Payload bytes [start, stop) — decoding only what the range needs."""
        start, stop = int(start), int(stop)
        if not 0 <= start <= stop <= self.nbytes:
            raise CheckpointError(
                f"{self.path}: range [{start}, {stop}) outside payload of "
                f"{self.nbytes} bytes"
            )
        if start == stop:
            return memoryview(b"")
        if self._flat is None and self.header.get("fmt", CODEC_V0) == CODEC_V0:
            self._decode_v0()
        if self._flat is not None:
            return memoryview(self._flat[start:stop])
        cb = max(1, int(self.header["chunk_bytes"]))
        first, last = start // cb, (stop - 1) // cb
        parts = []
        for i in range(first, last + 1):
            data = self._chunk(i)
            lo = start - i * cb if i == first else 0
            hi = stop - i * cb if i == last else len(data)
            parts.append(data[lo:hi] if (lo, hi) != (0, len(data)) else data)
        if len(parts) == 1:
            return memoryview(parts[0])
        return memoryview(b"".join(parts))

    def _decode_v0(self) -> None:
        with self._lock:
            if self._flat is not None:
                return
            with open(self.path, "rb") as fh:
                header = _parse_stream_header(fh, self.path)
                arr = _read_payload_v0(fh, header, self.path, self.ctx)
            self.ctx.record_read(int(arr.nbytes))
            self._flat = _as_byte_view(arr)

    def _chunk(self, i: int) -> bytes:
        with self._lock:
            data = self._chunk_cache.get(i)
        if data is not None:
            return data
        meta = self.header["chunks"][i]
        cb = max(1, int(self.header["chunk_bytes"]))
        expect = min(cb, self.nbytes - i * cb)
        if int(meta["ulen"]) != expect:
            raise CheckpointError(
                f"{self.path}: chunk {i} grid mismatch (ulen "
                f"{meta['ulen']} vs expected {expect})"
            )
        verify = (self.ctx.checksum != "none"
                  and self.header.get("checksum", "none") != "none")
        if "ref" in meta:
            data = _resolve_ref_chunk(
                self._rel, self.path, self._ref_ctx, int(meta["ref"]), i,
                int(meta["ulen"]), list(meta["rdigest"]), verify,
                self._hcache)
        else:
            with open(self.path, "rb") as fh:
                fh.seek(self._offs[i])
                stored = fh.read(int(meta["clen"]))
            if len(stored) != int(meta["clen"]):
                raise CheckpointError(
                    f"truncated payload in {self.path}: chunk {i} got "
                    f"{len(stored)}/{meta['clen']} bytes"
                )
            if verify and _digest_chunk(stored, self.ctx) != list(
                    meta["digest"]):
                raise CheckpointError(
                    f"checksum mismatch in {self.path} (chunk {i})")
            data = _decompress_chunk(
                stored, self.header.get("compress", "none"),
                self.path, i, meta)
            if len(data) != int(meta["ulen"]):
                raise CheckpointError(
                    f"corrupt chunk {i} in {self.path}: inflated to "
                    f"{len(data)} bytes, expected {meta['ulen']}"
                )
        self.ctx.record_read(len(data))
        with self._lock:
            self._chunk_cache[i] = data
        return data


def write_json(path: Path, obj, ctx: Optional[IOContext] = None) -> None:
    """Atomic JSON write: tmp + fsync + rename + parent-dir fsync.

    Manifests (``meta.json``, ``deltadeps-*.json``) gate restore decisions,
    so they get the full durability treatment — including the directory
    fsync that makes the rename itself crash-safe.  With a ``ctx`` the
    write also runs under its chaos/retry policy like array payloads; with
    a file table the bytes become its entry.
    """
    payload = json.dumps(obj, indent=1).encode()
    if ctx is not None and ctx.files is not None:
        _table_put(path, payload, len(payload), ctx)
        return

    def attempt():
        if ctx is not None and ctx.chaos is not None:
            ctx.chaos.check("write", nbytes=len(payload), path=path)
        tmp = path.with_name(f".tmp-{path.name}-{uuid.uuid4().hex[:8]}")
        try:
            with open(tmp, "wb") as fh:
                fh.write(payload)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
        except BaseException:
            tmp.unlink(missing_ok=True)
            raise
        tiers.fsync_dir(path.parent)

    if ctx is not None:
        _retrying(attempt, ctx)
    else:
        attempt()


def read_json(path: Path, ctx: Optional[IOContext] = None):
    if ctx is not None and ctx.files is not None:
        return json.loads(_table_get(path, ctx))
    with open(path) as fh:
        return json.load(fh)


# --------------------------------------------------------------------------
# version store — the concrete StorageTier over a plain directory tree
# --------------------------------------------------------------------------
class VersionStore(StorageTier):
    """One checkpoint name's versioned directory tree on one storage tier.

    Multi-process coordination: all processes of ``comm`` share one staging
    directory per version (deterministic name, rank-distinct file names
    inside); opening the store barriers after rank 0's sweep of torn
    staging dirs (the reference's store does not, and a process that
    stages first loses its files to the sweep); ``publish()`` barriers,
    then rank 0 alone performs the atomic rename + metadata commit, then
    barriers again so no process reads a version before it is complete.
    """

    label = "pfs"

    def __init__(
        self, base: Path, name: str, keep_versions: int = 2, comm=None,
        sweep: bool = True,
    ):
        self.root = Path(base) / name
        self.keep_versions = max(1, keep_versions)
        self.comm = comm
        self.root.mkdir(parents=True, exist_ok=True)
        if sweep and self._rank() == 0:
            tiers.sweep_tmp_dirs(self.root)
        if sweep:
            # every process opens its store (Checkpoint.commit): none may
            # stage a version before rank 0 has swept the torn ones, or
            # the sweep deletes its files
            self._barrier()

    def _rank(self) -> int:
        return 0 if self.comm is None else self.comm.rank

    def _barrier(self) -> None:
        if self.comm is not None:
            self.comm.barrier()

    # -- staging ------------------------------------------------------------
    def stage(self, version: int) -> Path:
        tmp = self.root / tiers.staging_dir_name(version)
        tmp.mkdir(parents=True, exist_ok=True)
        return tmp

    def publish(self, staged: Path, version: int, extra_meta: Optional[dict] = None) -> None:
        self._chaos_check("publish", path=staged)
        self._barrier()  # every process finished writing its files
        if self._rank() == 0:
            tiers.atomic_publish_dir(staged, self.root / tiers.version_dir_name(version))
            meta = self.meta()
            versions = sorted(set(meta.get("versions", [])) | {version})
            meta.update(
                {
                    "latest": version,
                    "versions": versions,
                    **(extra_meta or {}),
                }
            )
            write_json(self.root / "meta.json", meta)
            self._retire()
        self._barrier()  # version visible to everyone from here on

    def abort(self, staged: Path) -> None:
        shutil.rmtree(staged, ignore_errors=True)

    # -- reading ------------------------------------------------------------
    def meta(self) -> dict:
        p = self.root / "meta.json"
        if p.exists():
            try:
                return read_json(p)
            except (json.JSONDecodeError, OSError):
                return {}
        return {}

    def latest_version(self) -> int:
        """Latest *complete* version, 0 if none (paper: CP-version counter)."""
        meta = self.meta()
        for v in sorted(meta.get("versions", []), reverse=True):
            if (self.root / tiers.version_dir_name(v)).is_dir():
                return v
        return 0

    def version_dir(self, version: int) -> Path:
        return self.root / tiers.version_dir_name(version)

    def forget_version(self, version: int) -> None:
        """Quarantine one unrepairable version: drop its directory and its
        metadata entries so ``latest_version`` / restore agreement fall back
        to an older intact version instead of re-reading rot (the scrubber's
        last resort when no repair source exists)."""
        shutil.rmtree(self.root / tiers.version_dir_name(version),
                      ignore_errors=True)
        meta = self.meta()
        versions = [v for v in meta.get("versions", []) if v != version]
        meta["versions"] = versions
        if meta.get("latest") == version:
            meta["latest"] = max(versions, default=0)
        write_json(self.root / "meta.json", meta)

    # -- invalidation (nested checkpoints, paper §2.5) -----------------------
    def invalidate_all(self) -> None:
        meta = self.meta()
        for v in meta.get("versions", []):
            shutil.rmtree(self.root / tiers.version_dir_name(v), ignore_errors=True)
        meta["versions"] = []
        meta["latest"] = 0
        write_json(self.root / "meta.json", meta)

    # -- housekeeping --------------------------------------------------------
    def _retire(self) -> None:
        kept = tiers.retire_version_dirs(self.root, self.keep_versions)
        meta = self.meta()
        meta["versions"] = kept
        write_json(self.root / "meta.json", meta)

    def retire_for_space(self) -> bool:
        """ENOSPC emergency: squeeze retention to the newest version (plus
        pinned delta bases) and retract the dropped versions from meta."""
        before = {v for v, _ in tiers.list_version_dirs(self.root)}
        if len(before) <= 1:
            return False
        kept = tiers.retire_version_dirs(self.root, keep=1)
        meta = self.meta()
        meta["versions"] = kept
        write_json(self.root / "meta.json", meta)
        return set(kept) != before
