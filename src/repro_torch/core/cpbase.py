"""CpBase — the extension point of the CRAFT checkpoint library.

The paper's design (Fig. 2): every checkpointable data type derives from a
base class with three pure-virtual functions, ``read()``, ``write()`` and
``update()``.  The ``Checkpoint`` class holds a map of named CpBase objects
and drives those three calls.

PyTorch adaptation: ``update()`` is where device state becomes host state —
for a CUDA tensor it copies the bytes to host memory (or, with the device
snapshot path, only the chunks that changed).  ``write()``/``read()`` are
pure host-side file IO and can therefore run on the asynchronous writer
thread; ``IOContext.device`` names the device the digests run on.
"""
from __future__ import annotations

import abc
import dataclasses
import threading
from pathlib import Path
from typing import Callable, Optional, Sequence


@dataclasses.dataclass
class IOContext:
    """Context threaded through every read/write call.

    ``proc_rank`` / ``proc_count`` identify the writing process (paper: rank
    embedded in process-local file names); ``compress``/``checksum`` select the
    codec, and ``checksum_db`` collects per-file digests for the manifest.

    Codec pipeline fields (on-disk format v1): ``codec_version`` picks the
    array file format (0 = legacy monolithic blob, 1 = chunked), and
    ``chunk_bytes`` the chunk granularity.  ``fanout``, when set, is a
    ``fanout(jobs) -> results`` callable backed by the IO worker pool; the
    storage layer routes independent per-array and per-chunk work through it,
    so reads/writes issued from several threads share one ``IOContext`` —
    hence the lock around ``checksum_db`` updates.
    """

    proc_rank: int = 0
    proc_count: int = 1
    compress: str = "none"          # none | zstd
    checksum: str = "crc32"         # crc32 | fletcher | none
    # Per-file digest manifest: filled at write (keyed by path relative to
    # ``rel_root``), persisted into the version metadata at publish; restore
    # checks every manifest file is present before reading (payload integrity
    # itself is verified by the in-file digests).
    checksum_db: Optional[dict] = None
    rel_root: Optional[Path] = None      # staging root the manifest keys on
    codec_version: int = 1          # 0 = legacy blob, 1 = chunked
    chunk_bytes: int = 4 * 1024 * 1024
    # Parallel fanout hook: fanout(list[callable]) -> list of results, in
    # order.  None means "run inline" (no pool available).
    fanout: Optional[Callable[[Sequence[Callable]], list]] = None
    # Restore-time hook: maps a stored global numpy array onto the live
    # placement (elastic restore).  Installed by device-aware types.
    device_put: Optional[Callable] = None
    # Device the codec's chunk digests run on: "cuda" copies host bytes to
    # the card and digests them with the checksum kernel; "cpu" digests them
    # in numpy.  Restored tensors land here when no live tensor says where.
    device: str = "cuda"
    # Memory-tier fast path: maps str(path) of an array file to its already-
    # decoded (read-only) ndarray; ``storage.read_array`` serves hits without
    # touching the filesystem or re-running the codec.  Installed by
    # ``MemStore.read_ctx_overrides`` (payloads are digest-verified at
    # publish, so no re-verification happens on this path).
    array_cache: Optional[dict] = None
    # --- delta codec (on-disk format v2) -----------------------------------
    # Write side: ``delta_prev`` maps each file's manifest name to the chunk
    # manifest of the previous version on the *same tier*
    # ({"rdigests", "ulens", "nbytes", "chunk_bytes"}); a chunk whose raw
    # digest matches is recorded as a ``{ref: delta_base}`` entry instead of
    # being re-encoded and re-written.  ``chunks_db`` collects the manifests
    # of the version being written so the next version can diff against it.
    delta_prev: Optional[dict] = None
    delta_base: int = 0
    chunks_db: Optional[dict] = None
    # Read side: version → materialized directory of every delta-base version
    # the chain needs; refs resolve against ``base_dirs[ref] / relpath`` where
    # relpath is the file's path relative to ``rel_root``.
    base_dirs: Optional[dict] = None
    # Physical-IO accounting: {"bytes", "chunks", "ref_chunks"} actually
    # written, filled by the codec (delta savings show up here, while
    # ``Checkpoint.stats['bytes_written']`` stays the logical payload size).
    io_stats: Optional[dict] = None
    # --- zstd tuning (CRAFT_ZSTD_LEVEL / CRAFT_ZSTD_GATE_BITS) --------------
    # Compression level for the per-worker compressor cache, and the
    # per-chunk compressibility gate: a chunk whose order-0 nibble-entropy
    # estimate is >= ``zstd_gate_bits`` bits/byte is stored raw (chunk meta
    # ``"enc": "raw"``) instead of run through zstd.  0 disables the gate.
    zstd_level: int = 3
    zstd_gate_bits: float = 0.0
    # --- elastic reshard-on-restore (CRAFT_RESHARD) -------------------------
    # Read side: additional version roots whose shard files complement
    # ``rel_root`` (node-tier N→M restores: other nodes' v-<K> trees,
    # reachable over the shared FS).  Checkpointables union the shard
    # manifests across rel_root + aux_dirs; delta refs inside an aux file
    # resolve against *that* root's sibling base dirs, not ``base_dirs``.
    aux_dirs: Optional[tuple] = None
    # Assembly strategy for sharded global arrays: "auto" range-reads only
    # when the restoring extent is a strict sub-extent of the global array
    # (or shards live in aux dirs), "range" always range-reads, "full"
    # forces the legacy whole-array assembly.
    reshard: str = "auto"
    # --- device-resident snapshot path (CRAFT_DEVICE_SNAPSHOT) --------------
    # Precomputed chunk metadata, keyed like ``checksum_db`` (manifest name):
    # {"nbytes", "chunk_bytes", "rdigests", "dirty", "entropy_bits"} produced
    # by the fused snapshot kernel at ``update()`` time.  The array writers
    # consume these instead of re-digesting on the host, after validating
    # that the chunk grid matches (a tier override of ``chunk_bytes`` or a
    # reshaped array falls back to the host path transparently).
    device_meta: Optional[dict] = None
    # --- resilient IO (CRAFT_CHAOS / CRAFT_IO_RETRIES) ----------------------
    # Fault-injection scope for the tier this context writes/reads
    # (``chaos.ChaosScope`` or None): the file helpers in ``storage.py`` call
    # ``chaos.check("write"/"read", ...)`` before touching the filesystem and
    # honor ``chaos.torn_limit`` for partial-write injection.
    chaos: Optional[object] = None
    # Transient-error retry budget per file operation (exponential backoff
    # with jitter, base delay ``io_retry_backoff_ms``); 0 = fail fast.
    io_retries: int = 0
    io_retry_backoff_ms: float = 25.0
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    def record_checksum(self, rel_name: str, digest: int) -> None:
        if self.checksum_db is not None:
            with self._lock:
                self.checksum_db[rel_name] = digest

    def record_device_meta(self, rel_name: str, meta: dict) -> None:
        """Attach device-produced chunk metadata for the file about to be
        written under ``rel_name`` (called by checkpointables just before
        ``storage.write_array``; same-thread, the lock guards cross-item
        fanout writes into the shared dict)."""
        if self.device_meta is not None:
            with self._lock:
                self.device_meta[rel_name] = meta

    def lookup_device_meta(self, rel_name: str, nbytes: int,
                           chunk_bytes: int, n_chunks: int) -> Optional[dict]:
        """Device metadata for ``rel_name`` iff its chunk grid matches the
        write about to happen — otherwise None (host fallback)."""
        if self.device_meta is None:
            return None
        with self._lock:
            meta = self.device_meta.get(rel_name)
        if meta is None:
            return None
        if (int(meta.get("nbytes", -1)) != int(nbytes)
                or int(meta.get("chunk_bytes", -1)) != int(chunk_bytes)
                or len(meta.get("rdigests", ())) != int(n_chunks)):
            return None
        return meta

    def record_chunks(self, rel_name: str, manifest: dict) -> None:
        """Collect one file's chunk manifest for the next version's diff."""
        if self.chunks_db is not None:
            with self._lock:
                self.chunks_db[rel_name] = manifest

    def record_io(self, nbytes: int, chunks: int = 0, ref_chunks: int = 0) -> None:
        """Account bytes/chunks physically written (vs skipped as refs)."""
        if self.io_stats is not None:
            with self._lock:
                self.io_stats["bytes"] = self.io_stats.get("bytes", 0) + nbytes
                self.io_stats["chunks"] = self.io_stats.get("chunks", 0) + chunks
                self.io_stats["ref_chunks"] = (
                    self.io_stats.get("ref_chunks", 0) + ref_chunks
                )

    def record_retry(self) -> None:
        """Account one transient-error retry (surfaces in
        ``Checkpoint.stats['retries']`` and the ``io_retries`` counter)."""
        from repro_torch.core import metrics

        metrics.inc("io_retries")
        if self.io_stats is not None:
            with self._lock:
                self.io_stats["retries"] = self.io_stats.get("retries", 0) + 1

    def record_read(self, nbytes: int) -> None:
        """Account payload bytes physically fetched at restore (range reads
        report only the chunks they touched — the elastic-restore savings
        show up as ``io_stats['read_bytes']`` < the full payload size)."""
        if self.io_stats is not None:
            with self._lock:
                self.io_stats["read_bytes"] = (
                    self.io_stats.get("read_bytes", 0) + nbytes
                )


class CpBase(abc.ABC):
    """Base class of every checkpointable data type (paper Fig. 2).

    Subclasses implement:
      * ``update()`` — refresh the internal write-buffer from the live data
        (only used for copy-based asynchronous checkpointing; synchronous
        writes may fold this into ``write()``).
      * ``write(dir_path, ctx)`` — serialize the buffer into ``dir_path``.
      * ``read(dir_path, ctx)`` — restore the live data from ``dir_path``.
    """

    #: When True the object snapshots into a private buffer on ``update()``
    #: so the live data can be mutated while the writer thread runs.
    needs_copy_for_async: bool = True

    @abc.abstractmethod
    def update(self) -> None:
        """Snapshot live data into the write buffer (async copy mode)."""

    @abc.abstractmethod
    def write(self, dir_path: Path, ctx: IOContext) -> None:
        """Serialize the (buffered) data under ``dir_path``."""

    @abc.abstractmethod
    def read(self, dir_path: Path, ctx: IOContext) -> None:
        """Restore live data from ``dir_path`` (raises on missing/corrupt)."""

    def nbytes(self) -> int:
        """Approximate checkpoint payload size (for tier policy / stats)."""
        return 0


class CheckpointError(RuntimeError):
    """Raised on unreadable / corrupt / inconsistent checkpoint data."""
