"""Background integrity scrubber — find and repair checkpoint rot early.

Every tier verifies payload digests *at restore time*, which is exactly the
wrong moment to learn about silent corruption: the job just failed, the rot
may have spread into delta bases and parity, and the only remaining copy may
be the one that rotted.  The :class:`Scrubber` moves that discovery to idle
time: it walks the retained versions of every chained tier, re-verifies
chunk digests (including delta-base chains and RS parity shards), and
repairs rot **in place** while healthy copies still exist.

Scheduling.  Scrub slices ride idle checkpoint opportunities: when the
:class:`~repro_torch.core.scheduler.CheckpointPolicy` decides *not* to write and
``CRAFT_SCRUB_EVERY`` seconds have passed since the last slice
(``CheckpointPolicy.scrub_due``), a slice is queued on the
:class:`~repro_torch.core.async_writer.AsyncWriter`'s ordered lane — serialized
against version writes, counted by the policy's backpressure signal, and run
inline when no writer exists.  ``CRAFT_SCRUB_BYTES_PER_S`` caps each slice's
verified bytes at the interval's allowance, so a multi-GB tier is scrubbed
across many slices instead of one stall.

Repair sources, in order:

1. **redundancy within the tier** — a node-tier version is quarantined and
   re-materialized from its partner mirror / XOR group / RS(k, m) parity
   (bit-identical rebuild of the whole version directory);
2. **peer tiers** — the same relative file on another chained tier (or the
   RAM fabric) that still verifies is decoded and re-encoded in place,
   preserving the chunk grid so delta refs into the file stay resolvable;
3. **quarantine** — with no healthy source left, the version is retracted
   from the tier (``forget_version``) so a restore falls back to an older
   intact version or a deeper tier instead of ever reading rot.

``Checkpoint`` also calls :meth:`Scrubber.repair_version` when a restore
read fails verification (repair-on-read), retrying the tier once after a
successful repair — a restore therefore never observes bad bytes even when
background scrubbing is disabled.

Every verification runs on the checkpoint's ``device`` (the hand-written
``checksum`` kernel on a card), and every re-encode goes through the same
kernels as the write path (``gf_matmul`` for RS parity rows).

Corruption injection for tests: :func:`corrupt_file` rots one payload chunk
of a CRFT file on disk; ``MemFabric.corrupt_entry`` rots a resident RAM
payload.  Both keep the recorded digests, which is what makes the rot
silent — and detectable.
"""
from __future__ import annotations

import json
import os
import shutil
import weakref
from pathlib import Path
from typing import List, Optional, Tuple

from repro_torch.core import metrics, storage, tiers
from repro_torch.core.cpbase import CheckpointError, IOContext

#: Unthrottled slices still stop after this many verified bytes, so a scrub
#: slice sharing the ordered lane can never starve checkpoint writes.
DEFAULT_SLICE_BYTES = 256 * 1024 * 1024


# --------------------------------------------------------------------------
# corruption injection (test hook)
# --------------------------------------------------------------------------
def corrupt_file(path: Path, offset: Optional[int] = None,
                 flip: int = 0x40) -> int:
    """Silently rot one payload byte of ``path``; returns the file offset.

    For a CRFT array file the default offset lands in the first payload
    chunk (past magic + header + any v0 digest), so the stored digests stay
    intact and the rot is exactly what a scrub pass must detect.
    """
    data = bytearray(path.read_bytes())
    if offset is None:
        offset = 0
        if data[:4] == storage._MAGIC:
            hlen = int.from_bytes(data[4:12], "little")
            offset = 4 + 8 + hlen
            header = json.loads(data[12: 12 + hlen].decode())
            if header.get("fmt", storage.CODEC_V0) == storage.CODEC_V0:
                offset += 8                       # skip the v0 digest word
        if offset >= len(data):
            offset = len(data) - 1
    data[offset] ^= flip
    path.write_bytes(bytes(data))
    return offset


class Scrubber:
    """Per-checkpoint integrity scrubber over the live tier chain."""

    def __init__(self, checkpoint):
        # a proxy: the checkpoint owns its scrubber, and a strong reference
        # back would keep a closed checkpoint, its items and their device
        # tensors alive until the collector's next full pass
        self.cp = weakref.proxy(checkpoint)
        self.env = checkpoint.env
        self._clock = checkpoint._clock
        self._queue: List[Tuple[str, int]] = []     # pending (slot, version)
        # StatsView mirrors every counter into the live metrics registry
        # as scrub_* series (chunks verified/repaired on the scoreboard)
        self.stats = metrics.StatsView(checkpoint.name, {
            "slices": 0, "passes": 0, "errors": 0,
            "files_scanned": 0, "bytes_scanned": 0,
            "corrupt_found": 0, "repaired": 0,
            "quarantined": 0, "unrepairable": 0,
            "parity_checked": 0, "parity_repaired": 0,
        }, prefix="scrub_")

    # -------------------------------------------------------------- driving
    def opportunity(self) -> bool:
        """Idle-window hook (called by ``Checkpoint`` on every skip decision):
        schedule one throttled scrub slice when the policy says it is due.
        Tripped-tier health probes ride the same idle windows — a half-open
        circuit breaker (core/health.py) gets its cheap re-admission probe
        here, outside the write path's critical section."""
        self.cp._probe_tiers()
        policy = self.cp.policy
        if policy is None or not policy.scrub_due():
            return False
        policy.note_scrub()
        budget = self._slice_budget()
        writer = self.cp._writer
        if writer is not None:
            writer.submit(lambda: self._safe_slice(budget))
        else:
            self._safe_slice(budget)
        return True

    def _safe_slice(self, budget: int) -> None:
        """A failing scrub slice must never kill the training loop — on the
        writer's ordered lane an escaped exception would surface as a
        checkpoint-write error at the next submit()/wait()."""
        try:
            self._scan_slice(budget)
        except Exception:
            self.stats["errors"] = self.stats.get("errors", 0) + 1

    def _slice_budget(self) -> int:
        """Bytes this slice may verify: the interval's bytes/s allowance."""
        bps = self.env.scrub_bytes_per_s
        if bps <= 0:
            return DEFAULT_SLICE_BYTES
        return max(1, int(bps * max(self.env.scrub_every, 1.0)))

    def scan_once(self, budget_bytes: Optional[int] = None) -> dict:
        """One full pass over every tier's retained versions (synchronous).

        Returns this pass's counters (the delta against the cumulative
        ``self.stats``).  ``budget_bytes`` bounds the verified bytes — the
        remaining work stays queued for the next call; ``None`` scans
        everything.
        """
        before = dict(self.stats)
        self._refill()
        self._drain(budget_bytes)
        return {k: v - before[k] for k, v in self.stats.items()}

    def _scan_slice(self, budget: int) -> None:
        self.stats["slices"] += 1
        if not self._queue:
            self._refill()
        self._drain(budget)

    def _refill(self) -> None:
        self.stats["passes"] += 1
        self._queue = [
            (slot, version)
            for store, slot, _ in self.cp._chained_stores()
            if self._scrubs_here(store, slot)
            for version in store.retained_versions()
        ]

    def _scrubs_here(self, store, slot: str) -> bool:
        """One scrubbing rank per shared tree: the PFS tier is walked by
        rank 0 only and a node tier by its node leader — N ranks re-decoding
        (and worse, concurrently repairing) the same shared directory would
        multiply the IO and race the in-place rewrites.  The RAM tier is
        rank-local state and is walked by every rank.  Repair-on-read is
        not gated — any rank repairs the tier it is actively restoring from.
        """
        if slot == "pfs":
            return self.cp.comm.rank == 0
        if slot == "node":
            return bool(getattr(store, "is_leader", True))
        return True

    def _drain(self, budget: Optional[int]) -> None:
        spent = 0
        while self._queue:
            if budget is not None and spent >= budget:
                return
            slot, version = self._queue.pop(0)
            spent += self._scrub_version(slot, version)

    def _store(self, slot: str):
        return {"mem": self.cp._mem, "node": self.cp._node,
                "pfs": self.cp._pfs}[slot]

    # ------------------------------------------------------ verify + repair
    def _scrub_version(self, slot: str, version: int) -> int:
        """Verify one (tier, version); repair or quarantine rot.  Returns
        the number of bytes verified (the throttle's unit of work)."""
        store = self._store(slot)
        if store is None:
            return 0
        if slot == "mem":
            return self._scrub_mem(store, version)
        nbytes, _ = self._scrub_disk(store, slot, version)
        if hasattr(store, "scrub_redundancy"):
            pstats = store.scrub_redundancy(version)
            nbytes += pstats["bytes"]
            self.stats["bytes_scanned"] += pstats["bytes"]
            self.stats["parity_checked"] += pstats["checked"]
            self.stats["parity_repaired"] += pstats["repaired"]
            self.stats["unrepairable"] += pstats["unrepairable"]
        return nbytes

    def repair_version(self, store, slot: str, version: int) -> bool:
        """Repair-on-read entry point: verify ``version`` on ``store`` right
        now and repair what fails.  True when the tier ended the call clean
        (something was repaired or nothing was wrong to begin with)."""
        if slot == "mem":
            self._scrub_mem(store, version)
            return store.fabric.complete(store.name, version)
        _, clean = self._scrub_disk(store, slot, version)
        return clean

    # -- disk tiers ----------------------------------------------------------
    def _verify_dir(self, store, vdir: Path
                    ) -> Tuple[Optional[List[str]], int]:
        """([corrupt rel paths], bytes verified); (None, 0) if not local."""
        if not vdir.is_dir():
            return None, 0
        base_dirs = {
            b: Path(store.version_dir(b))
            for b in tiers.read_delta_deps(vdir)
            if Path(store.version_dir(b)).is_dir()
        }
        ctx = IOContext(
            checksum="fletcher",        # force verification of every digest
            codec_version=self.env.codec_version,
            chunk_bytes=self.env.chunk_bytes,
            rel_root=vdir, base_dirs=base_dirs, device=self.cp.device,
        )
        bad: List[str] = []
        nbytes = 0
        for p in sorted(q for q in vdir.rglob("*") if q.is_file()):
            rel = str(p.relative_to(vdir))
            self.stats["files_scanned"] += 1
            try:
                with open(p, "rb") as fh:
                    is_array = fh.read(4) == storage._MAGIC
                if is_array:
                    nbytes += p.stat().st_size
                    # full decode == full verification: every literal chunk
                    # digest, every delta ref down its base chain
                    storage.read_array(p, ctx)
                elif p.suffix == ".json":
                    nbytes += p.stat().st_size
                    json.loads(p.read_text())
            except (CheckpointError, ValueError, OSError):
                bad.append(rel)
        self.stats["bytes_scanned"] += nbytes
        return bad, nbytes

    def _scrub_disk(self, store, slot: str, version: int
                    ) -> Tuple[int, bool]:
        """Verify + repair one disk-tier version.  Returns (bytes verified,
        tier ended clean) — callers on the restore path use the flag instead
        of re-verifying the whole directory."""
        vdir = Path(store.version_dir(version))
        bad, nbytes = self._verify_dir(store, vdir)
        if bad is None:
            return 0, False               # nothing local to serve
        if not bad:
            return nbytes, True
        self.stats["corrupt_found"] += len(bad)
        # 1) redundancy within the tier: set the rotted local copy ASIDE
        #    (never delete — a failed rebuild must leave the original, with
        #    its healthy sibling files, exactly where it was) and
        #    re-materialize from mirror/parity: a bit-identical rebuild
        if getattr(store, "redundancy", "LOCAL") != "LOCAL":
            stash = vdir.with_name(f".quarantine-{vdir.name}")
            shutil.rmtree(stash, ignore_errors=True)
            os.rename(vdir, stash)
            try:
                rebuilt = store.materialize(version)
            except CheckpointError:
                rebuilt = None
            still_bad, extra = (self._verify_dir(store, Path(rebuilt))
                                if rebuilt is not None else (None, 0))
            if still_bad is not None and not still_bad:
                shutil.rmtree(stash, ignore_errors=True)
                self.stats["repaired"] += len(bad)
                return nbytes + extra, True
            # rebuild failed or rebuilt rot: put the original back
            shutil.rmtree(vdir, ignore_errors=True)
            os.rename(stash, vdir)
        # 2) per-file re-encode from a healthy peer-tier copy
        remaining = [rel for rel in bad
                     if not self._repair_file(store, slot, version, rel)]
        if not remaining:
            self.stats["repaired"] += len(bad)
            return nbytes, True
        # 3) quarantine — but only while the version is still restorable
        #    from another tier: deleting the *last* copy would turn an
        #    explicit restore error into a silent fresh start, and a corrupt
        #    copy an operator can salvage beats no copy at all
        self.stats["repaired"] += len(bad) - len(remaining)
        self.stats["unrepairable"] += len(remaining)
        if self._version_elsewhere(slot, version):
            store.forget_version(version)
            self.stats["quarantined"] += 1
        return nbytes, False

    def _version_elsewhere(self, slot: str, version: int) -> bool:
        """Does any other chained tier still hold ``version`` locally?"""
        for peer, pslot, _ in self.cp._chained_stores():
            if pslot == slot:
                continue
            if pslot == "mem":
                if peer.fabric.complete(peer.name, version):
                    return True
            elif Path(peer.version_dir(version)).is_dir():
                return True
        return False

    def _repair_file(self, store, slot: str, version: int, rel: str) -> bool:
        """Re-encode one corrupt file from a verifying peer-tier copy."""
        path = Path(store.version_dir(version)) / rel
        good = self._read_good(slot, version, rel)
        if good is None:
            return False
        kind, payload, params = good
        try:
            if kind == "array":
                # Preserve the corrupt file's chunk grid when its header is
                # still parseable — delta refs into this file resolve by
                # chunk index, so the grid must survive the rewrite.
                mf = storage.read_chunk_manifest(path)
                # a bfloat16/fp8 payload arrives as its unsigned view: write
                # it under its own dtype name, not the view's
                payload = storage.as_tensor(payload, params["dtype"])
                ctx = IOContext(
                    compress=(mf or params).get("compress", "none"),
                    checksum="fletcher",
                    # keep the original format when the header survived (a
                    # v2 rewrite with no delta_prev is all-literal and
                    # bit-identical to the original full write); refs from
                    # newer versions into this file stay resolvable either
                    # way because the chunk grid below is preserved
                    codec_version=(mf or params).get(
                        "fmt", storage.CODEC_V1),
                    chunk_bytes=int((mf or params).get("chunk_bytes", 0))
                    or self.env.chunk_bytes,
                    device=self.cp.device,
                )
                storage.write_array(path, payload, ctx)
            else:
                tmp = path.with_name(f".tmp-scrub-{path.name}")
                tmp.write_bytes(payload)
                tmp.replace(path)
        except (CheckpointError, OSError):
            return False
        return True

    def _read_good(self, exclude_slot: str, version: int, rel: str
                   ) -> Optional[Tuple[str, object, dict]]:
        """A verified copy of ``rel`` from any other chain member.

        Returns ("array", ndarray, {chunk_bytes, compress, dtype}) or
        ("blob", bytes, {}); ``dtype`` is the on-disk dtype name.  The RAM
        fabric is consulted first (cheapest and already digest-guarded),
        then the other disk tiers, each read with its own delta-base chain
        and full verification.
        """
        if exclude_slot != "mem" and self.cp._mem is not None:
            fabric = self.cp._mem.fabric
            for owner, v, erel, entry in fabric.entries(self.cp.name):
                if v != version or erel != rel:
                    continue
                if entry.verify(self.cp.device):
                    if entry.array is not None:
                        return "array", entry.array, {"dtype": entry.dtype}
                    return "blob", entry.blob, {}
        for peer, pslot, _ in self.cp._chained_stores():
            if pslot in (exclude_slot, "mem"):
                continue
            vdir = Path(peer.version_dir(version))
            p = vdir / rel
            if not p.is_file():
                continue
            try:
                with open(p, "rb") as fh:
                    is_array = fh.read(4) == storage._MAGIC
                if not is_array:
                    return "blob", p.read_bytes(), {}
                base_dirs = {
                    b: Path(peer.version_dir(b))
                    for b in tiers.read_delta_deps(vdir)
                    if Path(peer.version_dir(b)).is_dir()
                }
                ctx = IOContext(checksum="fletcher",
                                codec_version=self.env.codec_version,
                                chunk_bytes=self.env.chunk_bytes,
                                rel_root=vdir, base_dirs=base_dirs,
                                device=self.cp.device)
                arr = storage.read_array(p, ctx)
                mf = storage.read_chunk_manifest(p) or {}
                return "array", arr, {**mf,
                                      "dtype": storage.read_dtype_name(p)}
            except (CheckpointError, OSError):
                continue
        return None

    # -- memory tier ---------------------------------------------------------
    def _scrub_mem(self, store, version: int) -> int:
        """Verify every resident RAM payload of ``version``; repair rotted
        entries from the disk tiers, retract the version if unrepairable."""
        from repro_torch.core.mem_level import _MemEntry

        fabric = store.fabric
        nbytes = 0
        for owner, v, rel, entry in fabric.entries(store.name):
            if v != version:
                continue
            self.stats["files_scanned"] += 1
            nbytes += entry.nbytes
            if entry.verify(store.device):
                continue
            self.stats["corrupt_found"] += 1
            good = self._read_good("mem", version, rel)
            fixed = None
            if good is not None:
                kind, payload, _ = good
                cand = (_MemEntry(payload, None, entry.digest, entry.dtype)
                        if kind == "array"
                        else _MemEntry(None, payload, entry.digest))
                # the publish-time digest is the ground truth: only a copy
                # that reproduces it may replace the rotted entry
                if cand.verify(store.device):
                    fixed = cand
            if fixed is not None:
                fabric.replace_entry(store.name, owner, version, rel, fixed)
                self.stats["repaired"] += 1
            else:
                # the RAM tier drops unconditionally: a live owner's own
                # entries are served *unverified* on the restore fast path,
                # so detected rot left resident would be served silently —
                # the disk tiers behind it are the durable copies
                self.stats["unrepairable"] += 1
                store.forget_version(version)
                self.stats["quarantined"] += 1
                break
        self.stats["bytes_scanned"] += nbytes
        return nbytes
