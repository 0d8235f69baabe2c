"""Memory tier — in-RAM replicated checkpoint storage for rapid AFT recovery.

The node and PFS tiers both end on storage that survives a process death but
costs a full codec decode (and, for the PFS, real disk IO) to restore.  After
an AFT shrink the surviving processes are healthy and their RAM is intact —
ReStore (Hübner et al., 2022) observes that keeping checkpoint shards
*replicated in surviving peers' memory* makes the post-failure restore orders
of magnitude faster than draining back to disk.  ``MemStore`` is that tier:

* each rank keeps its **own shards** of the latest versions in RAM, decoded
  and ready to hand back — a version is held in memory from its first
  write to its last read: the checkpointables write into an in-memory file
  table (``IOContext.files``) that :meth:`MemStore.publish` turns into
  resident entries, and a restore reads the same table back (a dictionary
  lookup, not a codec pass; no file is created, written, read or deleted);
* each rank additionally holds **replicas** of ``CRAFT_MEM_REPLICAS``
  partner ranks' shards, placed round-robin over the communicator (rank
  ``r``'s shards replicate to ranks ``r+1 .. r+R`` mod size), so any ``R``
  rank failures leave every shard reachable from a survivor;
* publish/abort/materialize follow the :class:`~repro_torch.core.tiers.StorageTier`
  invariants — a version is either completely present (every owner's shard
  set reachable) or not restorable, and a failed publish leaves nothing;
* every payload carries a Fletcher digest from the v1 codec's checksum
  kernel (on the store's ``device``: the CUDA kernel on a card, numpy on
  the CPU), computed at publish; replica payloads served for a **dead** owner
  are re-verified before use (the same stale-survivor paranoia as the XOR
  node tier), while a live owner's own shards are trusted process RAM.

Transport model.  Like the node tier — where cross-node reads through the
shared filesystem stand in for the RDMA transfers of a real fleet — the
"fabric" here is process-shared memory: with the :mod:`repro_torch.core.comm_sim`
backend every rank is a thread, so placing a replica in a partner's slot *is*
the RAM-to-RAM transfer.  Replica placement and the budget agreement are
still genuine communicator exchanges (allgather + min-reduction), so the
control flow matches what a wire implementation would run.  With one process
per rank the fabric degrades to a process-local cache: a killed process
loses its slots exactly as a real host loses its RAM, and restore falls back
to the node/PFS tiers.  RAM shards stay host numpy arrays; bfloat16/fp8
arrays are kept as their same-width unsigned views beside their on-disk
dtype names.  For a store on a card each resident array is page-locked in
place (``cudaHostRegister`` of its own memory, no copy), so a restore's
copy onto the card runs as a direct DMA instead of through CUDA's pageable
staging buffer; the lock is released with the memory, once the entry and
every view of it are gone.  A CPU store keeps plain pageable arrays.

Fail-stop modelling: ``SimWorld.kill`` fires fault-domain hooks (see
:meth:`repro_torch.core.comm.FTComm.fault_domain`); the fabric drops the dead
rank's slot — its own shards *and* every replica it held vanish atomically
with the fail-stop.  AFT recovery additionally reports the failed ranks via
:func:`notify_rank_failures`.

Budget (``CRAFT_MEM_BUDGET_BYTES``): per-rank cap on fabric residency.  The
projected load (own shards + incoming replicas + retained older versions) is
agreed collectively before anything is inserted; a version that does not fit
raises :class:`MemTierError` on **every** rank (all-or-nothing), and
``Checkpoint`` falls back to the node/PFS tiers for that version.
"""
from __future__ import annotations

import os
import threading
import weakref
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import metrics, tiers, trace
from repro_torch.core.cpbase import CheckpointError
from repro_torch.core.tiers import StorageTier
from repro_torch.kernels.checksum import ops as checksum_ops

#: Root of the names a staged or restored version goes by.  A name only:
#: nothing can be made below a device file, so a checkpointable that opens
#: files under it itself fails instead of writing somewhere real.
_ROOT = Path(os.devnull) / "craft-mem"


class MemTierError(CheckpointError):
    """Memory-tier publish refused (budget exceeded).

    Raised collectively — every rank of the communicator raises together, so
    ``Checkpoint`` skips the memory tier for the version as a whole and the
    node/PFS write-through still happens.
    """


# -- page-locked payloads ----------------------------------------------------
# id() of each array whose memory is registered.  An RLock: a release runs
# wherever the owner's last reference drops, which may be inside a
# registration on the same thread.
_pin_lock = threading.RLock()
_pinned: set = set()
_pinned_bytes = 0


def _page_lockable(device: str) -> bool:
    """Are a store's resident payloads page-locked?  Only where a card's
    DMA reads them: a CUDA store with a card present."""
    return torch.device(device).type == "cuda" and torch.cuda.is_available()


def _host_register(ptr: int, nbytes: int) -> bool:
    """Page-lock ``[ptr, ptr + nbytes)`` for the card (in place)."""
    err = torch.cuda.cudart().cudaHostRegister(ptr, nbytes, 0)
    if int(getattr(err, "value", err)) == 0:
        return True
    # the runtime keeps a failed call's error for the thread's next kernel
    # launch check, which would raise it against an unrelated kernel: a
    # one-element launch consumes it here
    try:
        torch.zeros(1, device="cuda")
    except RuntimeError:
        pass
    return False


def _host_unregister(ptr: int) -> None:
    torch.cuda.cudart().cudaHostUnregister(ptr)


def _page_lock(array: np.ndarray) -> bool:
    """Page-lock the memory under ``array`` in place, once per owner, and
    release it when the owner is freed (before numpy frees the memory).
    The owner is the array at the root of the views: numpy points every
    view at it, so it lives exactly as long as some view of the memory
    does.  Returns whether it is locked; a refusal leaves it pageable and
    is counted in ``mem_pin_failures``."""
    global _pinned_bytes
    root = array
    while isinstance(root.base, np.ndarray):
        root = root.base
    nbytes = int(root.nbytes)
    if nbytes == 0 or not root.flags.c_contiguous:
        return False
    key = id(root)
    with _pin_lock:
        if key in _pinned:
            return True
        ptr = root.ctypes.data
        if not _host_register(ptr, nbytes):
            metrics.inc("mem_pin_failures")
            return False
        _pinned.add(key)
        _pinned_bytes += nbytes
        metrics.set_gauge("mem_pinned_bytes", _pinned_bytes)
        weakref.finalize(root, _page_unlock, key, ptr, nbytes).atexit = False
    return True


def _page_unlock(key: int, ptr: int, nbytes: int) -> None:
    global _pinned_bytes
    with _pin_lock:
        _host_unregister(ptr)
        _pinned.discard(key)
        _pinned_bytes -= nbytes
        metrics.set_gauge("mem_pinned_bytes", _pinned_bytes)


class _MemEntry:
    """One stored file: a decoded (read-only) array or a raw blob.

    ``dtype`` is an array's on-disk dtype name (``"bfloat16"`` for a bf16
    array held as its uint16 view); it defaults to the array's own.
    ``pinned``: the array's memory is page-locked (:meth:`lock_pages`).
    """

    __slots__ = ("array", "blob", "digest", "nbytes", "dtype", "pinned")

    def __init__(self, array: Optional[np.ndarray], blob: Optional[bytes],
                 digest: Tuple[int, int], dtype: Optional[str] = None):
        if array is not None:
            array = array.view()
            array.setflags(write=False)
            dtype = dtype if dtype is not None else array.dtype.name
        self.array = array
        self.blob = blob
        self.digest = digest
        self.dtype = dtype
        self.nbytes = array.nbytes if array is not None else len(blob or b"")
        self.pinned = False

    @property
    def payload(self):
        return self.array if self.array is not None else self.blob

    def lock_pages(self) -> None:
        """Page-lock the array's memory in place (a blob stays as it is)."""
        if self.array is not None and not self.pinned:
            self.pinned = _page_lock(self.array)

    def verify(self, device="cuda") -> bool:
        """Does the payload still match its publish-time digest (computed
        on ``device``)?"""
        return tuple(checksum_ops.digest_bytes(self.payload, device)) \
            == tuple(self.digest)


class _MemVersion:
    """One (owner rank, version) shard set: {relative path: _MemEntry}."""

    __slots__ = ("files", "nbytes")

    def __init__(self, files: Dict[str, _MemEntry]):
        self.files = files
        self.nbytes = sum(e.nbytes for e in files.values())


class MemFabric:
    """Process-wide RAM fabric: per-checkpoint-name rank slots.

    ``slots[name][holder_rank][(owner_rank, version)] -> _MemVersion``; the
    entry for ``holder == owner`` is the rank's own copy, other holders hold
    replicas.  ``worlds[name][version]`` records the communicator size at
    publish time so completeness (every owner reachable) can be checked after
    the world shrank or ranks were renumbered.
    """

    _instance: Optional["MemFabric"] = None
    _instance_lock = threading.Lock()

    @classmethod
    def instance(cls) -> "MemFabric":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = MemFabric()
            return cls._instance

    def __init__(self):
        self._lock = threading.Lock()
        self.slots: Dict[str, Dict[int, Dict[Tuple[int, int], _MemVersion]]] = {}
        self.worlds: Dict[str, Dict[int, int]] = {}

    # -- write side ---------------------------------------------------------
    def insert(self, name: str, holders: List[int], owner: int, version: int,
               mv: _MemVersion, world: int) -> None:
        with self._lock:
            byname = self.slots.setdefault(name, {})
            for holder in holders:
                byname.setdefault(holder, {})[(owner, version)] = mv
            self.worlds.setdefault(name, {})[version] = world

    def prune(self, name: str, rank: int, keep_versions: List[int]) -> None:
        """Drop entries in ``rank``'s slot for versions not in the keep set."""
        keep = set(keep_versions)
        with self._lock:
            slot = self.slots.get(name, {}).get(rank, {})
            for key in [k for k in slot if k[1] not in keep]:
                del slot[key]
            worlds = self.worlds.get(name, {})
            for v in [v for v in worlds if v not in keep]:
                del worlds[v]

    # -- read side ----------------------------------------------------------
    def versions(self, name: str) -> Dict[int, int]:
        with self._lock:
            return dict(self.worlds.get(name, {}))

    def lookup(self, name: str, owner: int, version: int
               ) -> Tuple[Optional[_MemVersion], bool]:
        """(shard set, from_own_slot) for ``owner``'s shards of ``version``.

        Prefers the owner's own slot; falls back to any replica holder's slot
        (the owner died — its RAM is gone, the replica survives).
        """
        with self._lock:
            byname = self.slots.get(name, {})
            own = byname.get(owner, {}).get((owner, version))
            if own is not None:
                return own, True
            for holder, slot in byname.items():
                if holder == owner:
                    continue
                mv = slot.get((owner, version))
                if mv is not None:
                    return mv, False
        return None, False

    def complete(self, name: str, version: int) -> bool:
        """True when every publishing owner's shard set is still reachable."""
        world = self.versions(name).get(version)
        if world is None:
            return False
        return all(
            self.lookup(name, owner, version)[0] is not None
            for owner in range(world)
        )

    def held_bytes(self, name: str, rank: int,
                   versions: Optional[List[int]] = None) -> int:
        """Bytes resident in ``rank``'s slot (optionally only ``versions``)."""
        with self._lock:
            slot = self.slots.get(name, {}).get(rank, {})
            return sum(
                mv.nbytes for key, mv in slot.items()
                if versions is None or key[1] in versions
            )

    # -- scrub support (core/scrubber.py) -----------------------------------
    def entries(self, name: str) -> List[Tuple[int, int, str, "_MemEntry"]]:
        """Snapshot of every distinct resident entry: [(owner, version, rel,
        entry)].  Replicas alias the owner's ``_MemVersion`` object in this
        threads-as-ranks fabric, so each (owner, version, rel) appears once.
        """
        seen = {}
        with self._lock:
            for slot in self.slots.get(name, {}).values():
                for (owner, version), mv in slot.items():
                    for rel, entry in mv.files.items():
                        seen.setdefault((owner, version, rel), entry)
        return [(o, v, r, e) for (o, v, r), e in sorted(seen.items(),
                                                        key=lambda kv: kv[0])]

    def replace_entry(self, name: str, owner: int, version: int, rel: str,
                      entry: "_MemEntry") -> None:
        """Swap in a repaired entry for every holder of (owner, version);
        it is page-locked when the entry it replaces was."""
        mv, _ = self.lookup(name, owner, version)   # replicas alias it
        if mv is not None and rel in mv.files and mv.files[rel].pinned:
            entry.lock_pages()
        with self._lock:
            for slot in self.slots.get(name, {}).values():
                mv = slot.get((owner, version))
                if mv is not None and rel in mv.files:
                    mv.files[rel] = entry
                    mv.nbytes = sum(e.nbytes for e in mv.files.values())

    def drop_version(self, name: str, version: int) -> None:
        """Retract an unrepairable version so it is never served again."""
        with self._lock:
            for slot in self.slots.get(name, {}).values():
                for key in [k for k in slot if k[1] == version]:
                    del slot[key]
            self.worlds.get(name, {}).pop(version, None)

    def corrupt_entry(self, name: str, owner: int, version: int,
                      rel: Optional[str] = None) -> str:
        """Test hook: silently rot one stored payload (its recorded digest is
        kept, so the rot is detectable).  Returns the corrupted rel path."""
        mv, _ = self.lookup(name, owner, version)
        if mv is None:
            raise KeyError(f"no resident shards for owner {owner} v-{version}")
        rel = rel if rel is not None else sorted(mv.files)[0]
        entry = mv.files[rel]
        if entry.array is not None:
            rotted = entry.array.copy()
            rotted.view(np.uint8).reshape(-1)[0] ^= 0x40
            bad = _MemEntry(rotted, None, entry.digest, entry.dtype)
        else:
            blob = bytearray(entry.blob)
            blob[0] ^= 0x40
            bad = _MemEntry(None, bytes(blob), entry.digest)
        self.replace_entry(name, owner, version, rel, bad)
        return rel

    # -- elastic rehydration (CRAFT_ELASTIC_HYDRATE / NON-SHRINKING) --------
    def reseed(self, name: str, holders: List[int], owner: int,
               version: int) -> int:
        """Re-place ``owner``'s shard set of ``version`` into every listed
        holder slot that lost it (a replacement rank re-entering the fabric
        after hydrating from peer replicas).  Returns slots seeded; 0 when
        no surviving copy exists anywhere.
        """
        with self._lock:
            byname = self.slots.get(name, {})
            mv = byname.get(owner, {}).get((owner, version))
            if mv is None:
                for holder, slot in byname.items():
                    mv = slot.get((owner, version))
                    if mv is not None:
                        break
            if mv is None:
                return 0
            placed = 0
            for holder in holders:
                slot = byname.setdefault(holder, {})
                if (owner, version) not in slot:
                    slot[(owner, version)] = mv
                    placed += 1
            return placed

    def reprotect(self, size: int, replicas: int) -> int:
        """Restore full replica placement after a topology change.

        For every resident (name, version, owner) with a surviving copy,
        re-seed the round-robin holder set ``owner, owner+1 .. owner+R`` mod
        ``size`` — the NON-SHRINKING recovery path calls this so replacement
        ranks hold the replicas their predecessors did and the fabric again
        tolerates ``R`` failures.  Returns total slots seeded.
        """
        replicas = min(max(0, replicas), max(0, size - 1))
        total = 0
        with self._lock:
            names = list(self.slots)
        for name in names:
            for version, world in self.versions(name).items():
                for owner in range(min(world, size)):
                    holders = [owner] + [
                        (owner + i) % size for i in range(1, replicas + 1)
                    ]
                    total += self.reseed(name, holders, owner, version)
        return total

    # -- fault injection / lifecycle ----------------------------------------
    def drop_rank(self, rank: int) -> None:
        """Model the fail-stop RAM loss of ``rank`` across every checkpoint."""
        with self._lock:
            for byname in self.slots.values():
                byname.pop(rank, None)

    def drop_ranks(self, ranks) -> None:
        for r in ranks or ():
            self.drop_rank(r)

    def wipe(self, name: str) -> None:
        with self._lock:
            self.slots.pop(name, None)
            self.worlds.pop(name, None)

    def reset(self) -> None:
        """Drop everything (test isolation)."""
        with self._lock:
            self.slots.clear()
            self.worlds.clear()


def notify_rank_failures(ranks) -> None:
    """AFT recovery callback: the RAM of ``ranks`` is gone (paper §3.2).

    Idempotent with the fault-domain kill hooks — in the simulator the slots
    are already dropped at ``kill()``; on backends without in-process fault
    injection this is the only signal.
    """
    MemFabric.instance().drop_ranks(ranks)


class MemStore(StorageTier):
    """RAM tier for one checkpoint name (the fastest level of the chain)."""

    label = "mem"

    # RAM writes are near-free relative to any disk tier; seeding a small
    # prior lets the scheduler give the mem tier a tight Daly interval from
    # the very first step instead of waiting for a measurement.
    cost_prior_seconds = 0.01

    def __init__(self, name: str, comm, env, fabric: Optional[MemFabric] = None,
                 device="cuda"):
        self.name = name
        self.device = str(device)     # where the payload digests run
        self.comm = comm
        self.env = env
        self.fabric = fabric if fabric is not None else MemFabric.instance()
        self.rank = comm.rank
        self.size = comm.size
        self.replicas = min(max(0, env.mem_replicas), self.size - 1)
        self.budget = env.mem_budget_bytes
        self.keep_versions = max(1, env.keep_versions)
        self._root = _ROOT / self.name / f"r{self.rank}"
        self._staged: Dict[Path, dict] = {}   # staged root -> file table
        self._tables: Dict[int, dict] = {}    # materialized version -> table
        domain = getattr(comm, "fault_domain", lambda: None)()
        if domain is not None:
            domain.add_kill_hook(self.fabric.drop_rank)

    # -- placement ----------------------------------------------------------
    def _holders(self, owner: int) -> List[int]:
        """Round-robin replica placement: owner itself + the next R ranks."""
        return [owner] + [
            (owner + i) % self.size for i in range(1, self.replicas + 1)
        ]

    # -- staging API (Checkpoint._write_to_store) ---------------------------
    def stage(self, version: int) -> Path:
        # rank-distinct staging: each rank's shard set is its own payload
        # (the disk tiers share one staging dir; RAM slots are per rank)
        staged = self._root / tiers.staging_dir_name(version)
        self._staged[staged] = {}
        return staged

    def abort(self, staged: Path) -> None:
        self._staged.pop(staged, None)

    def write_ctx_overrides(self, staged: Path) -> dict:
        return {"files": self._staged[staged]}

    def publish(self, staged: Path, version: int,
                extra_meta: Optional[dict] = None) -> None:
        with trace.TRACER.timed("craft::cp.publish", cp=self.name,
                                version=version, slot="mem") as sp:
            self._publish(staged, version)
        metrics.observe("publish_seconds", sp.seconds, tier="mem")

    def _publish(self, staged: Path, version: int) -> None:
        # fabric coverage for the chaos engine: an injected fault here makes
        # the RAM tier misbehave exactly like a failing fabric insert would
        self._chaos_check("fabric", path=staged)
        table = self._staged.pop(staged)
        nbytes = sum(len(v) if isinstance(v, bytes) else v[0].nbytes
                     for v in table.values())
        # replica-placement exchange: every rank learns every owner's payload
        # size (allgather); holders can then project their slot load exactly
        entries = self.comm.allreduce((self.rank, int(nbytes)), op="list")
        if not isinstance(entries, list):      # single-rank / stub comms
            entries = [entries]
        sizes = {int(r): int(n) for r, n in entries}
        ok = self.comm.allreduce(1 if self._fits(version, sizes) else 0,
                                 op="min")
        self.comm.barrier()                    # all ranks decided together
        if not ok:
            raise MemTierError(
                f"memory tier skipped {self.name} v-{version}: budget "
                f"exceeded ({self.budget} bytes/rank)")
        lock = _page_lockable(self.device)     # after the decision: a
        files = {}                             # refused version locks nothing
        for rel, value in sorted(table.items()):
            if isinstance(value, bytes):
                entry = _MemEntry(None, value, None)
            else:
                # an owning copy: the device snapshotter refills its host
                # mirrors in place at the next update()
                entry = _MemEntry(value[0].copy(order="C"), None, None,
                                  value[1])
                if lock:                       # first: the digest's copy
                    entry.lock_pages()         # onto the card runs by DMA
            entry.digest = checksum_ops.digest_bytes(entry.payload,
                                                     self.device)
            files[rel] = entry
        self.fabric.insert(
            self.name, self._holders(self.rank), self.rank, version,
            _MemVersion(files), world=self.size,
        )
        self.comm.barrier()                    # every owner's shards placed
        kept = sorted(self.fabric.versions(self.name))[-self.keep_versions:]
        self.fabric.prune(self.name, self.rank, kept)

    def _fits(self, version: int, sizes: Dict[int, int]) -> bool:
        if self.budget <= 0:
            return True
        # incoming this version: every owner whose holder set includes me
        incoming = sum(
            sizes.get(owner, sizes.get(self.rank, 0))
            for owner in range(self.size)
            if self.rank in self._holders(owner)
        )
        kept = sorted(
            v for v in self.fabric.versions(self.name) if v != version
        )[-(self.keep_versions - 1):] if self.keep_versions > 1 else []
        retained = self.fabric.held_bytes(self.name, self.rank, kept)
        return incoming + retained <= self.budget

    # -- reading ------------------------------------------------------------
    def meta(self) -> dict:
        return {}   # per-file digests live in the fabric, not a manifest

    def latest_version(self) -> int:
        best = 0
        for v in self.fabric.versions(self.name):
            if v > best and self.fabric.complete(self.name, v):
                best = v
        return best

    def version_dir(self, version: int) -> Path:
        return self._root / tiers.version_dir_name(version)

    def materialize(self, version: int) -> Optional[Path]:
        """Assemble a complete restore view of ``version`` from the fabric.

        The view is the union of every owner's entries, kept as the file
        table :meth:`read_ctx_overrides` installs; the returned root is a
        name only.  Replica payloads standing in for a dead owner are
        digest-verified; a rank's own live copies are trusted process RAM.
        """
        world = self.fabric.versions(self.name).get(version)
        if world is None:
            return None
        union: Dict[str, Tuple[_MemEntry, bool]] = {}
        for owner in range(world):
            mv, own_slot = self.fabric.lookup(self.name, owner, version)
            if mv is None:
                return None     # owner and all its replica holders are gone
            for rel, entry in mv.files.items():
                # SPMD-identical paths (e.g. a rank-replicated array.bin)
                # collide across owners; this rank's copy wins, then owners
                # in ascending rank order — matching shared-dir semantics
                if rel not in union or owner == self.rank:
                    union[rel] = (entry, own_slot)
        table = {}
        for rel, (entry, own_slot) in union.items():
            if not own_slot and not entry.verify(self.device):
                raise CheckpointError(
                    f"memory tier: replica digest mismatch for {rel!r} of "
                    f"{self.name} v-{version} (stale or corrupt replica)"
                )
            table[rel] = entry.blob if entry.array is None \
                else (entry.array, entry.dtype)
        self._tables = {version: table}
        return self.version_dir(version)

    def chunk_digests(self, version: int, chunk_bytes: int) -> Optional[dict]:
        """Per-file raw chunk digests of ``version``, straight from RAM.

        Serves the delta codec's diff pass after a memory-tier restore: the
        fabric already holds every array *decoded*, so re-chunking the byte
        view at ``chunk_bytes`` granularity and digesting each slice yields
        exactly the ``rdigests`` a disk tier's v1/v2 file records — without a
        single disk read.  Returns ``{rel: {"rdigests", "ulens", "nbytes",
        "chunk_bytes"}}`` for every array entry reachable for ``version``,
        or None when the version is not completely resident.
        """
        chunk_bytes = max(1, int(chunk_bytes))
        world = self.fabric.versions(self.name).get(version)
        if world is None:
            return None
        out: Dict[str, dict] = {}
        for owner in range(world):
            mv, _ = self.fabric.lookup(self.name, owner, version)
            if mv is None:
                return None         # incomplete — caller falls back to disk
            for rel, entry in mv.files.items():
                if entry.array is None or rel in out:
                    continue
                flat = np.ascontiguousarray(entry.array)
                flat = (flat.reshape(-1).view(np.uint8).reshape(-1)
                        if flat.nbytes else np.empty(0, dtype=np.uint8))
                rdigests = checksum_ops.digest_chunks(flat, chunk_bytes,
                                                      self.device)
                ulens = [
                    min(chunk_bytes, flat.size - off)
                    for off in range(0, flat.size, chunk_bytes)
                ]
                out[rel] = {"rdigests": rdigests, "ulens": ulens,
                            "nbytes": int(flat.size),
                            "chunk_bytes": chunk_bytes}
        return out

    def read_ctx_overrides(self, version: int) -> dict:
        # checksum "none": payloads were digest-verified at publish (and
        # replicas re-verified in materialize); re-hashing RAM on the fast
        # path would cost exactly the codec pass this tier exists to skip
        return {"files": self._tables.get(version, {}), "checksum": "none"}

    def rehydrate(self, version: int) -> int:
        """Re-seed this rank's own fabric slots for ``version`` from peer
        replicas (replacement-rank hydration: after restoring through the
        fabric, the rank re-enters the redundancy group so the next failure
        is again survivable — all RAM-to-RAM, no disk).  Returns the number
        of slots seeded (0 = already whole)."""
        return self.fabric.reseed(
            self.name, self._holders(self.rank), self.rank, version)

    def retained_versions(self) -> List[int]:
        """Completely resident fabric versions (the scrubber's walk list)."""
        return sorted(
            v for v in self.fabric.versions(self.name)
            if self.fabric.complete(self.name, v)
        )

    def forget_version(self, version: int) -> None:
        """Retract an unrepairable version from the fabric (scrub quarantine
        — restore then falls through to the disk tiers)."""
        self.fabric.drop_version(self.name, version)
        self._tables.pop(version, None)

    def invalidate_all(self) -> None:
        self.fabric.wipe(self.name)
        self._tables = {}
