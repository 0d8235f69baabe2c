"""StorageTier — the common spine of every checkpoint storage backend.

CRAFT's write path (paper §2.4–§2.6) spans two tiers with very different
latency/durability trade-offs: the node-local tier (RAM/SSD, redundancy-
protected, the SCR analog) and the PFS tier (durable parallel file system).
Historically ``storage.VersionStore`` and ``node_level.NodeStore`` each
re-implemented the same directory mechanics — stage in ``.tmp-*``, fsync,
atomic rename to ``v-<K>``, retire old versions, sweep torn staging dirs.
This module extracts that spine:

* :class:`StorageTier` — the abstract staging/publish/read interface that
  ``Checkpoint`` drives.  Any future backend (object store, remote host,
  in-memory cache) implements exactly this surface.
* Module-level helpers (:func:`atomic_publish_dir`, :func:`retire_version_dirs`,
  :func:`sweep_tmp_dirs`, :func:`list_version_dirs`) — the shared
  tmp→rename→fsync and retention mechanics, used by both concrete tiers and
  by the node tier's mirror/parity side-trees.

Atomicity contract (paper Fig. 4): a version directory either exists complete
under its final ``v-<K>`` name or not at all; crashes leave only ``.tmp-*``
garbage which :func:`sweep_tmp_dirs` removes on the next start.
"""
from __future__ import annotations

import abc
import json
import os
import shutil
from pathlib import Path
from typing import List, Optional, Set, Tuple

from repro_torch.core import metrics

_TMP_PREFIX = ".tmp-"
_VERSION_PREFIX = "v-"
_DELTA_DEPS_PREFIX = "deltadeps-"


# --------------------------------------------------------------------------
# shared directory mechanics
# --------------------------------------------------------------------------
def fsync_dir(path: Path) -> None:
    """fsync a directory so a rename inside it survives power loss."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir_tree(root: Path) -> None:
    """fsync every directory under ``root`` (and root itself).

    The durability half of the publish protocol: the staged tree's
    *directory entries* must be on stable storage before the atomic rename
    makes the version visible, or a power cut right after the rename can
    leave a complete-looking ``v-<K>`` whose entries vanish on replay.
    File *contents* are not re-synced here — every file in a staged tree
    is written through ``storage._atomic_write_file`` / ``write_json``,
    which fsync the payload before their own rename; repeating that per
    file at publish forces one journal barrier each on ext4 and measurably
    drags the write path.
    """
    for dirpath, _dirnames, _filenames in os.walk(root):
        fsync_dir(Path(dirpath))


def version_dir_name(version: int) -> str:
    return f"{_VERSION_PREFIX}{version}"


def staging_dir_name(version: int) -> str:
    return f"{_TMP_PREFIX}{_VERSION_PREFIX}{version}"


def parse_version(p: Path) -> Optional[int]:
    """``v-<K>`` → K, else None."""
    name = p.name
    if not name.startswith(_VERSION_PREFIX):
        return None
    try:
        return int(name[len(_VERSION_PREFIX):])
    except ValueError:
        return None


def list_version_dirs(root: Path) -> List[Tuple[int, Path]]:
    """Sorted [(version, dir)] of complete version directories under root."""
    out = []
    if root.is_dir():
        for p in root.glob(f"{_VERSION_PREFIX}*"):
            v = parse_version(p)
            if v is not None and p.is_dir():
                out.append((v, p))
    return sorted(out)


def atomic_publish_dir(staged: Path, final: Path) -> None:
    """Atomically promote a fully-written staging dir to its final name.

    The staged tree is fsync'd *before* the rename (payload + directory
    entries must hit stable storage before the version becomes visible — the
    rename is the commit point), a pre-existing ``final`` (same-version
    re-write, e.g. a retry) is removed first, and the parent directory is
    fsync'd after so the rename itself is durable.
    """
    fsync_dir_tree(staged)
    if final.exists():
        shutil.rmtree(final)
    final.parent.mkdir(parents=True, exist_ok=True)
    os.replace(staged, final)
    fsync_dir(final.parent)


def delta_deps_name(rank: int) -> str:
    """Per-rank delta-dependency manifest file inside a version directory."""
    return f"{_DELTA_DEPS_PREFIX}{rank}.json"


def read_delta_deps(vdir: Path) -> Set[int]:
    """Union of every rank's delta-base versions recorded in ``vdir``.

    A version written by the v2 delta codec carries ``deltadeps-<rank>.json``
    files naming the (transitive) base versions its ref chunks resolve
    through; a version with no such files is self-contained.  Unreadable
    manifests are ignored — the read path re-validates the chain anyway.
    """
    deps: Set[int] = set()
    for p in vdir.glob(f"{_DELTA_DEPS_PREFIX}*.json"):
        try:
            data = json.loads(p.read_text())
        except (OSError, ValueError):
            continue
        deps.update(int(v) for v in data.get("deps", []))
    return deps


def retire_version_dirs(root: Path, keep: int) -> List[int]:
    """Delete all but the newest ``keep`` version dirs; return kept versions.

    Delta pinning: a version directory referenced as a delta base by any
    *kept* version is never retired, however old — dropping it would strand
    every delta chained on it.  Pinning is transitive (a pinned base's own
    bases stay pinned too); pinned versions are included in the returned
    kept list so tier metadata keeps advertising them.
    """
    vdirs = list_version_dirs(root)
    keep = max(1, keep)
    pinned: Set[int] = set()
    for _, p in vdirs[-keep:]:
        pinned |= read_delta_deps(p)
    by_version = dict(vdirs)
    frontier = set(pinned)
    while frontier:             # transitive closure over recorded deps
        nxt: Set[int] = set()
        for v in frontier:
            p = by_version.get(v)
            if p is not None:
                nxt |= read_delta_deps(p) - pinned
        pinned |= nxt
        frontier = nxt
    kept = [v for v, _ in vdirs[-keep:]]
    for v, p in vdirs[:-keep]:
        if v in pinned:
            kept.append(v)
            continue
        shutil.rmtree(p, ignore_errors=True)
    return sorted(kept)


def sweep_tmp_dirs(root: Path) -> int:
    """Remove torn ``.tmp-*`` staging dirs left by a crash; return count."""
    n = 0
    if root.is_dir():
        for junk in root.glob(f"{_TMP_PREFIX}*"):
            shutil.rmtree(junk, ignore_errors=True)
            n += 1
    return n


# --------------------------------------------------------------------------
# the tier interface
# --------------------------------------------------------------------------
class StorageTier(abc.ABC):
    """Abstract storage tier driven by ``Checkpoint`` (stage→write→publish).

    Write protocol::

        staged = tier.stage(version)     # private staging directory
        ...write files under staged...
        tier.publish(staged, version)    # atomic rename + metadata commit
        # or, on error:
        tier.abort(staged)

    Read protocol::

        v = tier.latest_version()        # 0 if nothing restorable
        vdir = tier.materialize(v)       # complete local dir, recovering
                                         # from redundancy peers if needed
    """

    #: Human-readable tier name used in stats / restore-error reports; the
    #: chain order (``CRAFT_TIER_CHAIN``) is mem → node → pfs, fastest first.
    label: str = "tier"

    #: A-priori per-version write-cost guess (seconds) for tiers whose
    #: latency class is known before the first write (the RAM tier overrides
    #: this); ``None`` means "unknown until measured" — the scheduler then
    #: schedules an immediate first full write to seed the estimate.
    cost_prior_seconds = None

    #: EWMA smoothing for :meth:`record_write` — responsive enough to track a
    #: delta codec whose cost swings with the dirty fraction, damped enough
    #: that one slow fsync does not thrash the schedule.
    COST_ALPHA = 0.3

    #: Fault-injection scope (``chaos.ChaosScope``) bound by ``Checkpoint``
    #: when ``CRAFT_CHAOS`` is armed; tier-level operations (publish,
    #: redundancy replication, fabric inserts) gate through
    #: :meth:`_chaos_check`, file IO goes through the scope on ``IOContext``.
    chaos_scope = None

    def _chaos_check(self, op: str, nbytes: int = 0, path=None) -> None:
        scope = self.chaos_scope
        if scope is not None:
            scope.check(op, nbytes=nbytes, path=path)

    @abc.abstractmethod
    def stage(self, version: int) -> Path:
        """Create and return the staging directory for ``version`` (a name
        only, for a tier that keeps no files)."""

    @abc.abstractmethod
    def publish(self, staged: Path, version: int,
                extra_meta: Optional[dict] = None) -> None:
        """Atomically promote ``staged`` to the complete version ``version``."""

    @abc.abstractmethod
    def abort(self, staged: Path) -> None:
        """Discard a staging directory after a failed write."""

    @abc.abstractmethod
    def latest_version(self) -> int:
        """Newest version this tier can restore (0 if none)."""

    @abc.abstractmethod
    def version_dir(self, version: int) -> Path:
        """Path of version ``version`` (which may not exist)."""

    @abc.abstractmethod
    def invalidate_all(self) -> None:
        """Drop every stored version (nested-checkpoint wipe, paper §2.5)."""

    def materialize(self, version: int) -> Optional[Path]:
        """Return a complete local dir for ``version``, or None.

        Tiers with redundancy (partner mirror, XOR parity) override this to
        transparently rebuild a lost local copy; the default just checks the
        local directory.
        """
        vdir = self.version_dir(version)
        return vdir if vdir.is_dir() else None

    def aux_read_dirs(self, version: int) -> List[Path]:
        """Peer version roots that complement :meth:`materialize`'s result.

        An elastic N→M restore may find its own slice scattered across shard
        files this tier stored *for other ranks* — e.g. the node tier's
        sibling ``node-<nid>`` trees on a shared filesystem.  Tiers that can
        reach those trees return their ``v-<K>`` directories here; the
        checkpointables then union shard manifests across the materialized
        dir and these roots.  Default: none (single-root tiers like the PFS
        store already hold every rank's files in one directory).
        """
        return []

    def retained_versions(self) -> List[int]:
        """Versions locally resident on this tier — the scrubber's walk list.

        The default scans the directory tree ``version_dir`` points into;
        the RAM tier overrides this with its fabric's version set.
        """
        return [v for v, _ in list_version_dirs(self.version_dir(0).parent)]

    def forget_version(self, version: int) -> None:
        """Quarantine one version this tier can no longer serve faithfully
        (scrubber last resort: corrupt with no repair source).  The default
        just drops the directory; stores with version metadata override to
        also retract the version from their manifests."""
        shutil.rmtree(self.version_dir(version), ignore_errors=True)

    def retire_for_space(self) -> bool:
        """Emergency retention squeeze on ``ENOSPC``: drop every retired-
        eligible version (keep only the newest + its pinned delta bases) to
        free space for the write in flight.  Returns True when anything was
        deleted.  Stores with version metadata override to also retract the
        dropped versions from their manifests."""
        root = self.version_dir(0).parent
        before = {v for v, _ in list_version_dirs(root)}
        if len(before) <= 1:
            return False
        kept = set(retire_version_dirs(root, keep=1))
        return kept != before

    # -- per-tier write-cost reporting ---------------------------------------
    def record_write(self, seconds: float, nbytes: int = 0) -> None:
        """Feed one observed version-write duration into this tier's cost
        model (called by ``Checkpoint`` around every landed write; the
        scheduler consumes the estimate via :meth:`write_cost`)."""
        # one choke point covers every tier's write latency/throughput
        metrics.inc("tier_writes", tier=self.label)
        metrics.inc("tier_write_bytes", nbytes, tier=self.label)
        metrics.observe("tier_write_seconds", seconds, tier=self.label)
        prev = getattr(self, "_cost_ewma", None)
        self._cost_ewma = seconds if prev is None else (
            (1.0 - self.COST_ALPHA) * prev + self.COST_ALPHA * seconds
        )
        metrics.set_gauge("tier_cost_ewma_seconds", self._cost_ewma,
                          tier=self.label)

    def write_cost(self):
        """Estimated seconds per version write: the EWMA of observed writes,
        falling back to :attr:`cost_prior_seconds` (``None`` = unknown)."""
        ewma = getattr(self, "_cost_ewma", None)
        return ewma if ewma is not None else self.cost_prior_seconds

    def reset_cost(self) -> None:
        """Drop the learned cost estimate (post-recovery: surviving ranks'
        IO behavior may have changed with the new process layout)."""
        self._cost_ewma = None

    # -- per-tier IOContext adjustments -------------------------------------
    def write_ctx_overrides(self, staged: Path) -> dict:
        """IOContext field overrides for writes into ``staged``.

        A tier that does not keep files (the RAM tier, which installs an
        in-memory file table) overrides this; the default is no change.
        """
        return {}

    def read_ctx_overrides(self, version: int) -> dict:
        """IOContext field overrides for reads served by this tier.

        Called after :meth:`materialize` succeeded for ``version``; lets a
        tier install its file table (``files``) or relax re-verification
        for payloads it already verified.
        """
        return {}
