"""Node-level checkpoint tier — the SCR analog (paper §2.4) on GPU hosts.

The paper reduces checkpoint overhead by writing frequent small checkpoints
to *node-local* storage and only occasionally to the parallel file system;
SCR adds redundancy so a single node failure does not lose the node-tier
data: *partner* (full copy on a neighbor) or *partner-XOR* (parity group).

"Node-local" is the host-local SSD/ramdisk of each GPU host.  Here a node's
storage is the directory ``<base>/node-<nid>/`` — in the test cluster all
nodes share one filesystem, so cross-node reads stand in for the
RDMA/collective transfers a real fleet would use.

Redundancy policies (``CRAFT_NODE_REDUNDANCY``):

  * ``LOCAL``   — no redundancy; a lost node forces a PFS restore.
  * ``PARTNER`` — the node leader mirrors the node's version directory onto
    the next node (paper: "recover restart data from the failed node's
    neighbor").
  * ``XOR`` / ``RS`` — parity groups over the ``xor_reduce`` and
    ``gf_matmul`` kernels; not ported yet (the node-redundancy slice of the
    port), so the store refuses them with a :class:`CheckpointError`.

Restore goes through :meth:`NodeStore.materialize`, which transparently
rebuilds a missing local version from the partner mirror before handing
the directory to ``Checkpoint``.

``NodeStore`` is a :class:`~repro_torch.core.tiers.StorageTier`: the local store is
a plain :class:`~repro_torch.core.storage.VersionStore`, and the mirror / parity
side-trees reuse the same atomic tmp→rename and retention helpers from
:mod:`repro_torch.core.tiers` instead of re-implementing them.
"""
from __future__ import annotations

import json
import shutil
import time as _time
from pathlib import Path
from typing import List, Optional

from repro_torch.core import metrics, storage, tiers
from repro_torch.core.cpbase import CheckpointError
from repro_torch.core.tiers import StorageTier

# Redundancy modes whose kernels belong to a later slice of the port.
UNPORTED_REDUNDANCY = ("XOR", "RS")


def _node_geometry(comm):
    ppn = max(1, comm.procs_per_node())
    n_nodes = (comm.size + ppn - 1) // ppn
    nid = comm.node_id()
    leader = comm.rank % ppn == 0
    return nid, n_nodes, leader


class NodeStore(StorageTier):
    """Node tier for one checkpoint name (the redundancy-protected tier).

    Tier-chain position (``CRAFT_TIER_CHAIN``): between the RAM tier
    (:class:`repro_torch.core.mem_level.MemStore`, fastest, survives peer-rank
    loss via replicas) and the PFS tier (slowest, survives full-job loss) —
    reads drain mem → node → pfs, writes go through to every chained tier.
    """

    label = "node"

    def __init__(self, base: Path, name: str, comm, env):
        self.base = Path(base)
        self.name = name
        self.comm = comm
        self.env = env
        self.redundancy = env.node_redundancy
        if self.redundancy in UNPORTED_REDUNDANCY:
            raise CheckpointError(
                f"CRAFT_NODE_REDUNDANCY={self.redundancy} needs the "
                "xor_reduce/gf_matmul kernels of the node-redundancy slice, "
                "which the PyTorch port does not have yet; use LOCAL or "
                "PARTNER")
        self.nid, self.n_nodes, self.is_leader = _node_geometry(comm)
        self._local = storage.VersionStore(
            self._node_dir(self.nid), name, keep_versions=env.keep_versions
        )

    # -- layout ---------------------------------------------------------------
    def _node_dir(self, nid: int) -> Path:
        return self.base / f"node-{nid}"

    def _mirror_root(self, owner_nid: int) -> Path:
        """Where ``owner_nid``'s partner mirror lives (on its neighbor node)."""
        holder = (owner_nid + 1) % self.n_nodes
        return self._node_dir(holder) / f"mirror-of-{owner_nid}" / self.name

    def _member_version_dir(self, member: int, version: int) -> Path:
        """Another node's v-<K> dir — path-only, no mkdir side effects."""
        return self._node_dir(member) / self.name / tiers.version_dir_name(version)

    def _peer_node_roots(self) -> List[Path]:
        """Other nodes' ``<base>/node-<nid>/<name>`` trees visible on the
        shared FS — the source of an elastic N→M restore's missing shards
        (the current geometry's node count doesn't bound the scan: a shrink
        must still see nodes past ``n_nodes``)."""
        roots = []
        for p in sorted(self.base.glob("node-*")):
            try:
                nid = int(p.name.split("-", 1)[1])
            except ValueError:
                continue
            if nid == self.nid:
                continue
            root = p / self.name
            if root.is_dir():
                roots.append(root)
        return roots

    # -- staging API (Checkpoint._write_to_store) ------------------------------
    def stage(self, version: int) -> Path:
        return self._local.stage(version)

    def abort(self, staged: Path) -> None:
        self._local.abort(staged)

    def publish(self, staged: Path, version: int, extra_meta: Optional[dict] = None) -> None:
        t0 = _time.perf_counter()
        self._chaos_check("publish", path=staged)
        self.comm.barrier()          # all ranks wrote their node-local files
        if self.is_leader:
            self._local.publish(staged, version, extra_meta)
        self.comm.barrier()          # every node's v-<K> is complete
        if self.is_leader:
            if self.redundancy == "PARTNER" and self.n_nodes > 1:
                self._chaos_check("replicate", path=staged)
                self._publish_partner(version)
        self.comm.barrier()          # redundancy data in place
        metrics.observe("publish_seconds", _time.perf_counter() - t0,
                        tier="node")

    def _publish_partner(self, version: int) -> None:
        src = self._local.version_dir(version)
        root = self._mirror_root(self.nid)
        root.mkdir(parents=True, exist_ok=True)
        tmp = root / tiers.staging_dir_name(version)
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.copytree(src, tmp)
        tiers.atomic_publish_dir(tmp, root / tiers.version_dir_name(version))
        tiers.retire_version_dirs(root, self.env.keep_versions)

    # -- reading ----------------------------------------------------------------
    def meta(self) -> dict:
        """This node's local version metadata (manifest checks at restore)."""
        return self._local.meta()

    def latest_version(self) -> int:
        """Latest version recoverable *for this node* (local or via peers)."""
        best = self._local.latest_version()
        if self.redundancy == "PARTNER" and self.n_nodes > 1:
            for v, _ in tiers.list_version_dirs(self._mirror_root(self.nid)):
                best = max(best, v)
        # Elastic N→M: a version any peer node holds is restorable here too —
        # either shard-by-shard through aux_read_dirs or by whole-tree copy
        for root in self._peer_node_roots():
            for v, p in tiers.list_version_dirs(root):
                if v > best and any(p.iterdir()):
                    best = max(best, v)
        return best

    def aux_read_dirs(self, version: int) -> List[Path]:
        """Peer nodes' ``v-<K>`` trees holding shards this node's ranks may
        need after a topology change (reads pull only overlapping chunk
        ranges out of them — see ``checkpointables._read_global_leaf``)."""
        out = []
        for root in self._peer_node_roots():
            d = root / tiers.version_dir_name(version)
            if d.is_dir():
                out.append(d)
        return out

    def version_dir(self, version: int) -> Path:
        return self._local.version_dir(version)

    def materialize(self, version: int) -> Optional[Path]:
        """Return a complete local v-<K> dir, recovering it if necessary."""
        vdir = self._local.version_dir(version)
        if self._complete(vdir):
            return vdir
        try:
            recovered = None
            if self.redundancy == "PARTNER" and self.n_nodes > 1:
                recovered = self._recover_partner(version)
        except (OSError, CheckpointError, json.JSONDecodeError) as exc:
            raise CheckpointError(
                f"node-tier recovery of {self.name} v-{version} failed: {exc}"
            ) from exc
        if recovered is not None:
            return recovered
        # Elastic M>N: this node never wrote the version (it joined after the
        # topology change) — seed the local tree from any peer node's copy so
        # non-array files (pods, manifests) are present; array shards beyond
        # the copied node's are range-read via aux_read_dirs.
        return self._recover_from_peer(version)

    def _recover_from_peer(self, version: int) -> Optional[Path]:
        for root in self._peer_node_roots():
            src = root / tiers.version_dir_name(version)
            if src.is_dir() and any(src.iterdir()):
                dst = self._local.version_dir(version)
                shutil.rmtree(dst, ignore_errors=True)
                dst.parent.mkdir(parents=True, exist_ok=True)
                shutil.copytree(src, dst)
                return dst
        return None

    def _complete(self, vdir: Path) -> bool:
        return vdir.is_dir() and any(vdir.iterdir())

    def _recover_partner(self, version: int) -> Optional[Path]:
        src = self._mirror_root(self.nid) / tiers.version_dir_name(version)
        if not src.is_dir():
            return None
        dst = self._local.version_dir(version)
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(src, dst)
        return dst

    def invalidate_all(self) -> None:
        """Wipe this checkpoint from *every* node tree, not just our own.

        With elastic restores, peer trees are live restore sources
        (``aux_read_dirs`` / peer-copy recovery) — leaving a stale sibling
        behind after a nested-parent publish would let a topology change
        resurrect an invalidated child version.  The walk covers every
        ``node-*`` dir on the shared FS plus every mirror and parity tree
        that could name this checkpoint.
        """
        self._local.invalidate_all()
        for p in self.base.glob("node-*"):
            shutil.rmtree(p / self.name, ignore_errors=True)
            for mirror in p.glob("mirror-of-*"):
                shutil.rmtree(mirror / self.name, ignore_errors=True)
            for parity in p.glob("xor-group-*"):
                shutil.rmtree(parity / self.name, ignore_errors=True)
            for parity in p.glob("rs-group-*"):
                shutil.rmtree(parity / self.name, ignore_errors=True)
