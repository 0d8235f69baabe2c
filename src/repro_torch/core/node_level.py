"""Node-level checkpoint tier — the SCR analog (paper §2.4) on GPU hosts.

The paper reduces checkpoint overhead by writing frequent small checkpoints
to *node-local* storage and only occasionally to the parallel file system;
SCR adds redundancy so a single node failure does not lose the node-tier
data: *partner* (full copy on a neighbor) or *partner-XOR* (parity group).

"Node-local" is the host-local SSD/ramdisk of each GPU host.  Here a node's
storage is the directory ``<base>/node-<nid>/`` — in the test cluster all
nodes share one filesystem, so cross-node reads stand in for the
RDMA/collective transfers a real fleet would use.  The parity math and the
member digests run on the store's ``device``: the hand-written
``xor_reduce`` / ``gf_matmul`` / ``checksum`` CUDA kernels on a card (the
payload bytes cross to it and back), their plain versions on the CPU.

Redundancy policies (``CRAFT_NODE_REDUNDANCY``):

  * ``LOCAL``   — no redundancy; a lost node forces a PFS restore.
  * ``PARTNER`` — the node leader mirrors the node's version directory onto
    the next node (paper: "recover restart data from the failed node's
    neighbor").
  * ``XOR``     — nodes form groups of ``CRAFT_XOR_GROUP_SIZE``; one member
    (rotating with the version number, RAID-5 style) stores the XOR parity
    of every member's payload; any single lost member is rebuilt from the
    parity + survivors (SCR's partner-XOR level).
  * ``RS``      — the same groups protected by an RS(k, m) erasure code
    (``CRAFT_RS_PARITY`` parity buffers, rotating placement): any ``m``
    simultaneously lost members rebuild bit-identically, and the parity
    manifest's per-member/per-row kernel digests let the background
    scrubber verify and repair rot (:mod:`repro_torch.core.erasure`).

Restore goes through :meth:`NodeStore.materialize`, which transparently
rebuilds a missing local version from the partner mirror or the parity group
before handing the directory to ``Checkpoint``.

``NodeStore`` is a :class:`~repro_torch.core.tiers.StorageTier`: the local
store is a plain :class:`~repro_torch.core.storage.VersionStore`, and the
mirror / parity
side-trees reuse the same atomic tmp→rename and retention helpers from
:mod:`repro_torch.core.tiers` instead of re-implementing them.  XOR parity
manifests additionally record the kernel Fletcher digest of every member's
payload, so a reconstruction can tell a stale survivor from a valid one.
"""
from __future__ import annotations

import json
import shutil
import time as _time
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.core import erasure, metrics, storage, tiers
from repro_torch.core.cpbase import CheckpointError
from repro_torch.core.tiers import StorageTier
from repro_torch.kernels.xor_parity import ops as xor_ops


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

    def __init__(self, base: Path, name: str, comm, env, device="cuda"):
        self.base = Path(base)
        self.device = str(device)     # where parity math and digests run
        self.name = name
        self.comm = comm
        self.env = env
        self.redundancy = env.node_redundancy
        self.group_size = max(1, env.xor_group_size)
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

    def _group(self, nid: int) -> List[int]:
        g0 = (nid // self.group_size) * self.group_size
        return [n for n in range(g0, min(g0 + self.group_size, self.n_nodes))]

    def _parity_holder(self, nid: int, version: int) -> int:
        grp = self._group(nid)
        return grp[version % len(grp)]

    def _parity_root(self, nid: int, version: int) -> Path:
        holder = self._parity_holder(nid, version)
        g0 = self._group(nid)[0]
        return self._node_dir(holder) / f"xor-group-{g0}" / self.name

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
            elif self.redundancy == "XOR":
                self._chaos_check("replicate", path=staged)
                self._publish_xor(version)
            elif self.redundancy == "RS":
                self._chaos_check("replicate", path=staged)
                erasure.publish_rs(self, version)
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

    def _publish_xor(self, version: int) -> None:
        # The parity holder's leader computes the group parity.
        if self._parity_holder(self.nid, version) != self.nid:
            return
        group = self._group(self.nid)
        payloads: Dict[int, bytes] = {}
        manifest: Dict[str, dict] = {}
        for member in group:
            # same payload/manifest-entry definition as the RS path
            payloads[member], manifest[str(member)] = erasure.collect_member(
                self, member, version)
        parity = xor_ops.parity_of_buffers([payloads[m] for m in group],
                                           self.device)
        del payloads
        root = self._parity_root(self.nid, version)
        with erasure.timed("write"):
            tmp = root / tiers.staging_dir_name(version)
            shutil.rmtree(tmp, ignore_errors=True)
            tmp.mkdir(parents=True)
            (tmp / "parity.bin").write_bytes(parity)
            storage.write_json(tmp / "manifest.json", manifest)
            tiers.atomic_publish_dir(tmp,
                                     root / tiers.version_dir_name(version))
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
        elif self.redundancy == "XOR":
            # any version whose parity manifest exists is recoverable
            for holder in self._group(self.nid):
                g0 = self._group(self.nid)[0]
                root = self._node_dir(holder) / f"xor-group-{g0}" / self.name
                for v, p in tiers.list_version_dirs(root):
                    if (p / "manifest.json").exists():
                        best = max(best, v)
        elif self.redundancy == "RS":
            best = max(best, erasure.latest_rs_version(self))
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
            elif self.redundancy == "XOR":
                recovered = self._recover_xor(version)
            elif self.redundancy == "RS":
                recovered = erasure.recover_rs(self, version)
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

    def _recover_xor(self, version: int) -> Optional[Path]:
        root = self._parity_root(self.nid, version)
        pdir = root / tiers.version_dir_name(version)
        if not (pdir / "manifest.json").exists():
            return None
        manifest = storage.read_json(pdir / "manifest.json")
        group = self._group(self.nid)
        my_entry = manifest.get(str(self.nid))
        if my_entry is None:
            return None
        survivors = []
        for member in group:
            if member == self.nid:
                continue
            # shared stale-survivor definition (erasure.read_member_payload):
            # XOR can rebuild exactly one member, so an unreadable/stale
            # survivor is fatal here, not merely "also lost" as under RS
            payload = erasure.read_member_payload(
                self, member, version, manifest[str(member)])
            if payload is None:
                raise CheckpointError(
                    f"survivor node {member} payload unreadable, short or "
                    "digest-mismatched (stale or corrupt survivor data)"
                )
            survivors.append(payload)
        with erasure.timed("read"):
            parity = (pdir / "parity.bin").read_bytes()
        mine = xor_ops.reconstruct_member(parity, survivors, my_entry["size"],
                                          self.device)
        del parity, survivors
        return erasure.write_member(self, version, my_entry, mine)

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
        if self.redundancy == "RS":
            erasure.invalidate_rs(self)

    # -- scrub hooks (core/scrubber.py) ---------------------------------------
    def forget_version(self, version: int) -> None:
        """Quarantine helper: drop the *local* copy of ``version`` so the
        next materialize() rebuilds it from the redundancy peers."""
        self._local.forget_version(version)

    def scrub_redundancy(self, version: int) -> dict:
        """Verify (and repair) this version's redundancy side-trees.

        RS parity shards carry manifest digests and are re-encoded in place
        when rotted (``erasure.scrub_rs``); the PARTNER mirror and XOR
        parity have no self-digest to check here — their staleness is
        caught at rebuild time against the member digests instead.
        """
        if self.redundancy == "RS":
            return erasure.scrub_rs(self, version)
        return {"bytes": 0, "checked": 0, "repaired": 0, "unrepairable": 0}
