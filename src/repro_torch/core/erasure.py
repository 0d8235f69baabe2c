"""Reed–Solomon erasure redundancy for the node tier (``CRAFT_NODE_REDUNDANCY=RS``).

The paper's node-level redundancy (via SCR, §2.4) tops out at partner
mirrors and single-loss XOR parity; fleets past a few hundred hosts lose
two nodes of one group often enough that single-failure tolerance is the
availability ceiling (ReStore, FTHP-MPI).  ``RS`` generalizes the XOR
parity group to an RS(k, m) code: the k members of a node group
(``CRAFT_XOR_GROUP_SIZE``) are protected by ``m = CRAFT_RS_PARITY`` parity
buffers, so **any m simultaneously lost members** rebuild bit-identically —
``m=1`` degenerates to the XOR tier (the coding matrix's first row is all
ones, see :mod:`repro_torch.kernels.rs_erasure`).

Placement rotates RAID-5 style per row *and* version: parity row ``j`` of
version ``v`` lives on group member ``(v + j) % k``, so consecutive rows
land on distinct members and no single node becomes the parity hotspot.
Layout on the holder node::

    <node-dir>/rs-group-<g0>/<name>/v-<K>/
        parity-<j>.bin      # only the rows this member holds
        manifest.json       # identical on every holder

The manifest records, per member, the file list + payload size + kernel
Fletcher digest (stale-survivor detection, like the XOR manifest) and, per
parity row, the row digest — which is what lets the background scrubber
(:mod:`repro_torch.core.scrubber`) verify and re-encode rotted parity shards
without touching the members.

Like the XOR path, every holder reads the group members through the shared
filesystem (the test/bench cluster's stand-in for the RDMA transfers of a
real fleet); the GF(2^8) math and the member/parity digests run on the
store's ``device``: the hand-written ``gf_matmul`` and ``checksum`` CUDA
kernels on a card, their plain versions on the CPU.

Each stage of an encode or rebuild adds its seconds to the metrics counter
``parity_seconds{stage=...}`` (``CRAFT_METRICS``): ``read`` (member and
parity files), ``digest``, ``write`` (parity files and rebuilt members),
beside the device stages the kernel ops record (``pad``, ``h2d``,
``kernel``, ``d2h``).
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from repro_torch.core import storage, tiers
from repro_torch.core.cpbase import CheckpointError
from repro_torch.kernels.checksum import ops as checksum_ops
from repro_torch.kernels.rs_erasure import ops as rs_ops
from repro_torch.kernels.xor_parity.ops import timed


def digest(store, data) -> list:
    """``[s1, s2]`` of ``data`` on the store's device."""
    with timed("digest"):
        s1, s2 = checksum_ops.digest_bytes(data, store.device)
    return [int(s1), int(s2)]


def holder_of(group: List[int], version: int, row: int) -> int:
    """Node holding parity row ``row`` of ``version`` (rotating placement)."""
    return group[(version + row) % len(group)]


def parity_root(store, version: int) -> Dict[int, Path]:
    """{parity row: holder's rs-group side-tree root} for ``version``."""
    group = store._group(store.nid)
    g0 = group[0]
    return {
        j: store._node_dir(holder_of(group, version, j))
        / f"rs-group-{g0}" / store.name
        for j in range(store.env.rs_parity)
    }


def collect_member(store, member: int, version: int) -> Tuple[bytes, dict]:
    """A member's concatenated payload + its manifest entry (files, digest).

    The entry shape ``{"files", "size", "digest"}`` is shared with the XOR
    path (``NodeStore._publish_xor`` builds its manifest through this
    helper), so both redundancy modes agree on what a member payload is.
    """
    vdir = store._member_version_dir(member, version)
    with timed("read"):
        files = sorted(p for p in vdir.rglob("*") if p.is_file())
        blob = bytearray()
        entries = []
        for p in files:
            data = p.read_bytes()
            entries.append({"rel": str(p.relative_to(vdir)),
                            "size": len(data)})
            blob += data
        payload = bytes(blob)
    return payload, {
        "files": entries, "size": len(payload),
        "digest": digest(store, payload),
    }


def read_member_payload(store, member: int, version: int,
                        ment: dict) -> Optional[bytes]:
    """Re-read a member's payload per its manifest entry, fully verified.

    Returns ``None`` when any file is unreadable or the reassembled payload
    is short or digest-mismatched — the single definition of a *stale
    survivor* for both the XOR and RS recovery paths.
    """
    vdir = store._member_version_dir(member, version)
    try:
        with timed("read"):
            blob = bytearray()
            for ent in ment["files"]:
                blob += (vdir / ent["rel"]).read_bytes()
            payload = bytes(blob)
    except OSError:
        return None
    if len(payload) != int(ment["size"]):
        return None
    if "digest" in ment:    # pre-digest manifests verify by size alone
        if digest(store, payload) != list(ment["digest"]):
            return None
    return payload


def publish_rs(store, version: int) -> None:
    """Encode and publish the parity rows this node holds for ``version``.

    Every holder encodes the full parity set (the group is small; encoding
    all rows lets the manifest carry every row's digest so scrub can verify
    shards it does not hold) but writes only its own rows.
    """
    group = store._group(store.nid)
    m = store.env.rs_parity
    my_rows = [j for j in range(m)
               if holder_of(group, version, j) == store.nid]
    if not my_rows:
        return
    payloads: Dict[int, bytes] = {}
    members: Dict[str, dict] = {}
    for member in group:
        payloads[member], members[str(member)] = collect_member(
            store, member, version)
    parity = rs_ops.encode_parity([payloads[n] for n in group], m,
                                  store.device)
    del payloads
    parity_meta = {}
    for j in range(m):
        parity_meta[str(j)] = {
            "holder": holder_of(group, version, j),
            "size": len(parity[j]),
            "digest": digest(store, parity[j]),
        }
    manifest = {
        "k": len(group), "m": m, "group": list(group),
        "members": members, "parity": parity_meta,
    }
    root = parity_root(store, version)[my_rows[0]]
    with timed("write"):
        tmp = root / tiers.staging_dir_name(version)
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        for j in my_rows:
            (tmp / f"parity-{j}.bin").write_bytes(parity[j])
        storage.write_json(tmp / "manifest.json", manifest)
        tiers.atomic_publish_dir(tmp, root / tiers.version_dir_name(version))
        tiers.retire_version_dirs(root, store.env.keep_versions)


def _load_parities(store, version: int) -> Tuple[Optional[dict], Dict[int, bytes]]:
    """(manifest, {row: verified parity bytes}) readable for ``version``.

    A parity shard whose bytes no longer match the manifest digest is
    treated as lost (never fed into the solve), exactly like a stale
    survivor — rot in a parity buffer must not poison the rebuild.
    """
    manifest = None
    raw: Dict[int, bytes] = {}
    with timed("read"):
        for j, root in parity_root(store, version).items():
            pdir = root / tiers.version_dir_name(version)
            mpath = pdir / "manifest.json"
            if manifest is None and mpath.exists():
                manifest = storage.read_json(mpath)
            ppath = pdir / f"parity-{j}.bin"
            if ppath.exists():
                raw[j] = ppath.read_bytes()
    if manifest is None:
        return None, {}
    parities: Dict[int, bytes] = {}
    for j, data in raw.items():
        pmeta = manifest.get("parity", {}).get(str(j))
        if pmeta is None:
            continue
        if digest(store, data) == list(pmeta["digest"]):
            parities[j] = data
    return manifest, parities


def _classify_members(store, manifest: dict, version: int
                      ) -> Tuple[Dict[int, bytes], List[int], List[int]]:
    """(present {position: payload}, lost positions, member sizes).

    A member whose payload is unreadable, short, or digest-mismatched
    counts as lost — a stale survivor served into the solve would rebuild
    garbage bit-exactly labeled as good.
    """
    group = list(manifest["group"])
    present: Dict[int, bytes] = {}
    lost: List[int] = []
    sizes: List[int] = []
    for pos, member in enumerate(group):
        ment = manifest["members"].get(str(member))
        if ment is None:
            raise CheckpointError(
                f"RS parity manifest is missing member {member} "
                "(malformed manifest)"
            )
        sizes.append(int(ment["size"]))
        payload = read_member_payload(store, member, version, ment)
        if payload is None:
            lost.append(pos)
        else:
            present[pos] = payload
    return present, lost, sizes


def recover_rs(store, version: int) -> Optional[Path]:
    """Rebuild this node's ``v-<version>`` directory from the RS group.

    Returns the rebuilt local directory, ``None`` when no parity manifest
    exists for the version, and raises :class:`CheckpointError` when more
    members are lost than readable parity shards can solve.
    """
    manifest, parities = _load_parities(store, version)
    if manifest is None:
        return None
    group = list(manifest["group"])
    if store.nid not in group:
        return None
    present, lost, sizes = _classify_members(store, manifest, version)
    my_pos = group.index(store.nid)
    if my_pos not in lost:
        lost.append(my_pos)          # we are here because local is incomplete
        present.pop(my_pos, None)
    if len(lost) > len(parities):
        raise CheckpointError(
            f"RS group of {store.name} v-{version}: {len(lost)} members lost "
            f"but only {len(parities)} verified parity shards available "
            f"(m={manifest['m']})"
        )
    rebuilt = rs_ops.decode_lost(
        len(group), int(manifest["m"]), present, parities, sizes,
        store.device)
    mine = rebuilt[my_pos]
    del rebuilt, present, parities
    ment = manifest["members"][str(store.nid)]
    return write_member(store, version, ment, mine)


def write_member(store, version: int, ment: dict, payload: bytes) -> Path:
    """Cut a rebuilt member payload back into its files (per its manifest
    entry) as this node's local ``v-<version>`` directory."""
    dst = store._local.version_dir(version)
    with timed("write"):
        shutil.rmtree(dst, ignore_errors=True)
        dst.mkdir(parents=True, exist_ok=True)
        offset = 0
        for ent in ment["files"]:
            out = dst / ent["rel"]
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_bytes(payload[offset: offset + ent["size"]])
            offset += ent["size"]
    return dst


def latest_rs_version(store) -> int:
    """Newest version with a readable RS parity manifest anywhere in the group."""
    best = 0
    group = store._group(store.nid)
    g0 = group[0]
    for holder in group:
        root = store._node_dir(holder) / f"rs-group-{g0}" / store.name
        for v, p in tiers.list_version_dirs(root):
            if (p / "manifest.json").exists():
                best = max(best, v)
    return best


def invalidate_rs(store) -> None:
    group = store._group(store.nid)
    g0 = group[0]
    for holder in group:
        shutil.rmtree(store._node_dir(holder) / f"rs-group-{g0}" / store.name,
                      ignore_errors=True)


def scrub_rs(store, version: int) -> dict:
    """Verify this version's parity shards; re-encode rotted rows in place.

    Returns ``{"bytes", "checked", "repaired", "unrepairable"}``.  A row is
    only re-encoded when **every** group member's payload still matches its
    manifest digest — re-encoding over a rotted member would launder data
    corruption into fresh-looking parity.
    """
    stats = {"bytes": 0, "checked": 0, "repaired": 0, "unrepairable": 0}
    try:
        manifest, _ = _load_parities(store, version)
    except (OSError, json.JSONDecodeError):
        return stats
    if manifest is None:
        return stats
    group = list(manifest["group"])
    m = int(manifest["m"])
    bad_rows = []
    for j, root in parity_root(store, version).items():
        pdir = root / tiers.version_dir_name(version)
        ppath = pdir / f"parity-{j}.bin"
        pmeta = manifest.get("parity", {}).get(str(j))
        if pmeta is None or not pdir.is_dir():
            continue
        stats["checked"] += 1
        with timed("read"):
            data = ppath.read_bytes() if ppath.exists() else b""
        stats["bytes"] += len(data)
        if not data or digest(store, data) != list(pmeta["digest"]):
            bad_rows.append((j, ppath))
    if not bad_rows:
        return stats
    try:
        present, lost, _ = _classify_members(store, manifest, version)
    except CheckpointError:
        stats["unrepairable"] += len(bad_rows)
        return stats
    if lost:
        # can't re-encode without every member intact; the rotted row stays
        # flagged (recovery will simply not use it)
        stats["unrepairable"] += len(bad_rows)
        return stats
    parity = rs_ops.encode_parity([present[p] for p in range(len(group))], m,
                                  store.device)
    for j, ppath in bad_rows:
        with timed("write"):
            tmp = ppath.with_name(f".tmp-{ppath.name}")
            tmp.write_bytes(parity[j])
            tmp.replace(ppath)
        stats["repaired"] += 1
    return stats
