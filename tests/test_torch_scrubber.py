"""The port's background integrity scrubber: detection, repair, throttling,
quarantine — the reference's ``test_scrubber.py`` run against
``repro_torch`` on the CPU: injected chunk corruption on every tier (mem /
node / pfs) is detected and repaired without a restore ever observing bad
bytes, plus bf16 files repaired under their own dtype.
"""
import gc
import shutil
import weakref
from pathlib import Path

import numpy as np
import pytest

import torch

from repro_torch.core import Box
from repro_torch.core import Checkpoint as _Checkpoint
from repro_torch.core.comm_sim import SimWorld
from repro_torch.core.cpbase import CheckpointError
from repro_torch.core.env import CraftEnv
from repro_torch.core.mem_level import MemFabric
from repro_torch.core.node_level import NodeStore as _NodeStore
from repro_torch.core.scrubber import corrupt_file

from test_node_level import FakeComm


def Checkpoint(*args, **kwargs):
    """The port's Checkpoint on the CPU (the tests run without a card)."""
    kwargs.setdefault("device", "cpu")
    return _Checkpoint(*args, **kwargs)


@pytest.fixture(autouse=True)
def _port_mem_fabric_isolation():
    """The port's RAM fabric is process-global like the reference's (which
    conftest resets): wipe it around every test."""
    MemFabric.instance().reset()
    yield
    MemFabric.instance().reset()


def NodeStore(**kwargs):
    return _NodeStore(device="cpu", **kwargs)


def _env(tmp_path, **extra):
    return CraftEnv.capture({
        "CRAFT_CP_PATH": str(tmp_path / "pfs"),
        "CRAFT_NODE_CP_PATH": str(tmp_path / "node"),
        "CRAFT_NODE_REDUNDANCY": "LOCAL",
        "CRAFT_MEM_SCRATCH": str(tmp_path / "shm"),
        **{k: str(v) for k, v in extra.items()},
    })


def _write(env, data, name="s"):
    cp = Checkpoint(name, FakeComm(0, 1), env=env)
    cp.add("arr", data.copy())
    cp.commit()
    cp.update_and_write()
    return cp


def _restore(env, like, name="s"):
    target = np.zeros_like(like)
    cp = Checkpoint(name, FakeComm(0, 1), env=env)
    cp.add("arr", target)
    cp.commit()
    ok = cp.restart_if_needed()
    return ok, target, cp


@pytest.fixture()
def data(rng):
    return rng.standard_normal(100_000).astype(np.float32)


# ======================================================== detection + repair
class TestScanRepair:
    def test_node_rot_repaired_from_pfs(self, tmp_path, data):
        env = _env(tmp_path)
        cp = _write(env, data)
        node_file = (tmp_path / "node" / "node-0" / "s" / "v-1"
                     / "arr" / "array.bin")
        good = node_file.read_bytes()
        corrupt_file(node_file)
        st = cp.scrubber.scan_once()
        assert st["corrupt_found"] == 1 and st["repaired"] == 1
        assert node_file.read_bytes() == good       # bit-identical re-encode
        ok, target, rcp = _restore(env, data)
        assert ok and np.array_equal(target, data)
        assert rcp.stats["restore_tier"] == "node"
        assert rcp.stats["read_repairs"] == 0       # nothing left to repair

    def test_pfs_rot_repaired_from_node(self, tmp_path, data):
        env = _env(tmp_path)
        cp = _write(env, data)
        pfs_file = tmp_path / "pfs" / "s" / "v-1" / "arr" / "array.bin"
        good = pfs_file.read_bytes()
        corrupt_file(pfs_file)
        st = cp.scrubber.scan_once()
        assert st["corrupt_found"] == 1 and st["repaired"] == 1
        assert pfs_file.read_bytes() == good

    def test_mem_rot_repaired_from_disk(self, tmp_path, data):
        env = _env(tmp_path, CRAFT_TIER_CHAIN="mem,node,pfs")
        cp = _write(env, data)
        MemFabric.instance().corrupt_entry("s", 0, 1)
        st = cp.scrubber.scan_once()
        assert st["corrupt_found"] == 1 and st["repaired"] == 1
        ok, target, rcp = _restore(env, data)
        assert ok and np.array_equal(target, data)
        assert rcp.stats["restore_tier"] == "mem"   # RAM serves good bytes

    def test_every_tier_corrupt_one_scan_repairs_all(self, tmp_path, rng):
        """The acceptance sweep: rot injected on mem, node and pfs at once
        (on different payloads, so each has a healthy peer copy left)."""
        env = _env(tmp_path, CRAFT_TIER_CHAIN="mem,node,pfs")
        a = rng.standard_normal(50_000).astype(np.float32)
        b = rng.standard_normal(50_000).astype(np.float32)
        cp = Checkpoint("s", FakeComm(0, 1), env=env)
        cp.add("a", a.copy())
        cp.add("b", b.copy())
        cp.commit()
        cp.update_and_write()
        corrupt_file(tmp_path / "node" / "node-0" / "s" / "v-1"
                     / "a" / "array.bin")
        corrupt_file(tmp_path / "pfs" / "s" / "v-1" / "b" / "array.bin")
        MemFabric.instance().corrupt_entry("s", 0, 1, rel="a/array.bin")
        st = cp.scrubber.scan_once()
        assert st["corrupt_found"] == 3, st
        assert st["repaired"] == 3, st
        ta, tb = np.zeros_like(a), np.zeros_like(b)
        rcp = Checkpoint("s", FakeComm(0, 1), env=env)
        rcp.add("a", ta)
        rcp.add("b", tb)
        rcp.commit()
        assert rcp.restart_if_needed()
        assert np.array_equal(ta, a) and np.array_equal(tb, b)
        assert rcp.stats["restore_tier"] == "mem"
        assert rcp.stats["read_repairs"] == 0
        # a second pass confirms the fleet is clean
        assert cp.scrubber.scan_once()["corrupt_found"] == 0

    def test_same_file_rotted_everywhere_is_unrepairable(self, tmp_path, data):
        """Every copy of one payload rotted: nothing healthy to repair from —
        the scrubber reports it instead of inventing bytes."""
        env = _env(tmp_path, CRAFT_TIER_CHAIN="mem,node,pfs")
        cp = _write(env, data)
        corrupt_file(tmp_path / "node" / "node-0" / "s" / "v-1"
                     / "arr" / "array.bin")
        corrupt_file(tmp_path / "pfs" / "s" / "v-1" / "arr" / "array.bin")
        MemFabric.instance().corrupt_entry("s", 0, 1)
        st = cp.scrubber.scan_once()
        assert st["corrupt_found"] == 3
        assert st["repaired"] == 0 and st["unrepairable"] >= 1

    def test_clean_scan_touches_everything_finds_nothing(self, tmp_path, data):
        env = _env(tmp_path, CRAFT_TIER_CHAIN="mem,node,pfs")
        cp = _write(env, data)
        st = cp.scrubber.scan_once()
        assert st["corrupt_found"] == 0
        assert st["files_scanned"] >= 3             # one payload per tier
        assert st["bytes_scanned"] >= 3 * data.nbytes

    def test_delta_base_rot_detected_and_repaired(self, tmp_path, rng):
        """Chain verification: rot in a *base* chunk that a delta version
        references is caught and fixed before any restore walks the chain."""
        env = _env(tmp_path, CRAFT_DELTA="1", CRAFT_CHUNK_BYTES=4096,
                   CRAFT_KEEP_VERSIONS="3")
        data = rng.standard_normal(32_768).astype(np.float32)
        cp = Checkpoint("d", FakeComm(0, 1), env=env)
        cp.add("arr", data)
        cp.commit()
        cp.update_and_write()                       # v1: full
        data[:16] += 1.0                            # one dirty chunk
        cp.update_and_write()                       # v2: delta onto v1
        base = (tmp_path / "node" / "node-0" / "d" / "v-1"
                / "arr" / "array.bin")
        good = base.read_bytes()
        corrupt_file(base)
        st = cp.scrubber.scan_once()
        assert st["corrupt_found"] >= 1 and st["repaired"] >= 1
        assert base.read_bytes() == good
        ok, target, rcp = _restore(env, data, name="d")
        assert ok and np.array_equal(target, data)

    def test_json_rot_repaired_by_copy(self, tmp_path, data):
        env = _env(tmp_path, CRAFT_DELTA="1")
        cp = Checkpoint("j", FakeComm(0, 1), env=env)
        cp.add("arr", data.copy())
        cp.commit()
        cp.update_and_write()
        deps = (tmp_path / "node" / "node-0" / "j" / "v-1"
                / "deltadeps-0.json")
        deps.write_text("{ not json")
        st = cp.scrubber.scan_once()
        assert st["corrupt_found"] == 1 and st["repaired"] == 1


# ======================================================== repair-on-read
class TestRepairOnRead:
    def test_restore_repairs_and_serves_good_bytes(self, tmp_path, data):
        env = _env(tmp_path)
        _write(env, data).close()
        corrupt_file(tmp_path / "node" / "node-0" / "s" / "v-1"
                     / "arr" / "array.bin")
        ok, target, rcp = _restore(env, data)
        assert ok and np.array_equal(target, data)
        assert rcp.stats["restore_tier"] == "node"
        assert rcp.stats["read_repairs"] == 1

    def test_no_source_never_serves_bad_bytes(self, tmp_path, data):
        """Every copy rotted: restore must raise, not hand back garbage."""
        env = _env(tmp_path)
        _write(env, data).close()
        corrupt_file(tmp_path / "node" / "node-0" / "s" / "v-1"
                     / "arr" / "array.bin")
        corrupt_file(tmp_path / "pfs" / "s" / "v-1" / "arr" / "array.bin")
        target = np.zeros_like(data)
        cp = Checkpoint("s", FakeComm(0, 1), env=env)
        cp.add("arr", target)
        cp.commit()
        with pytest.raises(CheckpointError):
            cp.restart_if_needed()
        assert np.all(target == 0.0)

    def test_failed_redundancy_rebuild_preserves_version_dir(self, tmp_path,
                                                             data):
        """Regression: a redundancy-backed tier whose rebuild *fails* (single
        node — the PARTNER mirror is gated on n_nodes > 1) must put the
        original directory back, healthy sibling files included, and then
        repair per-file from a peer tier instead of destroying the version.
        """
        env = _env(tmp_path, CRAFT_NODE_REDUNDANCY="PARTNER")
        other = data[::-1].copy()
        cp = Checkpoint("s", FakeComm(0, 1), env=env)
        cp.add("arr", data.copy())
        cp.add("other", other.copy())
        cp.commit()
        cp.update_and_write()
        vdir = tmp_path / "node" / "node-0" / "s" / "v-1"
        healthy = (vdir / "other" / "array.bin").read_bytes()
        corrupt_file(vdir / "arr" / "array.bin")
        st = cp.scrubber.scan_once()
        assert st["corrupt_found"] == 1 and st["repaired"] == 1
        assert vdir.is_dir()
        assert (vdir / "other" / "array.bin").read_bytes() == healthy
        ok, target, rcp = _restore(env, data)
        assert ok and np.array_equal(target, data)
        assert rcp.stats["restore_tier"] == "node"

    def test_failed_rebuild_no_peer_source_keeps_original(self, tmp_path,
                                                          data):
        """Redundancy rebuild fails AND no peer tier has the version: the
        rotted dir (with its healthy files) must survive untouched."""
        env = _env(tmp_path, CRAFT_NODE_REDUNDANCY="PARTNER",
                   CRAFT_PFS_EVERY="100")
        other = data[::-1].copy()
        cp = Checkpoint("s", FakeComm(0, 1), env=env)
        cp.add("arr", data.copy())
        cp.add("other", other.copy())
        cp.commit()
        cp.update_and_write()
        vdir = tmp_path / "node" / "node-0" / "s" / "v-1"
        healthy = (vdir / "other" / "array.bin").read_bytes()
        corrupt_file(vdir / "arr" / "array.bin")
        st = cp.scrubber.scan_once()
        assert st["corrupt_found"] == 1
        assert st["unrepairable"] == 1 and st["quarantined"] == 0
        assert vdir.is_dir()
        assert (vdir / "other" / "array.bin").read_bytes() == healthy

    def test_single_tier_unrepairable_is_not_quarantined(self, tmp_path, data):
        """The last copy — even a rotten one — is never deleted."""
        env = _env(tmp_path, CRAFT_USE_SCR="0", CRAFT_TIER_CHAIN="pfs")
        cp = _write(env, data)
        pfs_file = tmp_path / "pfs" / "s" / "v-1" / "arr" / "array.bin"
        corrupt_file(pfs_file)
        st = cp.scrubber.scan_once()
        assert st["corrupt_found"] == 1
        assert st["unrepairable"] == 1 and st["quarantined"] == 0
        assert pfs_file.exists()


# ======================================================== RS parity scrub
def _rs_group_env(tmp_path):
    return CraftEnv.capture({
        "CRAFT_CP_PATH": str(tmp_path / "pfs"),
        "CRAFT_NODE_CP_PATH": str(tmp_path / "node"),
        "CRAFT_NODE_REDUNDANCY": "RS",
        "CRAFT_XOR_GROUP_SIZE": "4",
        "CRAFT_RS_PARITY": "2",
        "CRAFT_PFS_EVERY": "100",
    })


def _write_rs_group(env, n_nodes=4):
    world = SimWorld(n_nodes, procs_per_node=1, env=env)

    def fn(comm):
        cp = Checkpoint("st", comm, env=env)
        cp.add("arr", np.full((64,), float(comm.rank + 1)))
        cp.commit()
        cp.update_and_write()
        cp.close()

    world.run(fn, timeout=120)


class TestRSScrub:
    def test_rotted_parity_shard_reencoded(self, tmp_path):
        env = _rs_group_env(tmp_path)
        _write_rs_group(env)
        shard = next((tmp_path / "node").glob(
            "node-*/rs-group-0/st/v-1/parity-*.bin"))
        good = shard.read_bytes()
        corrupt_file(shard, offset=10)
        store = NodeStore(base=env.node_cp_path, name="st",
                          comm=FakeComm(0, 4), env=env)
        stats = store.scrub_redundancy(1)
        assert stats["repaired"] == 1
        assert shard.read_bytes() == good

    def test_member_rot_repaired_via_parity_rebuild(self, tmp_path):
        env = _rs_group_env(tmp_path)
        _write_rs_group(env)
        member = (tmp_path / "node" / "node-1" / "st" / "v-1"
                  / "arr" / "array.bin")
        good = member.read_bytes()
        corrupt_file(member)
        cp = Checkpoint("st", FakeComm(1, 4), env=env)
        cp.add("arr", np.zeros((64,)))
        cp.commit()
        st = cp.scrubber.scan_once()
        assert st["corrupt_found"] == 1 and st["repaired"] == 1
        assert member.read_bytes() == good          # parity rebuild, bit-exact

    def test_rotted_member_not_laundered_into_parity(self, tmp_path):
        """scrub_redundancy refuses to re-encode parity over a rotted member."""
        env = _rs_group_env(tmp_path)
        _write_rs_group(env)
        corrupt_file(tmp_path / "node" / "node-2" / "st" / "v-1"
                     / "arr" / "array.bin")
        shard = next((tmp_path / "node").glob(
            "node-*/rs-group-0/st/v-1/parity-*.bin"))
        corrupt_file(shard, offset=10)
        store = NodeStore(base=env.node_cp_path, name="st",
                          comm=FakeComm(0, 4), env=env)
        stats = store.scrub_redundancy(1)
        assert stats["repaired"] == 0 and stats["unrepairable"] == 1


# ======================================================== scheduling/throttle
class TestScheduling:
    def _cp(self, tmp_path, clock, **extra):
        # cadence pfs:2 → every other opportunity writes, the rest are the
        # idle windows scrub slices ride on
        env = _env(tmp_path, CRAFT_USE_SCR="0", CRAFT_TIER_CHAIN="pfs",
                   CRAFT_IO_WORKERS="1", CRAFT_TIER_EVERY="pfs:2",
                   **extra)
        cp = Checkpoint("t", FakeComm(0, 1), env=env, clock=clock)
        cp.add("arr", np.ones(8192, dtype=np.float32))
        cp.commit()
        return cp

    def test_scrub_rides_idle_opportunities(self, tmp_path):
        t = [0.0]
        it = iter(range(1, 100))
        cp = self._cp(tmp_path, lambda: t[0], CRAFT_SCRUB_EVERY="10")
        assert cp.update_and_write(next(it)) or cp.update_and_write(next(it))
        for _ in range(4):                          # idle-ish steps, +4 s
            t[0] += 1.0
            cp.update_and_write(next(it))
        assert cp.scrubber.stats["slices"] == 0     # 10 s not yet elapsed
        t[0] += 10.0
        while cp.update_and_write(next(it)):        # land on a skip step
            pass
        assert cp.scrubber.stats["slices"] == 1
        assert cp.policy.stats["scrub_slices"] == 1
        assert cp.scrubber.stats["files_scanned"] >= 1

    def test_scrub_disabled_by_default(self, tmp_path):
        t = [0.0]
        cp = self._cp(tmp_path, lambda: t[0])
        cp.update_and_write(1)
        cp.update_and_write(2)
        t[0] += 1e6
        cp.update_and_write(3)
        cp.update_and_write(4)
        assert cp.scrubber.stats["slices"] == 0

    def test_bytes_per_s_throttle_slices_the_pass(self, tmp_path):
        t = [0.0]
        cp = self._cp(tmp_path, lambda: t[0], CRAFT_SCRUB_EVERY="1",
                      CRAFT_SCRUB_BYTES_PER_S="1", CRAFT_KEEP_VERSIONS="4")
        for it in range(1, 9):                      # lands 4 versions on pfs
            cp.update_and_write(it)
        assert cp.version >= 3
        # 1 B/s budget → each slice verifies exactly one version
        scanned = []
        for it in range(100, 108):
            t[0] += 2.0
            if not cp.update_and_write(it):
                scanned.append(cp.scrubber.stats["files_scanned"])
        assert cp.scrubber.stats["slices"] >= 3
        assert scanned == sorted(scanned)           # progress each slice
        assert scanned[-1] > scanned[0]             # but never all at once
        assert scanned[0] <= 2                      # first slice: one version


class TestPortDtypes:
    @pytest.mark.parametrize("source", ["mem", "node"])
    def test_bf16_file_repaired_under_its_own_dtype(self, tmp_path, source):
        """A rotted bf16 pfs file re-encoded from a healthy copy (RAM fabric
        or node tier) is byte-identical to the original, dtype included."""
        chain = "mem,node,pfs" if source == "mem" else "node,pfs"
        env = _env(tmp_path, CRAFT_TIER_CHAIN=chain, CRAFT_PFS_EVERY=1)
        g = torch.Generator().manual_seed(5)
        w = torch.randn((300, 41), generator=g).to(torch.bfloat16)
        cp = Checkpoint("bf", FakeComm(0, 1), env=env)
        cp.add("w", Box(w))
        cp.commit()
        cp.update_and_write()
        files = sorted((tmp_path / "pfs" / "bf" / "v-1").rglob("*.bin"))
        good = [f.read_bytes() for f in files]
        corrupt_file(files[0])
        st = cp.scrubber.scan_once()
        assert st["corrupt_found"] == 1 and st["repaired"] == 1
        assert [f.read_bytes() for f in files] == good
        cp.close()


class TestLifetime:
    def test_a_closed_checkpoint_is_freed_without_the_collector(
            self, tmp_path, data):
        """The scrubber holds its checkpoint by a weak proxy, so dropping a
        closed checkpoint frees it, its items and their tensors at once,
        with no garbage collection; while the caller holds it, its scrubber
        still scans."""
        env = _env(tmp_path)
        box = Box(torch.arange(4096, dtype=torch.float32))
        gc.disable()
        try:
            cp = Checkpoint("life", FakeComm(0, 1), env=env)
            cp.add("arr", data.copy())
            cp.add("t", box)
            cp.commit()
            cp.update_and_write()
            cp.close()
            assert cp.scrubber.scan_once()["corrupt_found"] == 0
            refs = [weakref.ref(cp), weakref.ref(box.value)]
            del cp, box
            assert [r() for r in refs] == [None, None]
        finally:
            gc.enable()
