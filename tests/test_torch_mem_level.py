"""The port's memory tier (MemStore): replicated RAM shards, failure
injection, budget — the reference's ``test_mem_level.py`` run against
``repro_torch`` on the CPU, plus a bf16 state served from RAM.

The scenarios mirror the node-tier tests one level up the latency hierarchy:
roundtrip through RAM, restore after a rank's RAM is lost (replica path,
digest-verified), replica insufficiency falling back to the disk tiers, the
collective budget refusal, and the AFT shrink-recovery path that restores
from peer memory with the disk tiers entirely absent.
"""
import builtins
import collections
import gc
import os
import shutil

import numpy as np
import pytest

import torch

from repro_torch.core import Box, CheckpointError, MemFabric, aft_zone
from repro_torch.core import Checkpoint as _Checkpoint
from repro_torch.core import CpBase, IOContext
from repro_torch.core import mem_level, metrics, storage
from repro_torch.core.checkpointables import ShardCp
from repro_torch.core.comm_sim import SimWorld
from repro_torch.core.env import CraftEnv
from repro_torch.core.mem_level import MemStore, MemTierError
from repro_torch.kernels.checksum import ops as checksum_ops


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


class FakeComm:
    """Single-process stand-in: rank r of n, one rank per node."""

    def __init__(self, rank, size):
        self._rank, self._size = rank, size

    @property
    def rank(self):
        return self._rank

    @property
    def size(self):
        return self._size

    def node_id(self):
        return self._rank

    def procs_per_node(self):
        return 1

    def barrier(self, channel="main"):
        pass

    def allreduce(self, v, op="sum", channel="main"):
        return v

    def allreduce_min(self, v):
        return v

    def bcast(self, v, root=0, channel="main"):
        return v


def _env(tmp_path, **extra):
    base = {
        "CRAFT_CP_PATH": str(tmp_path / "pfs"),
        "CRAFT_NODE_CP_PATH": str(tmp_path / "node"),
        "CRAFT_NODE_REDUNDANCY": "LOCAL",
        "CRAFT_TIER_CHAIN": "mem,node,pfs",
        "CRAFT_MEM_SCRATCH": str(tmp_path / "shm"),
        "CRAFT_MEM_REPLICAS": "1",
    }
    base.update(extra)
    return CraftEnv.capture(base)


def _write_all_ranks(tmp_path, n, value_of, **extra):
    env = _env(tmp_path, **extra)
    for rank in range(n):
        cp = Checkpoint("mt", FakeComm(rank, n), env=env)
        cp.add("arr", np.full((32,), value_of(rank)))
        cp.add("it", Box(7))
        cp.commit()
        cp.update_and_write()
        cp.close()
    return env


def _read_rank(tmp_path, rank, n, env):
    arr = np.zeros((32,))
    it = Box(0)
    cp = Checkpoint("mt", FakeComm(rank, n), env=env)
    cp.add("arr", arr)
    cp.add("it", it)
    cp.commit()
    assert cp.restart_if_needed()
    cp.close()
    return arr, it.value, cp.stats["restore_tier"]


class TestRoundtrip:
    def test_restores_from_ram_with_disk_gone(self, tmp_path):
        env = _write_all_ranks(tmp_path, 4, lambda r: float(r + 1))
        # wipe BOTH disk tiers: the only remaining copy is in process RAM
        shutil.rmtree(tmp_path / "pfs")
        shutil.rmtree(tmp_path / "node")
        for rank in range(4):
            arr, it, tier = _read_rank(tmp_path, rank, 4, env)
            assert tier == "mem"
            assert np.all(arr == rank + 1)
            assert it == 7

    def test_keep_versions_retires_old_ram_versions(self, tmp_path):
        env = _env(tmp_path, CRAFT_KEEP_VERSIONS="2")
        b = Box(0)
        cp = Checkpoint("mt", FakeComm(0, 1), env=env)
        cp.add("x", b)
        cp.commit()
        for i in range(1, 5):
            b.value = i
            cp.update_and_write()
        cp.close()
        fabric = MemFabric.instance()
        assert sorted(fabric.versions("mt")) == [3, 4]

    def test_restored_pytree_leaf_is_writable(self, tmp_path):
        """Array-cache hits are read-only views; leaves handed back to the
        application must be owned, writable copies."""
        env = _env(tmp_path)
        state = Box(np.arange(8.0))
        cp = Checkpoint("mt", FakeComm(0, 1), env=env)
        cp.add("state", state)
        cp.commit()
        cp.update_and_write()
        cp.close()
        fresh = Box(np.zeros(8))
        cp2 = Checkpoint("mt", FakeComm(0, 1), env=env)
        cp2.add("state", fresh)
        cp2.commit()
        assert cp2.restart_if_needed()
        assert cp2.stats["restore_tier"] == "mem"
        fresh.value[0] = 99.0            # must not raise / corrupt the fabric
        cp2.close()
        again = Box(np.zeros(8))
        cp3 = Checkpoint("mt", FakeComm(0, 1), env=env)
        cp3.add("state", again)
        cp3.commit()
        assert cp3.restart_if_needed()
        assert again.value[0] == 0.0     # fabric copy untouched by the write
        cp3.close()


class TestReplicaRecovery:
    def test_dead_ranks_ram_served_by_replica(self, tmp_path):
        env = _write_all_ranks(tmp_path, 4, lambda r: float(10 * (r + 1)))
        shutil.rmtree(tmp_path / "pfs")
        shutil.rmtree(tmp_path / "node")
        # rank 2 fail-stops: its shards and held replicas vanish
        MemFabric.instance().drop_rank(2)
        # every survivor (and rank 2's blank replacement) still restores the
        # full state — rank 2's shards come from rank 3's replica slot
        for rank in range(4):
            arr, it, tier = _read_rank(tmp_path, rank, 4, env)
            assert tier == "mem"
            assert np.all(arr == 10 * (rank + 1))

    def test_replica_digest_mismatch_rejected(self, tmp_path):
        env = _write_all_ranks(tmp_path, 2, lambda r: float(r))
        shutil.rmtree(tmp_path / "pfs")
        shutil.rmtree(tmp_path / "node")
        fabric = MemFabric.instance()
        fabric.drop_rank(0)
        # corrupt rank 0's replica (held in rank 1's slot) behind the digest
        mv = fabric.lookup("mt", 0, 1)[0]
        entry = next(e for e in mv.files.values() if e.array is not None)
        tampered = entry.array.copy()
        tampered[0] += 1.0
        entry.array = tampered
        cp = Checkpoint("mt", FakeComm(0, 2), env=env)
        cp.add("arr", np.zeros((32,)))
        cp.add("it", Box(0))
        cp.commit()
        with pytest.raises(CheckpointError, match="digest mismatch"):
            cp.restart_if_needed()
        cp.close()

    def test_insufficient_replicas_fall_back_to_disk(self, tmp_path):
        # R=1: losing two adjacent ranks makes rank 1's shards unreachable
        env = _write_all_ranks(tmp_path, 4, lambda r: float(r + 5))
        fabric = MemFabric.instance()
        fabric.drop_rank(1)
        fabric.drop_rank(2)   # held rank 1's only replica
        arr, it, tier = _read_rank(tmp_path, 0, 4, env)
        assert tier == "node"          # next tier in the chain
        assert np.all(arr == 5.0)
        assert it == 7


class TestBudget:
    def test_budget_exceeded_falls_back_to_node_tier(self, tmp_path):
        env = _write_all_ranks(
            tmp_path, 2, lambda r: float(r), CRAFT_MEM_BUDGET_BYTES="64"
        )
        assert MemFabric.instance().versions("mt") == {}
        arr, it, tier = _read_rank(tmp_path, 0, 2, env)
        assert tier == "node"
        assert np.all(arr == 0.0)

    def test_budget_skip_counts_and_disk_still_written(self, tmp_path):
        env = _env(tmp_path, CRAFT_MEM_BUDGET_BYTES="64")
        cp = Checkpoint("mt", FakeComm(0, 1), env=env)
        cp.add("arr", np.zeros((64,)))
        cp.commit()
        cp.update_and_write()
        cp.close()
        assert cp.stats["mem_skipped"] == 1
        assert cp.stats["mem_writes"] == 0
        assert cp.stats["node_writes"] == 1
        assert cp.stats["pfs_writes"] == 1

    def test_budget_admits_within_cap(self, tmp_path):
        env = _env(tmp_path, CRAFT_MEM_BUDGET_BYTES=str(1 << 20))
        cp = Checkpoint("mt", FakeComm(0, 1), env=env)
        cp.add("arr", np.zeros((64,)))
        cp.commit()
        cp.update_and_write()
        cp.close()
        assert cp.stats["mem_writes"] == 1
        assert cp.stats["mem_skipped"] == 0


class TestEnvKnobs:
    def test_tier_chain_validation(self):
        with pytest.raises(ValueError):
            CraftEnv.capture({"CRAFT_TIER_CHAIN": "mem,disk"})
        with pytest.raises(ValueError):
            CraftEnv.capture({"CRAFT_TIER_CHAIN": "mem,mem"})
        with pytest.raises(ValueError):
            CraftEnv.capture({"CRAFT_TIER_CHAIN": ""})
        assert CraftEnv.capture({}).tier_chain == ("node", "pfs")
        assert CraftEnv.capture(
            {"CRAFT_TIER_CHAIN": "mem,node,pfs"}
        ).tier_chain == ("mem", "node", "pfs")

    def test_mem_knob_validation(self):
        with pytest.raises(ValueError):
            CraftEnv.capture({"CRAFT_MEM_REPLICAS": "-1"})
        with pytest.raises(ValueError):
            CraftEnv.capture({"CRAFT_MEM_BUDGET_BYTES": "-5"})
        env = CraftEnv.capture({})
        assert env.mem_replicas == 1
        assert env.mem_budget_bytes == 0

    def test_replicas_clamped_to_world(self, tmp_path):
        env = _env(tmp_path, CRAFT_MEM_REPLICAS="9")
        store = MemStore("clamp", FakeComm(0, 3), env)
        assert store.replicas == 2
        assert store._holders(0) == [0, 1, 2]


class TestAftShrinkRecovery:
    """Satellite: kill a rank in comm_sim; survivors restore the full state
    from peer replicas without reading any on-disk version (no disk tiers
    are configured at all), then finish the computation."""

    def test_survivors_restore_from_peer_memory_zero_disk(self, tmp_path):
        env = CraftEnv.capture({
            "CRAFT_TIER_CHAIN": "mem",           # no disk tier exists
            "CRAFT_MEM_REPLICAS": "1",
            "CRAFT_MEM_SCRATCH": str(tmp_path / "shm"),
            "CRAFT_COMM_RECOVERY_POLICY": "SHRINKING",
            "CRAFT_IO_WORKERS": "1",
        })
        world = SimWorld(4, env=env)

        def fn(c):
            def body(comm):
                it = Box(0)
                state = Box(np.zeros(8))
                cp = Checkpoint("aftmem", comm, env=env)
                cp.add("it", it)
                cp.add("state", state)
                cp.commit()
                restored = cp.restart_if_needed()
                while it.value < 6:
                    it.value += 1
                    state.value = state.value + 1.0
                    cp.update_and_write()
                    if it.value == 3 and comm.epoch == 0 and comm.rank == 0:
                        world.kill(3)
                cp.close()
                return (restored, cp.stats["restore_tier"], it.value,
                        float(np.sum(state.value)), comm.size)

            return aft_zone(c, body, env=env)

        out = world.run(fn, timeout=120)
        assert len(out) == 3                      # the killed rank is gone
        for restored, tier, it, total, size in out.values():
            assert restored and tier == "mem"
            assert (it, total, size) == (6, 48.0, 3)
        # nothing was ever staged to a disk tier
        assert not (tmp_path / "pfs").exists()
        assert not (tmp_path / "node").exists()

    def test_killed_ranks_fabric_slot_dropped(self, tmp_path):
        env = CraftEnv.capture({
            "CRAFT_TIER_CHAIN": "mem",
            "CRAFT_MEM_REPLICAS": "0",   # no replicas: kill leaves nothing
            "CRAFT_MEM_SCRATCH": str(tmp_path / "shm"),
            "CRAFT_IO_WORKERS": "1",
        })
        world = SimWorld(2, env=env)
        fabric = MemFabric.instance()

        def fn(c):
            cp = Checkpoint("hook", c, env=env)
            cp.add("x", Box(c.rank))
            cp.commit()
            cp.update_and_write()
            cp.close()
            c.barrier()
            if c.rank == 0:
                world.kill(1)
                return fabric.lookup("hook", 1, 1)[0] is None
            try:
                while True:
                    c.barrier()
            except Exception:
                return "peer failure seen"

        out = world.run(fn, timeout=60)
        assert out.get("u0") is True


class TestPortTensors:
    def test_bf16_state_served_from_ram(self, tmp_path):
        """bf16 tensors sit in the fabric as uint16 views beside their
        dtype name; a RAM restore hands back bf16, bit for bit, and the
        restored tensors never alias the fabric's copy."""
        env = _env(tmp_path)
        g = torch.Generator().manual_seed(3)
        state = {"w": torch.randn((33, 7), generator=g).to(torch.bfloat16),
                 "b": torch.arange(5, dtype=torch.int64)}
        cp = Checkpoint("bf", FakeComm(0, 1), env=env)
        cp.add("state", Box(state))
        cp.commit()
        cp.update_and_write()
        cp.close()
        shutil.rmtree(tmp_path / "pfs", ignore_errors=True)
        shutil.rmtree(tmp_path / "node")
        for _ in range(2):
            # a float32 live tensor takes the new-tensor path (stored dtype)
            box = Box({"w": torch.zeros((33, 7)),
                       "b": torch.zeros(5, dtype=torch.int64)})
            cp2 = Checkpoint("bf", FakeComm(0, 1), env=env)
            cp2.add("state", box)
            cp2.commit()
            assert cp2.restart_if_needed()
            assert cp2.stats["restore_tier"] == "mem"
            cp2.close()
            assert box.value["w"].dtype == torch.bfloat16
            assert torch.equal(box.value["w"], state["w"])
            assert torch.equal(box.value["b"], state["b"])
            box.value["w"].fill_(7)         # must not reach the fabric

    def test_uint16_array_served_from_ram_keeps_its_bits(self, tmp_path):
        env = _env(tmp_path)
        src = np.arange(40, dtype=np.uint16) * 1000
        cp = Checkpoint("u16", FakeComm(0, 1), env=env)
        cp.add("arr", src.copy())
        cp.commit()
        cp.update_and_write()
        cp.close()
        shutil.rmtree(tmp_path / "node")
        out = np.zeros_like(src)
        cp2 = Checkpoint("u16", FakeComm(0, 1), env=env)
        cp2.add("arr", out)
        cp2.commit()
        assert cp2.restart_if_needed()
        assert cp2.stats["restore_tier"] == "mem"
        cp2.close()
        assert np.array_equal(out, src)


class TestPageLock:
    """Resident payloads page-locked in place on a card's store: the
    registration hooks stubbed, so the CPU runs each way in and out."""

    @pytest.fixture()
    def hooks(self, monkeypatch):
        calls = {"register": [], "unregister": []}

        def register(ptr, nbytes):
            calls["register"].append((ptr, nbytes))
            return calls.get("refuse") is None

        monkeypatch.setattr(mem_level, "_host_register", register)
        monkeypatch.setattr(mem_level, "_host_unregister",
                            calls["unregister"].append)
        metrics.install()
        yield calls
        MemFabric.instance().reset()    # released into this test's stubs
        gc.collect()
        metrics.uninstall()

    @staticmethod
    def _card(monkeypatch):
        """Take the card's branch (the store still digests on the CPU)."""
        monkeypatch.setattr(mem_level, "_page_lockable", lambda device: True)

    @staticmethod
    def _publish(tmp_path, versions=(1,), **extra):
        env = _env(tmp_path, CRAFT_TIER_CHAIN="mem", **extra)
        state = {"w": torch.arange(4096, dtype=torch.float32),
                 "b": torch.ones(7, dtype=torch.bfloat16)}
        cp = Checkpoint("pl", FakeComm(0, 1), env=env)
        cp.add("state", Box(state))
        cp.add("it", Box(0))
        cp.commit()
        for v in versions:
            cp.update_and_write(v)
        cp.close()
        return env, state

    @staticmethod
    def _arrays(version=None):
        return [e for _, v, _, e in MemFabric.instance().entries("pl")
                if e.array is not None and version in (None, v)]

    @staticmethod
    def _gauge(name):
        return metrics.snapshot()["gauges"].get(name, 0.0)

    def test_cpu_store_keeps_pageable_arrays(self, tmp_path, hooks):
        self._publish(tmp_path)
        arrays = self._arrays()
        assert arrays and not any(e.pinned for e in arrays)
        assert all(type(e.array) is np.ndarray for e in arrays)
        assert hooks["register"] == []
        assert self._gauge("mem_pinned_bytes") == 0.0

    @pytest.mark.parametrize("way", ["prune", "drop_version",
                                     "replace_entry", "wipe", "reset",
                                     "drop_rank", "forget_version"])
    def test_every_way_out_releases_each_payload_once(
            self, tmp_path, monkeypatch, hooks, way):
        self._card(monkeypatch)
        env, _ = self._publish(tmp_path, versions=(1, 2),
                               CRAFT_KEEP_VERSIONS="1" if way == "prune"
                               else "2")
        fabric = MemFabric.instance()
        if way == "prune":          # v-1 left when v-2 was published
            leaving = hooks["register"][:len(hooks["register"]) // 2]
        else:
            leaving = [(e.array.ctypes.data, e.nbytes)
                       for e in self._arrays(version=1)]
            assert len(leaving) == 2 and all(
                e.pinned for e in self._arrays())
            if way == "drop_version":
                fabric.drop_version("pl", 1)
            elif way == "replace_entry":
                rel = next(r for _, v, r, e in fabric.entries("pl")
                           if v == 1 and e.array is not None)
                old = fabric.lookup("pl", 0, 1)[0].files[rel]
                leaving = [(old.array.ctypes.data, old.nbytes)]
                del old
                fabric.corrupt_entry("pl", 0, 1, rel=rel)
                # the rotted copy takes the place's page lock
                assert fabric.lookup("pl", 0, 1)[0].files[rel].pinned
            elif way == "wipe":
                fabric.wipe("pl")
            elif way == "reset":
                fabric.reset()
            elif way == "drop_rank":
                fabric.drop_rank(0)
            else:
                MemStore("pl", FakeComm(0, 1), env).forget_version(1)
        gc.collect()
        if way in ("wipe", "reset", "drop_rank"):    # v-2 left as well
            leaving = hooks["register"][len(hooks["register"]) // 2:] \
                + leaving
        released = collections.Counter(hooks["unregister"])
        assert released == collections.Counter(p for p, _ in leaving)
        held = {p: n for p, n in hooks["register"] if p not in released}
        assert self._gauge("mem_pinned_bytes") == float(sum(held.values()))
        fabric.reset()
        gc.collect()
        assert self._gauge("mem_pinned_bytes") == 0.0
        assert sorted(hooks["unregister"]) == sorted(
            p for p, _ in hooks["register"])

    def test_entries_sharing_memory_lock_it_once(self, hooks):
        owner = np.arange(1024, dtype=np.float32)
        held = (owner.ctypes.data, owner.nbytes)
        entries = [mem_level._MemEntry(owner.reshape(32, 32), None, (0, 0)),
                   mem_level._MemEntry(owner[:], None, (0, 0))]
        del owner
        for entry in entries:
            entry.lock_pages()
        assert [entry.pinned for entry in entries] == [True, True]
        assert hooks["register"] == [held]
        del entry, entries[0]
        gc.collect()
        assert hooks["unregister"] == []      # a view still holds it
        entries.clear()
        gc.collect()
        assert len(hooks["unregister"]) == 1
        assert self._gauge("mem_pinned_bytes") == 0.0

    def test_a_refused_lock_keeps_the_payload_pageable(
            self, tmp_path, monkeypatch, hooks):
        self._card(monkeypatch)
        hooks["refuse"] = True
        env, state = self._publish(tmp_path)
        arrays = self._arrays()
        assert len(hooks["register"]) == len(arrays) == 2
        assert not any(e.pinned for e in arrays)
        assert metrics.snapshot()["counters"]["mem_pin_failures"] == 2.0
        assert self._gauge("mem_pinned_bytes") == 0.0
        live = {"w": torch.zeros(4096), "b": torch.zeros(7, dtype=torch.bfloat16)}
        cp = Checkpoint("pl", FakeComm(0, 1), env=env)
        cp.add("state", Box(live))
        cp.add("it", Box(0))
        cp.commit()
        assert cp.restart_if_needed()
        assert cp.stats["restore_tier"] == "mem"
        cp.close()
        assert torch.equal(live["w"], state["w"])
        assert torch.equal(live["b"], state["b"])
        assert hooks["unregister"] == []


class RawFileCp(CpBase):
    """Breaks the I/O contract: opens its file under ``dir_path`` itself
    instead of going through ``storage`` with its ``ctx``."""

    def __init__(self, arr):
        self.arr = arr

    def update(self):
        pass

    def write(self, dir_path, ctx):
        with open(dir_path / "raw.bin", "wb") as fh:
            fh.write(self.arr.tobytes())

    def read(self, dir_path, ctx):
        with open(dir_path / "raw.bin", "rb") as fh:
            self.arr[...] = np.frombuffer(fh.read(), self.arr.dtype)


class TestFileTable:
    """A version held in memory end to end: the checkpointables write into
    an in-memory file table, the publish makes the resident entries from
    it, and a restore reads them back — no file on the way."""

    @staticmethod
    def _items():
        g = torch.Generator().manual_seed(5)
        return {
            "it": Box(11),
            "arr": np.linspace(0.0, 1.0, 24),
            "w": Box(torch.randn((9, 5), generator=g).to(torch.bfloat16)),
            "tree": Box({"a": torch.arange(6, dtype=torch.int32),
                         "n": np.arange(4.0), "p": 2.5}),
            "blk": ShardCp(Box(np.arange(12.0).reshape(3, 4)), (6, 4),
                           [[0, 3], [0, 4]]),
        }

    @pytest.fixture()
    def file_ops(self, monkeypatch):
        """Records every file or directory opened, made, listed, renamed
        or deleted while ``rec["on"]``."""
        rec = {"on": False, "ops": []}

        def spy(name, fn):
            def wrapper(*args, **kwargs):
                if rec["on"]:
                    rec["ops"].append((name, args[:1]))
                return fn(*args, **kwargs)
            return wrapper

        for mod, name in [(builtins, "open"), (os, "open"), (os, "mkdir"),
                          (os, "replace"), (os, "rename"), (os, "unlink"),
                          (os, "rmdir"), (os, "scandir"), (os, "listdir")]:
            monkeypatch.setattr(mod, name, spy(name, getattr(mod, name)))
        return rec

    @pytest.mark.parametrize("workers", ["1", "4"])
    def test_write_and_restore_touch_no_file(self, tmp_path, file_ops,
                                             workers):
        env = _env(tmp_path, CRAFT_TIER_CHAIN="mem",
                   CRAFT_IO_WORKERS=workers)
        items = self._items()
        cp = Checkpoint("ft", FakeComm(0, 1), env=env)
        for key, obj in items.items():
            cp.add(key, obj)
        cp.commit()
        file_ops["on"] = True
        assert cp.update_and_write()
        file_ops["on"] = False
        cp.close()
        assert cp.stats["mem_writes"] == 1

        live = {
            "it": Box(0), "arr": np.zeros(24),
            "w": Box(torch.zeros((9, 5), dtype=torch.bfloat16)),
            "tree": Box({"a": torch.zeros(6, dtype=torch.int32),
                         "n": np.zeros(4), "p": 0.0}),
            "blk": ShardCp(Box(np.zeros((3, 4))), (6, 4), [[0, 3], [0, 4]]),
        }
        cp2 = Checkpoint("ft", FakeComm(0, 1), env=env)
        for key, obj in live.items():
            cp2.add(key, obj)
        cp2.commit()
        file_ops["on"] = True
        assert cp2.restart_if_needed()
        file_ops["on"] = False
        cp2.close()
        assert cp2.stats["restore_tier"] == "mem"
        assert file_ops["ops"] == []
        scratch = tmp_path / "shm"
        assert not scratch.exists() or not any(scratch.iterdir())
        assert not any(tmp_path.rglob("*"))
        assert live["it"].value == 11
        assert np.array_equal(live["arr"], items["arr"])
        assert torch.equal(live["w"].value, items["w"].value)
        assert torch.equal(live["tree"].value["a"],
                           items["tree"].value["a"])
        assert np.array_equal(live["tree"].value["n"], np.arange(4.0))
        assert live["tree"].value["p"] == 2.5
        assert np.array_equal(live["blk"].box.value,
                              np.arange(12.0).reshape(3, 4))

    @pytest.mark.parametrize("kind", ["float32", "bfloat16", "uint16",
                                      "pytree", "shard"])
    def test_resident_entries_equal_the_node_tiers_files(self, tmp_path,
                                                         kind):
        if kind == "pytree":
            obj = Box({"n": np.arange(5, dtype=np.int16), "p": 3, "s": "x",
                       "t": torch.ones(3)})
        elif kind == "shard":
            obj = ShardCp(Box(np.arange(8.0).reshape(2, 4)), (4, 4),
                          [[2, 4], [0, 4]])
        else:
            obj = Box((torch.arange(40).reshape(8, 5) * 37 % 1000)
                      .to(getattr(torch, kind)))
        env = _env(tmp_path, CRAFT_TIER_CHAIN="mem,node")
        cp = Checkpoint("eq", FakeComm(0, 1), env=env)
        cp.add("x", obj)
        cp.add("it", Box(4))
        cp.commit()
        cp.update_and_write()
        cp.close()
        vdir = cp._node.version_dir(1)
        on_disk = {str(p.relative_to(vdir)) for p in vdir.rglob("*")
                   if p.is_file()}
        resident = {rel: e for _, v, rel, e in
                    MemFabric.instance().entries("eq") if v == 1}
        assert set(resident) == on_disk
        ctx = IOContext(checksum="fletcher", device="cpu")
        n_arrays = 0
        for rel, entry in resident.items():
            path = vdir / rel
            if entry.array is None:
                assert entry.blob == path.read_bytes()
            else:
                n_arrays += 1
                decoded = storage.read_array(path, ctx)
                assert entry.dtype == storage.read_dtype_name(path)
                assert entry.array.dtype == decoded.dtype
                assert entry.array.shape == decoded.shape
                assert entry.array.tobytes() == decoded.tobytes()
            assert tuple(entry.digest) == tuple(
                checksum_ops.digest_bytes(entry.payload, "cpu"))
        assert n_arrays == (2 if kind == "pytree" else 1)

    @pytest.mark.parametrize("kind", ["tensor", "pytree", "ndarray"])
    def test_a_later_update_leaves_the_resident_version(self, tmp_path,
                                                        kind):
        """The host buffer a checkpointable writes from is refilled in
        place by its next ``update()`` (a device snapshot's one host
        mirror, an array's buffer): the resident copy must not alias it."""
        env = _env(tmp_path, CRAFT_TIER_CHAIN="mem",
                   CRAFT_DEVICE_SNAPSHOT="1", CRAFT_KEEP_VERSIONS="2")
        t = torch.arange(64, dtype=torch.float32)
        arr = np.arange(64.0)
        obj = {"tensor": Box(t), "pytree": Box({"t": t}),
               "ndarray": arr}[kind]
        cp = Checkpoint("al", FakeComm(0, 1), env=env)
        cp.add("x", obj)
        cp.commit()
        snap = getattr(cp._map["x"], "_snap", None)
        if snap is not None:      # a card's path: one mirror, refilled
            snap.staged = True
            snap.reset()
        cp.update_and_write()
        before = {rel: e.payload.tobytes() if e.array is not None
                  else e.blob
                  for _, v, rel, e in MemFabric.instance().entries("al")
                  if v == 1}
        t.add_(1.0)
        arr += 1.0
        cp.update_and_write()
        cp.close()
        after = {rel: e for _, v, rel, e in
                 MemFabric.instance().entries("al") if v == 1}
        assert set(after) == set(before)
        for rel, entry in after.items():
            assert (entry.payload.tobytes() if entry.array is not None
                    else entry.blob) == before[rel]
            assert entry.verify("cpu")

    @pytest.mark.parametrize("chain", ["mem", "mem,node,pfs"])
    def test_a_checkpointable_opening_files_fails_by_name(self, tmp_path,
                                                         chain):
        env = _env(tmp_path, CRAFT_TIER_CHAIN=chain)
        arr = np.arange(16.0)
        cp = Checkpoint("raw", FakeComm(0, 1), env=env)
        cp.add("raw", RawFileCp(arr))
        cp.commit()
        if chain == "mem":
            with pytest.raises(CheckpointError,
                               match="RawFileCp opened .* itself.*through "
                                     "storage"):
                cp.update_and_write()
            cp.close()
            assert cp.stats["mem_writes"] == 0
            return
        assert cp.update_and_write()
        cp.close()
        assert cp.stats["mem_writes"] == 0
        assert cp.stats["node_writes"] == 1
        assert cp.stats["degraded_writes"] == 1
        out = np.zeros(16)
        cp2 = Checkpoint("raw", FakeComm(0, 1), env=env)
        cp2.add("raw", RawFileCp(out))
        cp2.commit()
        assert cp2.restart_if_needed()
        cp2.close()
        assert cp2.stats["restore_tier"] == "node"
        assert np.array_equal(out, arr)
