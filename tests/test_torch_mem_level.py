"""The port's memory tier (MemStore): replicated RAM shards, failure
injection, budget — the reference's ``test_mem_level.py`` run against
``repro_torch`` on the CPU, plus a bf16 state served from RAM.

The scenarios mirror the node-tier tests one level up the latency hierarchy:
roundtrip through RAM, restore after a rank's RAM is lost (replica path,
digest-verified), replica insufficiency falling back to the disk tiers, the
collective budget refusal, and the AFT shrink-recovery path that restores
from peer memory with the disk tiers entirely absent.
"""
import shutil

import numpy as np
import pytest

import torch

from repro_torch.core import Box, CheckpointError, MemFabric, aft_zone
from repro_torch.core import Checkpoint as _Checkpoint
from repro_torch.core.comm_sim import SimWorld
from repro_torch.core.env import CraftEnv
from repro_torch.core.mem_level import MemStore, MemTierError


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
