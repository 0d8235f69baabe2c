"""The port's ULFM-semantics communicator (simulator backend) and AFT zones
(paper §3) — the reference's ``test_comm_aft.py`` run against
``repro_torch`` on the CPU — and one AFT kill/respawn run over the
mem,node chain with RS redundancy, in both packages, that must end in the
same state as the run without failures.
"""
import shutil
import threading
import time

import numpy as np
import pytest
import torch

import repro.core as R
from repro.core.comm_sim import SimWorld as RefSimWorld

from repro_torch.core import Box, ShardCp
from repro_torch.core import Checkpoint as _Checkpoint
from repro_torch.core.aft import AftAbortedError, aft_zone
from repro_torch.core.comm import ProcFailedError, RevokedError
from repro_torch.core.comm_sim import SimComm, SimWorld
from repro_torch.core.elastic import block_index
from repro_torch.core.env import CraftEnv
from repro_torch.core.mem_level import MemFabric


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


def _env(**kw):
    base = {"CRAFT_COMM_RECOVERY_POLICY": "NON-SHRINKING"}
    base.update(kw)
    return CraftEnv.capture(base)


class TestCollectives:
    def test_allreduce_sum(self):
        world = SimWorld(4, env=_env())
        out = world.run(lambda c: c.allreduce(c.rank + 1, op="sum"))
        assert set(out.values()) == {10}

    def test_allreduce_min_max(self):
        world = SimWorld(3, env=_env())
        out = world.run(lambda c: (c.allreduce(c.rank, "min"),
                                   c.allreduce(c.rank, "max")))
        assert set(out.values()) == {(0, 2)}

    def test_bcast(self):
        world = SimWorld(4, env=_env())
        out = world.run(lambda c: c.bcast(c.rank * 11, root=2))
        assert set(out.values()) == {22}

    def test_channels_are_independent(self):
        """Two channels used in different per-rank order must not deadlock
        (the checkpoint writer thread's barrier runs on its own channel)."""
        world = SimWorld(2, env=_env())

        def fn(c):
            results = {}

            def writer():
                results["w"] = c.allreduce(1, channel="cp:writer")

            t = threading.Thread(target=writer)
            t.start()
            results["m"] = c.allreduce(2, channel="main")
            t.join(timeout=10)
            return (results["m"], results["w"])

        out = world.run(fn)
        assert set(out.values()) == {(4, 2)}


class TestFailureDetection:
    def test_dead_rank_breaks_collective(self):
        world = SimWorld(3, env=_env())

        def fn(c):
            if c.rank == 0:
                world.kill(1)
            # rank 1 dies at its next comm call; others see ProcFailedError
            try:
                for _ in range(50):
                    c.barrier()
                    time.sleep(0.005)
                return "no failure seen"
            except ProcFailedError:
                return "detected"

        out = world.run(fn)
        assert set(out.values()) == {"detected"}

    def test_revoke_poisons_everyone(self):
        world = SimWorld(4, env=_env())

        def fn(c):
            if c.rank == 2:
                c.revoke()
                return "revoker"
            try:
                while True:
                    c.barrier()
            except (RevokedError, ProcFailedError):
                return "revoked"

        out = world.run(fn)
        assert sorted(out.values()) == ["revoked"] * 3 + ["revoker"]

    def test_agree_works_among_survivors(self):
        world = SimWorld(3, env=_env())

        def fn(c):
            if c.rank == 0:
                world.kill(2)
                time.sleep(0.02)
            try:
                c.barrier()
            except ProcFailedError:
                pass
            return c.agree(True)

        out = world.run(fn)
        assert all(out.values())


class TestRecovery:
    @staticmethod
    def _resilient_loop(world, policy, iters=20):
        """Every member (survivor or replacement) runs the same loop: do
        ``iters`` barriers on the current epoch, recovering on failure and
        RESTARTING the loop — so collective sequences match per epoch."""

        def fn(c):
            recovered = False
            while True:
                try:
                    if c.rank == 0 and c.epoch == 0:
                        world.kill(world.n_procs - 1)
                    for _ in range(iters):
                        c.barrier()
                        time.sleep(0.002)
                    return ("recovered" if recovered else "fresh", c.size,
                            c.last_recovery_stats())
                except (ProcFailedError, RevokedError):
                    try:
                        c.revoke()
                    except Exception:
                        pass
                    c = c.recover(policy=policy)
                    recovered = True

        return fn

    @pytest.mark.parametrize("policy", ["SHRINKING", "NON-SHRINKING"])
    def test_recover_after_kill(self, policy):
        world = SimWorld(4, procs_per_node=2, spare_nodes=1,
                         env=_env(CRAFT_COMM_RECOVERY_POLICY=policy))
        out = world.run(self._resilient_loop(world, policy), timeout=120)
        want = 3 if policy == "SHRINKING" else 4
        assert {v[1] for v in out.values()} == {want}
        assert any(v[0] == "recovered" for v in out.values())

    def test_recovery_stats_phases(self):
        """Paper Table 3's five phases are all reported."""
        world = SimWorld(4, spare_nodes=1, env=_env())
        out = world.run(self._resilient_loop(world, "NON-SHRINKING"),
                        timeout=120)
        stats = next(v[2] for v in out.values() if v[0] == "recovered")
        for phase in ("revoke_shrink_s", "spawn_info_s", "spawn_merge_s",
                      "redistribute_s", "resource_mgmt_s"):
            assert phase in stats, stats
        assert stats.get("failed") == [3]


class TestAftZone:
    def test_body_reruns_until_success(self):
        world = SimWorld(3, spare_nodes=1, env=_env())
        attempts = {}

        def body_factory(world):
            def fn(c):
                def body(comm):
                    attempts.setdefault(comm.rank, 0)
                    attempts[comm.rank] += 1
                    if comm.epoch == 0 and comm.rank == 0 \
                            and attempts[0] == 1:
                        world.kill(1)
                    for _ in range(30):
                        comm.barrier()
                        time.sleep(0.002)
                    return ("done", comm.size)

                return aft_zone(c, body, env=_env())
            return fn

        out = world.run(body_factory(world), timeout=120)
        assert all(v == ("done", 3) for v in out.values())
        # at least one member retried
        assert max(attempts.values()) >= 2

    def test_zone_gives_up_after_max_recoveries(self):
        world = SimWorld(2, env=_env())

        def fn(c):
            def body(comm):
                raise ProcFailedError("synthetic", failed=[0])

            try:
                aft_zone(c, body, max_recoveries=2, env=_env(
                    CRAFT_COMM_RECOVERY_POLICY="SHRINKING"))
            except (AftAbortedError, ProcFailedError, RevokedError):
                return "aborted"
            return "unexpected"

        out = world.run(fn, timeout=60)
        assert "aborted" in set(out.values())

    def test_nonshrinking_replacement_hydrates_from_peer_memory(self, tmp_path):
        """Kill k ranks mid-epoch under NON-SHRINKING: the spawned
        replacements restore their shard from surviving peers' RAM-fabric
        replicas — restore tier "mem", ZERO pfs reads, zero physical read
        bytes — and the fabric is re-protected (replica slots reseeded)."""
        src = (np.arange(13 * 5, dtype=np.float32).reshape(13, 5) + 1.5)
        env = _env(
            CRAFT_CP_PATH=str(tmp_path / "pfs"),
            CRAFT_TIER_CHAIN="mem,pfs",
            CRAFT_MEM_REPLICAS="2",
            CRAFT_MEM_SCRATCH=str(tmp_path / "shm"),
            CRAFT_USE_SCR="0",
            CRAFT_IO_WORKERS="1",
        )
        world = SimWorld(4, spare_nodes=2, env=env)
        restores = {}   # (rank, epoch, is_replacement) -> restore telemetry
        reseeds = []    # mem_reseeded from each member's recovery stats

        def body(comm):
            cp = Checkpoint("state", comm, env=env)
            it = Box(0)
            idx = block_index(src.shape, comm.rank, comm.size)
            wbox = Box(np.zeros_like(src[idx]))
            cp.add("it", it)
            cp.add("w", ShardCp(wbox, src.shape, idx))
            cp.commit()
            if cp.restart_if_needed():
                restores[(comm.rank, comm.epoch, comm.is_replacement())] = {
                    "tier": cp.stats["restore_tier"],
                    "pfs_reads": cp.stats["tier_reads"].get("pfs", 0),
                    "read_bytes": cp.stats["restore_read_bytes"],
                    "block_ok": np.array_equal(wbox.value, src[idx]),
                    "it": it.value,
                }
            while it.value < 5:
                it.value += 1
                np.copyto(wbox.value, src[idx])
                cp.update_and_write()
                if comm.rank == 0 and comm.epoch == 0 and it.value == 2:
                    world.kill(2)
                    world.kill(3)
                comm.barrier()
                time.sleep(0.002)
            cp.close()
            return ("done", comm.size)

        def fn(c):
            return aft_zone(
                c, body, env=env,
                on_recovery=lambda comm, stats: reseeds.append(
                    stats.get("mem_reseeded", 0)))

        out = world.run(fn, timeout=180)
        assert all(v == ("done", 4) for v in out.values())
        # the spawned replacements hydrated purely from peer memory
        repl = {k: v for k, v in restores.items() if k[2]}
        assert repl, restores
        for info in repl.values():
            assert info["tier"] == "mem", info
            assert info["pfs_reads"] == 0, info
            assert info["read_bytes"] == 0, info
            assert info["block_ok"] and info["it"] >= 1, info
        # the fabric was re-protected: someone reseeded replica slots
        assert sum(reseeds) > 0, reseeds

    def test_shrinking_zone_result(self):
        world = SimWorld(4, env=_env(CRAFT_COMM_RECOVERY_POLICY="SHRINKING"))

        def fn(c):
            def body(comm):
                if comm.epoch == 0:
                    if comm.rank == 0:
                        world.kill(3)
                    for _ in range(100):
                        comm.barrier()
                        time.sleep(0.002)
                return comm.size

            return aft_zone(c, body, env=_env(
                CRAFT_COMM_RECOVERY_POLICY="SHRINKING"))

        out = world.run(fn, timeout=120)
        assert set(out.values()) == {3}


# ------------------------------------- kill/respawn run, in both packages
KILL_AT, LAST = 3, 5        # v-3's two RS parity rows sit on nodes 3 and 0


def _aft_env(mod, tmp_path, enable="1"):
    return mod.CraftEnv.capture({
        "CRAFT_ENABLE": enable,
        "CRAFT_NODE_CP_PATH": str(tmp_path / "node"),
        "CRAFT_MEM_SCRATCH": str(tmp_path / "shm"),
        "CRAFT_TIER_CHAIN": "mem,node",
        "CRAFT_NODE_REDUNDANCY": "RS",
        "CRAFT_XOR_GROUP_SIZE": "4",
        "CRAFT_RS_PARITY": "2",
        "CRAFT_MEM_REPLICAS": "1",
        "CRAFT_COMM_RECOVERY_POLICY": "NON-SHRINKING",
        "CRAFT_IO_WORKERS": "1",
    })


def _shard(rank, n=50 + 7):
    """Rank r's starting state: unequal sizes, so the parity pads."""
    rng = np.random.default_rng(100 + rank)
    return rng.standard_normal(n + 13 * rank).astype(np.float32)


def _aft_run(port, tmp_path, kill=True):
    """4 ranks write v-1..v-LAST over mem,node/RS; at v-KILL_AT ranks 1 and
    2 die and lose their node trees.  Returns {rank: (state bytes, it,
    restore tier or None)} of the final incarnation of every rank."""
    mod = T_mod if port else R
    env = _aft_env(mod, tmp_path, "1" if kill else "0")
    world = (SimWorld if port else RefSimWorld)(4, procs_per_node=1, env=env)
    out = {}

    def body(comm):
        it = mod.Box(0)
        if port:
            state = mod.Box(torch.from_numpy(_shard(comm.rank)))
            cp = Checkpoint("aft", comm, env=env)
        else:
            state = mod.Box(_shard(comm.rank))
            cp = mod.Checkpoint("aft", comm, env=env)
        cp.add("it", it)
        # a rank-private state: its own item name, so a node-tier restore
        # never merges it with the peers' (elastic) copies of another rank's
        cp.add(f"state-{comm.rank}", state)
        cp.commit()
        tier = cp.stats["restore_tier"] if cp.restart_if_needed() else None
        while it.value < LAST:
            it.value += 1
            state.value = state.value * 0.5 + float(it.value * (comm.rank + 1))
            cp.update_and_write()
            comm.barrier()
            if kill and comm.epoch == 0 and comm.rank == 0 \
                    and it.value == KILL_AT:
                world.kill(1)
                world.kill(2)
                for n in (1, 2):
                    shutil.rmtree(tmp_path / "node" / f"node-{n}")
            comm.barrier()
        cp.close()
        val = state.value.numpy() if port else np.asarray(state.value)
        out[comm.rank] = (val.tobytes(), it.value, tier)
        return comm.size

    zone = aft_zone if port else R.aft_zone
    res = world.run(lambda c: zone(c, body, env=env), timeout=120)
    assert set(res.values()) == {4}
    return out


import repro_torch.core as T_mod  # noqa: E402


def test_aft_kill_respawn_same_state_in_both_packages(tmp_path):
    clean = _aft_run(True, tmp_path / "clean", kill=False)
    port = _aft_run(True, tmp_path / "port")
    MemFabric.instance().reset()
    ref = _aft_run(False, tmp_path / "ref")
    for rank in range(4):
        assert port[rank][:2] == clean[rank][:2] == ref[rank][:2], rank
    # rank 1's RAM replica sat on rank 2, which died too: the version is no
    # longer whole in RAM, so every rank restores from the node tier, and
    # ranks 1 and 2 through the RS rebuild — in both packages
    assert {r: v[2] for r, v in port.items()} == \
        {r: v[2] for r, v in ref.items()} == {r: "node" for r in range(4)}
    assert clean[0][2] is None


# -- a killed rank's asynchronous write ------------------------------------
def _pub_env(tmp_path, enable="1"):
    return CraftEnv.capture({
        "CRAFT_ENABLE": enable,
        "CRAFT_CP_PATH": str(tmp_path / "pfs"),
        "CRAFT_USE_SCR": "0",
        "CRAFT_WRITE_ASYNC": "1",
        "CRAFT_COMM_RECOVERY_POLICY": "NON-SHRINKING",
        # every rank's second publish passes a (1 ms) stall; rank 0's first
        # incarnation turns its stall into the kill
        "CRAFT_CHAOS": "pfs:stall:ms=1+op=publish+at=1",
    })


def _killed_in_publish_run(tmp_path, kill):
    """2 ranks, async writes, a version every step.  With ``kill``, rank 0
    is fail-stopped while its writer thread is inside the publish of v-2,
    before the barrier there.  Returns {rank: (state bytes, it, restored
    version, replacement)} of each rank's final incarnation."""
    env = _pub_env(tmp_path, "1")
    world = SimWorld(2, spare_nodes=1, env=env)
    out, deaths = {}, []

    def body(comm):
        r = comm.rank
        it = Box(0)
        state = Box(torch.from_numpy(_shard(r)))
        cp = Checkpoint("pub", comm, env=env)
        cp.add("it", it)
        cp.add(f"state-{r}", state)
        cp.commit()
        if kill and r == 0 and comm.epoch == 0:
            def kill_in_publish(_seconds):
                deaths.append(threading.current_thread().name)
                world.kill(0)
            cp._chaos._sleep = kill_in_publish
        restored = cp.version if cp.restart_if_needed() else None
        while it.value < 5:
            it.value += 1
            state.value = state.value * 0.5 + float(it.value * (r + 1))
            cp.update_and_write()
        cp.wait()
        cp.close()
        out[r] = (state.value.numpy().tobytes(), it.value, restored,
                  comm.is_replacement())
        return comm.size

    res = world.run(lambda c: aft_zone(c, body, env=env), timeout=120)
    assert set(res.values()) == {2}
    return out, deaths


def test_kill_inside_an_async_publish_is_recovered(tmp_path):
    """The killed rank's KilledError is raised on its writer thread, at the
    barrier inside ``VersionStore.publish``; it surfaces unwrapped, so the
    rank dies as a fail-stop, the survivor's zone sees the process failure
    (raised to it as the cause of a CheckpointError by its own writer), a
    replacement is spawned, and both resume from v-1 and end on the
    failure-free run's state."""
    clean, _ = _killed_in_publish_run(tmp_path / "clean", kill=False)
    got, deaths = _killed_in_publish_run(tmp_path / "kill", kill=True)
    assert deaths == ["craft-writer-pub"]
    for r in (0, 1):
        assert got[r][:2] == clean[r][:2], r
        assert got[r][2] == 1 and clean[r][2] is None
    assert got[0][3] and not got[1][3]


def _raise(exc):
    def job():
        raise exc
    return job


def test_port_writer_passes_a_fail_stop_through_unwrapped():
    from repro_torch.core.async_writer import AsyncWriter
    from repro_torch.core.comm import KilledError

    w = AsyncWriter()
    ran = []
    w.submit(_raise(KilledError()), label="c v-2")
    w.submit(lambda: ran.append(1), label="c v-3")
    with pytest.raises(KilledError):
        w.wait()
    assert ran == []        # a dead process writes nothing after its death
    w.close()


def test_reference_writer_wraps_a_fail_stop():
    """The deliberate difference: the reference's AsyncWriter wraps the same
    stored KilledError in a CheckpointError (so a simulated rank killed
    inside an async publish is reported as crashed, not as fail-stopped)."""
    from repro.core.async_writer import AsyncWriter as RefWriter
    from repro.core.comm import KilledError as RefKilled
    from repro.core.cpbase import CheckpointError as RefCheckpointError

    w = RefWriter()
    w.submit(_raise(RefKilled()), label="c v-2")
    with pytest.raises(RefCheckpointError) as info:
        w.wait()
    assert isinstance(info.value.__cause__, RefKilled)
    w.close()


@pytest.mark.parametrize("exc, raised", [
    (RuntimeError("boom"), "CheckpointError"),
    (ProcFailedError("peer gone", failed=[1]), "CheckpointError"),
    (OSError(5, "eio"), "OSError"),
])
def test_port_writer_still_wraps_ordinary_errors(exc, raised):
    """Non-regression: an ordinary exception keeps the CheckpointError
    wrapper (with the job's label, the error as its cause); an OSError
    passes through unwrapped; later jobs still run."""
    from repro_torch.core.async_writer import AsyncWriter
    from repro_torch.core.cpbase import CheckpointError

    w = AsyncWriter()
    ran = []
    w.submit(_raise(exc), label="c v-2")
    w.submit(lambda: ran.append(1), label="c v-3")
    with pytest.raises((CheckpointError, OSError)) as info:
        w.wait()
    assert type(info.value).__name__ == raised
    if raised == "CheckpointError":
        assert "c v-2" in str(info.value) and info.value.__cause__ is exc
    else:
        assert info.value is exc
    assert ran == [1]
    w.close()


def test_zone_recovers_from_a_wrapped_comm_failure_only():
    """aft_zone takes a CheckpointError caused by ProcFailedError as that
    process failure (an async write's form of it) and re-raises any other
    CheckpointError."""
    from repro_torch.core.cpbase import CheckpointError

    world = SimWorld(2, env=_env())
    calls = {0: 0, 1: 0}

    def body(c):
        calls[c.rank] += 1
        if calls[c.rank] == 1:
            try:
                raise ProcFailedError("peer", failed=[])
            except ProcFailedError as exc:
                raise CheckpointError("async write failed") from exc
        return c.size

    assert set(world.run(lambda c: aft_zone(c, body), timeout=60).values()) \
        == {2}
    assert calls == {0: 2, 1: 2}

    def bad(c):
        raise CheckpointError("digest mismatch")

    with pytest.raises(RuntimeError, match="digest mismatch"):
        SimWorld(1, env=_env()).run(lambda c: aft_zone(c, bad), timeout=60)


def test_async_version_is_not_torn_by_the_next_snapshot(tmp_path):
    """A copy-based async version holds the snapshot taken when it was
    scheduled, even when its job is still writing as the next version is
    scheduled (its first file write stalls 300 ms here): the next
    snapshot waits for it."""
    import json

    env = CraftEnv.capture({
        "CRAFT_CP_PATH": str(tmp_path), "CRAFT_USE_SCR": "0",
        "CRAFT_WRITE_ASYNC": "1",
        "CRAFT_CHAOS": "pfs:stall:ms=300+op=write+count=1",
    })
    it = Box(0)
    x = Box(torch.zeros(1000))
    with Checkpoint("torn", env=env) as cp:
        cp.add("it", it)
        cp.add("x", x)
        cp.commit()
        for v in (1, 2):
            it.value = v
            x.value = torch.full((1000,), float(v))
            cp.update_and_write()
        cp.wait()
    pod = json.loads((tmp_path / "torn" / "v-1" / "it" / "pod.json")
                     .read_text())
    assert pod["value"] == 1


@pytest.mark.parametrize("killed", [True, False])
def test_a_killed_rank_leaves_its_staging_behind(tmp_path, killed):
    """A KilledError inside a tier write is a process death: the staging
    directory stays for the next start's sweep (the survivors and the
    replacement write into it), as after a chaos crash; any other error
    still aborts it."""
    from repro_torch.core.comm import KilledError

    env = CraftEnv.capture({"CRAFT_CP_PATH": str(tmp_path),
                            "CRAFT_USE_SCR": "0",
                            "CRAFT_CHAOS": "pfs:stall:ms=1+op=publish"})
    exc = KilledError() if killed else RuntimeError("boom")
    cp = Checkpoint("stage", env=env)
    cp.add("x", Box(torch.ones(100)))
    cp.commit()

    def die(_seconds):
        raise exc

    cp._chaos._sleep = die
    with pytest.raises(type(exc)):
        cp.update_and_write(1)
    staged = [p.name for p in (tmp_path / "stage").iterdir()
              if p.name.startswith(".tmp-")]
    assert bool(staged) == killed, staged
