"""The chaos matrix on the port: the reference's ``tests/test_chaos.py``
run against ``repro_torch`` on the CPU, plus checkpoints that cross
packages after a degraded route.

Every injectable storage fault class, on every tier, must leave the
checkpoint either recovered (retry/degrade/re-admit) or cleanly failed —
never serving stale or torn bytes:

* transient faults (EIO / torn write / stall) × {node, pfs} × codecs
  v0/v1/v2 — absorbed by the retry layer, restore bit-identical;
* a persistent PFS outage mid-run — the circuit breaker trips, writes
  degrade to the node tier, the fault clearing re-admits the PFS with a
  forced *full* (non-delta) write, and the final restore is bit-identical;
* the half-open probe, with the cooldown driven by an injected clock
  (``Checkpoint(clock=...)``) instead of a sleep;
* ``ENOSPC`` — one emergency retention squeeze frees space and the write
  lands;
* crash-at-point — the staging dir survives (like a real process death),
  is swept on the next start, and the previous version restores;
* hang + ``CRAFT_IO_DEADLINE_S`` — the hung tier write is abandoned, the
  version lands on the remaining tier, the job is not wedged;
* seeded replay determinism — same spec + seed ⇒ identical injection log.
"""
import numpy as np
import pytest

import repro.core as ref_core
from repro_torch.core import Checkpoint as _Checkpoint
from repro_torch.core import MemFabric
from repro_torch.core.chaos import ChaosCrash, ChaosEngine, parse_chaos_spec
from repro_torch.core.env import CraftEnv
from repro_torch.core.health import CircuitBreaker


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


class FakeClock:
    """A monotonic clock the test advances by hand."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _env(tmp_path, **extra):
    envmap = {
        "CRAFT_CP_PATH": str(tmp_path / "pfs"),
        "CRAFT_NODE_CP_PATH": str(tmp_path / "node"),
        "CRAFT_IO_BACKOFF_MS": "1",
        **{k: str(v) for k, v in extra.items()},
    }
    return CraftEnv.capture(envmap)


def _mk(tmp_path, arr, name="cx", **extra):
    cp = Checkpoint(name, env=_env(tmp_path, **extra))
    cp.add("arr", arr)
    cp.commit()
    return cp


def _restore(tmp_path, shape, name="cx", **extra):
    out = np.zeros(shape)
    cp = _mk(tmp_path, out, name=name, **extra)
    assert cp.restart_if_needed()
    cp.close()
    return out, cp


# ---------------------------------------------------------------- spec layer
def test_spec_parsing_and_validation():
    rules = parse_chaos_spec("pfs:eio:p=0.05,node:stall:ms=500")
    assert [(r.slot, r.fault) for r in rules] == \
        [("pfs", "eio"), ("node", "stall")]
    assert rules[0].p == 0.05 and rules[1].ms == 500.0
    r = parse_chaos_spec("*:erofs:p=1+after=4+count=2")[0]
    assert (r.slot, r.after, r.count) == ("*", 4, 2)
    assert parse_chaos_spec("on") == [] and parse_chaos_spec("") == []
    for bad in ("pfs", "pfs:frobnicate", "disk:eio", "pfs:eio:p=2",
                "pfs:stall", "pfs:eio:wat=1", "pfs:eio:p"):
        with pytest.raises(ValueError):
            parse_chaos_spec(bad)


def test_env_validates_chaos_spec_eagerly(tmp_path):
    with pytest.raises(ValueError):
        _env(tmp_path, CRAFT_CHAOS="pfs:frobnicate")
    assert _env(tmp_path, CRAFT_CHAOS="pfs:eio:p=0.5").chaos


def test_replay_determinism():
    """Same spec + seed ⇒ bit-identical injection schedule."""
    def drive(engine):
        for i in range(200):
            slot = ("pfs", "node", "mem")[i % 3]
            try:
                engine.check(slot, "write", nbytes=i)
            except OSError:
                pass
        return list(engine.log)

    spec = "pfs:eio:p=0.2,node:eio:p=0.1+after=20"
    a = drive(ChaosEngine(spec, seed=7))
    b = drive(ChaosEngine(spec, seed=7))
    assert a == b and a                      # identical and non-empty
    c = drive(ChaosEngine(spec, seed=8))
    assert a != c                            # the seed matters


# ------------------------------------------------------------- breaker layer
def test_circuit_breaker_state_machine():
    t = [0.0]
    br = CircuitBreaker(threshold=2, cooldown_s=10.0, clock=lambda: t[0])
    assert br.allow() and br.state == "closed"
    assert not br.record_failure()           # 1/2
    assert br.record_failure()               # 2/2 -> trips
    assert br.state == "open" and not br.allow()
    t[0] = 5.0
    assert not br.allow()                    # cooldown not elapsed
    t[0] = 10.0
    assert br.allow() and br.state == "half_open"
    assert not br.allow()                    # single probe admitted
    assert br.record_failure()               # failed probe -> re-opens
    assert br.state == "open"
    t[0] = 20.0
    assert br.allow()                        # next probe window
    br.record_success()
    assert br.state == "closed" and br.allow()


# -------------------------------------------------------- transient recovery
@pytest.mark.parametrize("tier", ["node", "pfs"])
@pytest.mark.parametrize("codec", [0, 1, 2])
@pytest.mark.parametrize("fault", ["eio:count=2", "torn:count=1",
                                   "stall:ms=10+count=2"])
def test_transient_fault_matrix(tmp_path, tier, codec, fault):
    """Each transient fault class × each disk tier × each codec: the retry
    layer absorbs the fault and the restore is bit-identical."""
    arr = np.arange(512, dtype=np.float64)
    kw = dict(CRAFT_CODEC_VERSION=codec, CRAFT_CHAOS="on",
              CRAFT_IO_RETRIES=3)
    if codec == 2:
        kw["CRAFT_DELTA"] = 1
    cp = _mk(tmp_path, arr, **kw)
    arr[...] = 1.25
    assert cp.update_and_write()
    cp.chaos.add(f"{tier}:{fault}")
    arr[...] = 2.5
    assert cp.update_and_write()
    st = dict(cp.stats)
    cp.close()
    if "stall" not in fault:
        assert st["retries"] >= 1, st
    assert st["degraded_writes"] == 0        # absorbed, not degraded
    out, cp2 = _restore(tmp_path, arr.shape, **dict(kw, CRAFT_CHAOS=""))
    assert cp2.version == 2
    np.testing.assert_array_equal(out, np.full(arr.shape, 2.5))


def test_read_side_transient_fault_retries(tmp_path):
    arr = np.arange(256, dtype=np.float32)
    cp = _mk(tmp_path, arr)
    arr[...] = 9.0
    assert cp.update_and_write()
    cp.close()
    out = np.zeros(arr.shape, dtype=np.float32)
    cp2 = _mk(tmp_path, out, CRAFT_CHAOS="node:eio:count=1+op=read,"
                                         "pfs:eio:count=1+op=read",
              CRAFT_IO_RETRIES=2)
    assert cp2.restart_if_needed()
    assert cp2.stats["retries"] >= 1
    cp2.close()
    np.testing.assert_array_equal(out, np.full(arr.shape, 9.0, np.float32))


# --------------------------------------------- persistent outage + breaker
def test_pfs_outage_degrades_then_readmits_with_full_write(tmp_path):
    """The acceptance scenario: a persistent PFS outage mid-run — training
    keeps checkpointing to the node tier, the breaker re-admits the PFS
    after the fault clears with a forced full (non-delta) write, and the
    final restore is bit-identical."""
    from repro_torch.core import storage, tiers

    arr = np.arange(1024, dtype=np.float64)
    cp = _mk(tmp_path, arr, CRAFT_CHAOS="on", CRAFT_DELTA=1,
             CRAFT_BREAKER_THRESHOLD=1, CRAFT_BREAKER_COOLDOWN_S=0,
             CRAFT_IO_RETRIES=0)
    arr[...] = 1.0
    assert cp.update_and_write()             # v1 lands everywhere
    pfs = storage.VersionStore(cp.env.cp_path, "cx", sweep=False)
    assert pfs.latest_version() == 1

    cp.chaos.add("pfs:erofs:p=1")            # the PFS goes read-only
    for val in (2.0, 3.0, 4.0):
        arr[...] = val
        assert cp.update_and_write()         # training continues
    assert cp.stats["breaker_trips"] >= 1
    assert cp.stats["degraded_writes"] >= 2
    assert cp.health["pfs"].state == "open"
    assert pfs.latest_version() == 1         # nothing crossed the outage
    assert cp.stats["node_writes"] == 4      # node tier kept every version

    # mid-outage restore: served by the node tier, bit-identical
    out, cp_mid = _restore(tmp_path, arr.shape, CRAFT_DELTA=1)
    assert cp_mid.version == 4
    assert cp_mid.stats["restore_tier"] == "node"
    np.testing.assert_array_equal(out, np.full(arr.shape, 4.0))

    cp.chaos.clear("pfs")                    # the outage ends
    arr[...] = 5.0
    assert cp.update_and_write()             # re-admission write
    assert cp.health["pfs"].state == "closed"
    assert pfs.latest_version() == 5
    # forced full: the re-admission version is self-contained — no delta
    # deps recorded, no ref chunks pointing across the outage
    vdir = pfs.version_dir(5)
    assert not tiers.read_delta_deps(vdir)
    for p in sorted(q for q in vdir.rglob("*.bin")):
        mf = storage.read_chunk_manifest(p)
        if mf is not None:
            assert all("ref" not in c for c in mf["chunks"]), p
    cp.close()

    out5, cp5 = _restore(tmp_path, arr.shape, CRAFT_DELTA=1)
    assert cp5.version == 5
    np.testing.assert_array_equal(out5, np.full(arr.shape, 5.0))


def test_readmission_rides_a_cheap_probe_not_the_version_write(tmp_path):
    """While the outage persists, a past-cooldown attempt costs exactly one
    metadata touch (the half-open probe) — the full version write is never
    gambled on a tier the probe just saw fail.  The cooldown runs on an
    injected clock, so no sleep races it."""
    from repro_torch.core import storage

    clock = FakeClock(100.0)
    arr = np.arange(256, dtype=np.float64)
    cp = Checkpoint("cx", env=_env(tmp_path, CRAFT_CHAOS="on",
                                   CRAFT_IO_RETRIES=0,
                                   CRAFT_BREAKER_THRESHOLD=1,
                                   CRAFT_BREAKER_COOLDOWN_S=0.05),
                    clock=clock)
    cp.add("arr", arr)
    cp.commit()
    arr[...] = 1.0
    assert cp.update_and_write()
    cp.chaos.add("pfs:erofs:p=1")
    arr[...] = 2.0
    assert cp.update_and_write()             # trips
    assert cp.health["pfs"].state == "open"

    clock.advance(0.1)                       # cooldown elapses, fault persists
    ops_before = cp.chaos.op_count("pfs", "write")
    arr[...] = 3.0
    assert cp.update_and_write()
    assert cp.chaos.op_count("pfs", "write") - ops_before == 1
    assert cp.health["pfs"].state == "open"  # failed probe re-opened it
    pfs = storage.VersionStore(cp.env.cp_path, "cx", sweep=False)
    assert pfs.latest_version() == 1

    cp.chaos.clear("pfs")
    clock.advance(0.1)
    arr[...] = 4.0
    assert cp.update_and_write()             # probe re-closes, write lands
    assert cp.health["pfs"].state == "closed"
    assert pfs.latest_version() == 4
    cp.close()


def test_readmission_waits_for_the_injected_cooldown(tmp_path):
    """Without the clock's advance, an open breaker stays shut: no probe,
    not one PFS write, however many versions the node tier takes."""
    from repro_torch.core import storage

    clock = FakeClock()
    arr = np.arange(64, dtype=np.float32)
    cp = Checkpoint("cx", env=_env(tmp_path, CRAFT_CHAOS="on",
                                   CRAFT_IO_RETRIES=0,
                                   CRAFT_BREAKER_THRESHOLD=1,
                                   CRAFT_BREAKER_COOLDOWN_S=0.05),
                    clock=clock)
    cp.add("arr", arr)
    cp.commit()
    cp.chaos.add("pfs:erofs:p=1")
    arr[...] = 1.0
    assert cp.update_and_write()             # trips
    cp.chaos.clear("pfs")                    # healthy again, but in cooldown
    ops_before = cp.chaos.op_count("pfs", "write")
    for val in (2.0, 3.0):
        arr[...] = val
        assert cp.update_and_write()
    assert cp.chaos.op_count("pfs", "write") == ops_before
    assert cp.health["pfs"].state == "open"
    assert storage.VersionStore(cp.env.cp_path, "cx",
                                sweep=False).latest_version() == 0
    clock.advance(0.05)
    arr[...] = 4.0
    assert cp.update_and_write()
    assert cp.health["pfs"].state == "closed"
    cp.close()


def test_degraded_tier_stays_on_policy_radar(tmp_path):
    """A write routed away from a tier must not satisfy that tier's cadence:
    the slot stays due until a write actually lands on it."""
    arr = np.arange(64, dtype=np.float32)
    cp = _mk(tmp_path, arr, CRAFT_CHAOS="on",
             CRAFT_BREAKER_THRESHOLD=1, CRAFT_BREAKER_COOLDOWN_S=0,
             CRAFT_TIER_EVERY="node:1,pfs:4", CRAFT_IO_RETRIES=0)
    cp.chaos.add("pfs:erofs:p=1")
    for it in range(1, 9):
        arr[...] = it
        cp.update_and_write(it)
    # pfs was scheduled at ticks 4 and 8, degraded both times, and stayed
    # owed at every opportunity in between
    assert "pfs" in cp.policy.degraded_slots()
    assert cp.stats["degraded_writes"] >= 2
    cp.chaos.clear("pfs")
    arr[...] = 99.0
    cp.update_and_write(9)                   # owed slot fires immediately
    assert cp.policy.degraded_slots() == ()
    from repro_torch.core import storage
    assert storage.VersionStore(cp.env.cp_path, "cx",
                                sweep=False).latest_version() == cp.version
    cp.close()


def test_mem_tier_fault_degrades_to_disk(tmp_path):
    """A faulty RAM fabric degrades writes down the chain instead of
    failing the job; restore falls through to the disk tiers."""
    arr = np.arange(128, dtype=np.float64)
    cp = _mk(tmp_path, arr, CRAFT_TIER_CHAIN="mem,node,pfs",
             CRAFT_CHAOS="on", CRAFT_BREAKER_THRESHOLD=1,
             CRAFT_BREAKER_COOLDOWN_S=3600, CRAFT_IO_RETRIES=0)
    cp.chaos.add("mem:eio:p=1+op=fabric")
    arr[...] = 7.5
    assert cp.update_and_write()
    assert cp.stats["degraded_writes"] >= 1
    assert cp.stats["mem_writes"] == 0
    assert cp.stats["node_writes"] == 1      # the payload still landed
    assert cp.health["mem"].state == "open"
    cp.close()
    out, cp2 = _restore(tmp_path, arr.shape, CRAFT_TIER_CHAIN="mem,node,pfs")
    assert cp2.stats["restore_tier"] in ("node", "pfs")
    np.testing.assert_array_equal(out, np.full(arr.shape, 7.5))


# ---------------------------------------------------------------- ENOSPC
def test_enospc_triggers_emergency_retire_and_retries(tmp_path):
    arr = np.arange(256, dtype=np.float64)
    cp = _mk(tmp_path, arr, CRAFT_CHAOS="on", CRAFT_IO_RETRIES=0,
             CRAFT_USE_SCR=0, CRAFT_KEEP_VERSIONS=3)
    for val in (1.0, 2.0):
        arr[...] = val
        assert cp.update_and_write()         # two retire-eligible versions
    cp.chaos.add("pfs:enospc:count=1")
    arr[...] = 3.0
    assert cp.update_and_write()             # retire freed space, retry landed
    assert cp.stats["enospc_retires"] == 1
    assert cp.stats["degraded_writes"] == 0
    from repro_torch.core import storage
    store = storage.VersionStore(cp.env.cp_path, "cx", sweep=False)
    assert store.latest_version() == 3
    assert not store.version_dir(1).is_dir()  # v1 was sacrificed
    cp.close()
    out, _ = _restore(tmp_path, arr.shape, CRAFT_USE_SCR=0)
    np.testing.assert_array_equal(out, np.full(arr.shape, 3.0))


# ----------------------------------------------------------- crash-at-point
@pytest.mark.parametrize("codec", [0, 1])
def test_crash_at_point_leaves_previous_version_restorable(tmp_path, codec):
    """A simulated process death mid-write: the staging dir survives (no
    in-process cleanup, like a real crash), the next start sweeps it, and
    the previous version restores bit-identically."""
    arr = np.arange(512, dtype=np.float64)
    kw = dict(CRAFT_CODEC_VERSION=codec, CRAFT_CHAOS="on", CRAFT_USE_SCR=0)
    cp = _mk(tmp_path, arr, **kw)
    arr[...] = 1.0
    assert cp.update_and_write()             # v1 lands cleanly
    nxt = cp.chaos.op_count("pfs", "write")
    cp.chaos.add(f"pfs:crash:at={nxt}")      # die on the very next file write
    arr[...] = 2.0
    with pytest.raises(ChaosCrash):
        cp.update_and_write()
    root = cp.env.cp_path / "cx"
    assert list(root.glob(".tmp-*"))         # staging survives the "death"

    out = np.zeros(arr.shape)
    cp2 = _mk(tmp_path, out, **dict(kw, CRAFT_CHAOS=""))
    assert cp2.restart_if_needed()
    assert cp2.version == 1
    assert not list(root.glob(".tmp-*"))     # swept on start
    np.testing.assert_array_equal(out, np.full(arr.shape, 1.0))
    cp2.close()


def test_all_tiers_down_raises_and_serves_no_stale_bytes(tmp_path):
    """When every tier fails the write, the caller sees the error, the
    version counter does not advance, and a restore still serves the last
    complete version — never torn or stale bytes."""
    arr = np.arange(256, dtype=np.float64)
    cp = _mk(tmp_path, arr, CRAFT_CHAOS="on", CRAFT_USE_SCR=0,
             CRAFT_IO_RETRIES=1)
    arr[...] = 1.0
    assert cp.update_and_write()
    cp.chaos.add("pfs:torn:p=1")             # every attempt tears
    arr[...] = 2.0
    with pytest.raises(OSError):
        cp.update_and_write()
    assert cp.version == 1                   # did not advance
    assert cp.stats["retries"] >= 1
    cp.close()
    out, cp2 = _restore(tmp_path, arr.shape, CRAFT_USE_SCR=0)
    assert cp2.version == 1
    np.testing.assert_array_equal(out, np.full(arr.shape, 1.0))


# -------------------------------------------------------- hang + deadline
def test_hung_write_is_abandoned_not_wedged(tmp_path):
    """An indefinite hang on the node tier is cut off by the write deadline:
    the version lands on the PFS, ``abandoned_writes`` counts it, and the
    async fence returns instead of wedging."""
    arr = np.arange(128, dtype=np.float64)
    cp = _mk(tmp_path, arr, CRAFT_CHAOS="on", CRAFT_WRITE_ASYNC=1,
             CRAFT_IO_DEADLINE_S=0.5, CRAFT_IO_RETRIES=0,
             CRAFT_BREAKER_THRESHOLD=1, CRAFT_BREAKER_COOLDOWN_S=3600)
    cp.chaos.add("node:hang:count=1")
    arr[...] = 4.0
    assert cp.update_and_write()
    cp.wait()                                # returns: the hang was abandoned
    assert cp.stats["abandoned_writes"] == 1
    assert cp.stats["degraded_writes"] >= 1
    from repro_torch.core import storage
    assert storage.VersionStore(cp.env.cp_path, "cx",
                                sweep=False).latest_version() == 1
    cp.close()                               # releases the parked hang
    out, _ = _restore(tmp_path, arr.shape)
    np.testing.assert_array_equal(out, np.full(arr.shape, 4.0))


# ------------------------------------------------------------- async context
def test_async_failure_carries_version_and_tier_context(tmp_path):
    """An async write failure surfaced at the fence names the tier, version
    and array that died (satellite: no more context-free late errors)."""
    from repro_torch.core.cpbase import CheckpointError

    arr = np.arange(64, dtype=np.float64)
    cp = _mk(tmp_path, arr, CRAFT_CHAOS="on", CRAFT_WRITE_ASYNC=1,
             CRAFT_USE_SCR=0, CRAFT_IO_RETRIES=0)
    arr[...] = 1.0
    assert cp.update_and_write()
    cp.wait()
    cp.chaos.add("pfs:eio:p=1")
    arr[...] = 2.0
    assert cp.update_and_write()
    with pytest.raises(OSError, match=r"pfs tier v-2 array 'arr'"):
        cp.wait()
    cp.close()


# --------------------------------------------------------- across packages
def _package(which):
    """(Checkpoint, CraftEnv, storage, tiers) of the port or the reference."""
    if which == "port":
        from repro_torch.core import storage, tiers
        return Checkpoint, CraftEnv, storage, tiers
    from repro.core import storage, tiers
    return ref_core.Checkpoint, ref_core.CraftEnv, storage, tiers


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_forced_full_readmission_restores_across_packages(tmp_path, writer,
                                                          reader):
    """A PFS outage degrades two versions to the node tier; the version
    that re-admits the PFS is a forced full.  With the node tier gone, the
    other package restores that version from the PFS bit for bit."""
    import shutil

    mk, Env, storage, tiers = _package(writer)
    base = {"CRAFT_CP_PATH": str(tmp_path / "pfs"),
            "CRAFT_NODE_CP_PATH": str(tmp_path / "node"),
            "CRAFT_IO_BACKOFF_MS": "1", "CRAFT_DELTA": "1",
            "CRAFT_CHUNK_BYTES": "1024"}
    env = Env.capture({**base, "CRAFT_CHAOS": "on",
                       "CRAFT_BREAKER_THRESHOLD": "1",
                       "CRAFT_BREAKER_COOLDOWN_S": "0",
                       "CRAFT_IO_RETRIES": "0"})
    rng = np.random.default_rng(21)
    arr = rng.standard_normal(4096).astype(np.float32)
    cp = mk("cx", env=env)
    cp.add("arr", arr)
    cp.commit()
    assert cp.update_and_write()              # v1 full on both tiers
    cp.chaos.add("pfs:erofs:p=1")
    for val in (2.0, 3.0):
        arr[:8] = val                         # one dirty chunk a version
        assert cp.update_and_write()          # degraded to the node tier
    assert cp.stats["degraded_writes"] >= 2
    assert cp.health["pfs"].state == "open"
    cp.chaos.clear("pfs")
    arr[:8] = 5.0                             # a delta would hold refs
    assert cp.update_and_write()              # re-admission: forced full
    assert cp.health["pfs"].state == "closed"
    pfs = storage.VersionStore(cp.env.cp_path, "cx", sweep=False)
    vdir = pfs.version_dir(4)
    assert not tiers.read_delta_deps(vdir)
    for p in sorted(vdir.rglob("*.bin")):
        mf = storage.read_chunk_manifest(p)
        if mf is not None:
            assert all("ref" not in c for c in mf["chunks"]), p
    expect = arr.copy()
    cp.close()

    shutil.rmtree(tmp_path / "node")          # only the PFS copy is left
    rmk, REnv, _, _ = _package(reader)
    out = np.zeros_like(expect)
    cp2 = rmk("cx", env=REnv.capture(base))
    cp2.add("arr", out)
    cp2.commit()
    assert cp2.restart_if_needed()
    assert cp2.version == 4
    assert cp2.stats["restore_tier"] == "pfs"
    cp2.close()
    assert out.tobytes() == expect.tobytes()
