"""CheckpointPolicy edge cases on the port: the reference's
``tests/test_scheduler.py`` run against ``repro_torch`` on the CPU —
Daly monotonicity, fake-clock walltime guard, in-process signal flush,
backpressure stretching, post-recovery estimator reset, and the
bit-identical preemption restore, which also restores in the other
package."""
import signal

import numpy as np
import pytest

import repro.core as ref_core
from repro_torch.core import Box, CraftEnv, MemFabric
from repro_torch.core import Checkpoint as _Checkpoint
from repro_torch.core import scheduler as sched
from repro_torch.core.checkpointables import NdArrayCp
from repro_torch.core.scheduler import CheckpointPolicy, daly_interval
from repro_torch.core.tiers import StorageTier


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
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class CostTier(StorageTier):
    """Cost-model stub: only the base-class write_cost surface is used."""

    def __init__(self, slot: str):
        self.label = slot

    def stage(self, version):
        raise NotImplementedError

    def publish(self, staged, version, extra_meta=None):
        raise NotImplementedError

    def abort(self, staged):
        raise NotImplementedError

    def latest_version(self) -> int:
        return 0

    def version_dir(self, version):
        raise NotImplementedError

    def invalidate_all(self) -> None:
        pass


def make_policy(envmap, slots=("pfs",), clock=None, **kw):
    env = CraftEnv.capture({"CRAFT_CP_PATH": "/unused", **envmap})
    stores = {s: CostTier(s) for s in slots}
    return CheckpointPolicy(env, stores, clock=clock or FakeClock(), **kw), \
        stores


# ---------------------------------------------------------------- the formula
class TestDalyInterval:
    def test_monotonic_in_cost(self):
        mtbf = 3600.0
        costs = [0.01, 0.1, 1.0, 10.0, 100.0]
        intervals = [daly_interval(c, mtbf) for c in costs]
        assert intervals == sorted(intervals)
        assert all(a < b for a, b in zip(intervals, intervals[1:]))

    def test_young_first_order_limit(self):
        # δ ≪ M: Daly reduces to Young's √(2δM)
        assert daly_interval(1.0, 10_000_000.0) == pytest.approx(
            (2 * 1.0 * 10_000_000.0) ** 0.5, rel=0.01)

    def test_saturates_at_mtbf(self):
        assert daly_interval(500.0, 100.0) == 500.0   # write-cost floor
        assert daly_interval(250.0, 120.0) == 250.0

    def test_monotonic_and_continuous_across_saturation(self):
        mtbf = 100.0
        costs = [50.0, 150.0, 199.9, 200.0, 200.1, 400.0]
        intervals = [daly_interval(c, mtbf) for c in costs]
        assert intervals == sorted(intervals)
        # no cliff at δ = 2M
        assert abs(daly_interval(200.0, mtbf)
                   - daly_interval(199.999, mtbf)) < 0.01

    def test_degenerate_inputs(self):
        assert daly_interval(0.0, 3600.0) == 0.0
        assert daly_interval(1.0, 0.0) == float("inf")

    def test_never_below_write_cost(self):
        assert daly_interval(50.0, 30.0) >= 50.0


# ---------------------------------------------------------------- env parsing
class TestTierEveryParsing:
    def test_bare_auto_applies_to_all(self):
        env = CraftEnv.capture({"CRAFT_TIER_EVERY": "auto"})
        for slot in ("mem", "node", "pfs"):
            assert env.tier_every_for(slot) == "auto"

    def test_counts_and_mixtures(self):
        env = CraftEnv.capture(
            {"CRAFT_TIER_EVERY": "mem:1,node:8,pfs:auto"})
        assert env.tier_every_for("mem") == 1
        assert env.tier_every_for("node") == 8
        assert env.tier_every_for("pfs") == "auto"

    def test_unnamed_slots_stay_legacy(self):
        env = CraftEnv.capture({"CRAFT_TIER_EVERY": "pfs:64"})
        assert env.tier_every_for("node") is None

    @pytest.mark.parametrize("bad", [
        "disk:3", "pfs", "pfs:0", "pfs:-2", "pfs:3,pfs:4", "pfs:x",
    ])
    def test_rejects(self, bad):
        with pytest.raises(ValueError):
            CraftEnv.capture({"CRAFT_TIER_EVERY": bad})

    def test_cp_signal_parsing(self):
        env = CraftEnv.capture({"CRAFT_CP_SIGNAL": "SIGUSR1, term"})
        assert env.cp_signal == ("SIGUSR1", "SIGTERM")
        with pytest.raises(ValueError):
            CraftEnv.capture({"CRAFT_CP_SIGNAL": "SIGNOPE"})


# ----------------------------------------------------------------- cadences
class TestCadences:
    def test_opportunity_counts(self):
        policy, _ = make_policy({"CRAFT_TIER_EVERY": "node:1,pfs:3"},
                                slots=("node", "pfs"))
        version = 0
        pfs_hits = []
        for it in range(1, 10):
            d = policy.need_checkpoint(it, next_version=version + 1)
            assert d.write                    # node:1 writes every time
            if "pfs" in d.tiers:
                pfs_hits.append(it)
            version += 1
            policy.record_written(d, version)
        assert pfs_hits == [3, 6, 9]

    def test_probe_then_write_counts_once(self):
        policy, _ = make_policy({"CRAFT_TIER_EVERY": "pfs:2"})
        d1 = policy.need_checkpoint(1, next_version=1)
        d1b = policy.need_checkpoint(1, next_version=1)   # probe again
        assert d1.write == d1b.write is False
        d2 = policy.need_checkpoint(2, next_version=1)
        assert d2.write

    def test_auto_seeds_then_spaces_out(self):
        clock = FakeClock()
        policy, stores = make_policy(
            {"CRAFT_TIER_EVERY": "auto", "CRAFT_MTBF_SECONDS": "800"},
            clock=clock)
        # no cost estimate → due immediately (the seeding write)
        d = policy.need_checkpoint(1, next_version=1)
        assert d.write
        stores["pfs"].record_write(1.0)
        policy.record_written(d, 1)
        expected = daly_interval(1.0, 800.0)
        clock.advance(expected * 0.5)
        assert not policy.need_checkpoint(2, next_version=2).write
        clock.advance(expected * 0.6)
        assert policy.need_checkpoint(3, next_version=2).write

    def test_legacy_pfs_every_preserved(self):
        # no CRAFT_TIER_EVERY → version-number modulo, bit-compatible
        policy, _ = make_policy({"CRAFT_PFS_EVERY": "4"},
                                slots=("node", "pfs"))
        tiers_by_version = {}
        for v in range(1, 9):
            d = policy.need_checkpoint(v, next_version=v)
            tiers_by_version[v] = d.tiers
            policy.record_written(d, v)
        for v, tiers in tiers_by_version.items():
            assert ("pfs" in tiers) == (v % 4 == 0)
            assert "node" in tiers


# -------------------------------------------------------------- backpressure
class TestBackpressure:
    def test_auto_interval_stretches(self):
        clock = FakeClock()
        queue = {"depth": 0}
        env = CraftEnv.capture({
            "CRAFT_CP_PATH": "/unused", "CRAFT_TIER_EVERY": "auto",
            "CRAFT_MTBF_SECONDS": "800",
        })
        stores = {"pfs": CostTier("pfs")}
        policy = CheckpointPolicy(env, stores, clock=clock,
                                  backpressure=lambda: queue["depth"])
        d = policy.need_checkpoint(1, next_version=1)
        stores["pfs"].record_write(1.0)
        policy.record_written(d, 1)
        base = daly_interval(1.0, 800.0)
        clock.advance(base * 1.5)
        queue["depth"] = 3                 # saturated → interval × 4
        assert not policy.need_checkpoint(2, next_version=2).write
        assert policy.stats["backpressure_stretches"] == 1
        queue["depth"] = 0
        assert policy.need_checkpoint(3, next_version=2).write

    def test_count_cadence_defers_and_owes(self):
        queue = {"depth": 1}
        env = CraftEnv.capture({
            "CRAFT_CP_PATH": "/unused", "CRAFT_TIER_EVERY": "pfs:2",
        })
        stores = {"pfs": CostTier("pfs")}
        policy = CheckpointPolicy(env, stores, clock=FakeClock(),
                                  backpressure=lambda: queue["depth"])
        assert not policy.need_checkpoint(1, next_version=1).write
        assert not policy.need_checkpoint(2, next_version=1).write  # deferred
        queue["depth"] = 0
        d = policy.need_checkpoint(3, next_version=1)   # debt repaid
        assert d.write and d.tiers == ("pfs",)


# ------------------------------------------------------- triggers and resets
class TestWalltimeGuard:
    def test_final_checkpoint_fires_once(self):
        clock = FakeClock()
        policy, stores = make_policy({
            "CRAFT_TIER_EVERY": "pfs:1000",       # cadence would never fire
            "CRAFT_WALLTIME_SECONDS": "100",
            "CRAFT_WALLTIME_MARGIN_SECONDS": "10",
        }, clock=clock)
        clock.advance(50.0)
        assert not policy.need_checkpoint(1, next_version=1).write
        clock.advance(41.0)                       # 91 ≥ 100 − 10
        d = policy.need_checkpoint(2, next_version=1)
        assert d.write and d.final and d.full and d.sync
        assert d.tiers == ("pfs",)
        policy.record_written(d, 1)
        assert policy.should_stop
        clock.advance(5.0)
        assert not policy.need_checkpoint(3, next_version=2).final

    def test_margin_extends_by_estimated_write_cost(self):
        clock = FakeClock()
        policy, stores = make_policy({
            "CRAFT_WALLTIME_SECONDS": "100",
            "CRAFT_WALLTIME_MARGIN_SECONDS": "10",
        }, clock=clock)
        stores["pfs"].record_write(20.0)          # expensive tier
        clock.advance(75.0)                       # 75 ≥ 100 − 10 − 20
        assert policy.need_checkpoint(1, next_version=1).final

    def test_real_checkpoint_walltime_restores(self, tmp_path):
        clock = FakeClock()
        env = CraftEnv.capture({
            "CRAFT_CP_PATH": str(tmp_path), "CRAFT_USE_SCR": "0",
            "CRAFT_WALLTIME_SECONDS": "100",
            "CRAFT_WALLTIME_MARGIN_SECONDS": "5",
            "CRAFT_TIER_EVERY": "pfs:1000000",    # only the guard can write
        })
        arr = np.arange(64, dtype=np.float64)
        with Checkpoint("wt", env=env, clock=clock) as cp:
            cp.add("it", Box(0))
            cp.add("arr", arr)
            cp.commit()
            for it in range(1, 5):
                clock.advance(30.0)
                arr += 1.0
                cp.update_and_write(it)
                if cp.should_stop:
                    break
            assert cp.stats["final_writes"] == 1
            expect = arr.copy()
        restored = np.zeros_like(expect)
        env2 = CraftEnv.capture({"CRAFT_CP_PATH": str(tmp_path),
                                 "CRAFT_USE_SCR": "0"})
        with Checkpoint("wt", env=env2) as cp2:
            cp2.add("it", Box(0))
            cp2.add("arr", restored)
            cp2.commit()
            assert cp2.restart_if_needed()
        assert np.array_equal(restored, expect)


class TestPreemption:
    def test_flag_forces_sync_full_flush_of_deepest_tier(self):
        policy, _ = make_policy(
            {"CRAFT_TIER_EVERY": "node:1000,pfs:1000"},
            slots=("node", "pfs"))
        assert not policy.need_checkpoint(1, next_version=1).write
        policy.trigger_preemption()
        d = policy.need_checkpoint(2, next_version=1)
        assert d.write and d.sync and d.full and d.reason == "preempt"
        assert d.tiers == ("pfs",)                 # deepest only
        policy.record_written(d, 1)
        assert policy.should_stop
        # once flushed, the trigger does not re-fire
        assert not policy.need_checkpoint(3, next_version=2).write

    def test_in_process_signal_sets_flag(self, tmp_path):
        env = CraftEnv.capture({
            "CRAFT_CP_PATH": str(tmp_path), "CRAFT_USE_SCR": "0",
            "CRAFT_CP_SIGNAL": "SIGUSR1",
        })
        old = signal.getsignal(signal.SIGUSR1)
        with Checkpoint("sig", env=env) as cp:
            cp.add("x", Box(1))
            cp.commit()
            assert not cp.policy.preempted
            signal.raise_signal(signal.SIGUSR1)    # no real kill in CI
            assert cp.policy.preempted
            assert cp.update_and_write(1, cp_freq=1000)   # gate overridden
            assert cp.stats["preempt_flushes"] == 1
            assert cp.should_stop
        # close() restored the previous disposition
        assert signal.getsignal(signal.SIGUSR1) == old

    def test_preempt_flush_restores_bit_identically(self, tmp_path):
        envmap = {
            "CRAFT_CP_PATH": str(tmp_path), "CRAFT_USE_SCR": "0",
            "CRAFT_WRITE_ASYNC": "1", "CRAFT_DELTA": "1",
            "CRAFT_CHUNK_BYTES": str(64 * 1024),
        }
        rng = np.random.default_rng(0)
        arr = rng.standard_normal((256 * 1024,)).astype(np.float32)
        with Checkpoint("pre", env=CraftEnv.capture(envmap)) as cp:
            cp.add("arr", NdArrayCp(arr))
            cp.commit()
            cp.update_and_write()                  # async full
            arr[::1024] += 1.0
            cp.update_and_write()                  # async delta
            arr[::512] -= 0.25                     # unflushed mutation
            expect = arr.copy()
            cp.policy.trigger_preemption()
            assert cp.update_and_write()           # sync full flush
            assert cp.stats["preempt_flushes"] == 1
        restored = np.zeros_like(expect)
        with Checkpoint("pre", env=CraftEnv.capture(envmap)) as cp2:
            cp2.add("arr", NdArrayCp(restored))
            cp2.commit()
            assert cp2.restart_if_needed()
        assert np.array_equal(restored, expect)


class TestRecoveryReset:
    def test_epoch_bump_resets_estimators_and_forces_full(self):
        policy, stores = make_policy({"CRAFT_TIER_EVERY": "pfs:1"})
        d = policy.need_checkpoint(1, next_version=1)
        stores["pfs"].record_write(2.0)
        policy.record_written(d, 1)
        assert stores["pfs"].write_cost() == 2.0
        sched.notify_recovery()                    # what aft.py does
        d2 = policy.need_checkpoint(2, next_version=2)
        assert d2.write and d2.full and d2.reason == "recovery-full"
        assert stores["pfs"].write_cost() is None  # EWMA dropped
        assert policy.stats["recovery_resets"] == 1
        policy.record_written(d2, 2)
        d3 = policy.need_checkpoint(3, next_version=3)
        assert d3.write and not d3.full            # back to deltas

    def test_empirical_mtbf_from_engine(self):
        from repro_torch.core.ftengine import CollectiveEngine

        engine = CollectiveEngine({0: 0, 1: 1})
        assert engine.empirical_mtbf() is None
        engine.set_occupant(0, 1, "u1")
        engine.mark_dead("u1")
        mtbf = engine.empirical_mtbf()
        assert mtbf is not None and mtbf > 0
        assert engine.failure_count() == 1

    def test_policy_prefers_configured_over_empirical(self):
        policy, _ = make_policy({"CRAFT_MTBF_SECONDS": "123"},
                                mtbf_fn=lambda: 999.0)
        assert policy.mtbf() == 123.0
        policy2, _ = make_policy({}, mtbf_fn=lambda: 999.0)
        assert policy2.mtbf() == 999.0
        policy3, _ = make_policy({})
        assert policy3.mtbf() == sched.DEFAULT_MTBF_SECONDS


class TestStepTimer:
    def test_observe_and_tick(self):
        from repro_torch.train.steps import StepTimer

        clk = FakeClock()
        t = StepTimer(alpha=0.5, clock=clk)
        assert t.tick() is None
        clk.advance(2.0)
        assert t.tick() == 2.0
        t.observe(4.0)
        assert t.ewma == pytest.approx(3.0)
        t.observe(-1.0)                            # ignored
        assert t.last == 4.0


class TestDalyDegenerateEdges:
    """The full degenerate-input contract the simulator/tuner rely on —
    a tuner grid sweep hits these corners routinely."""

    def test_negative_cost_is_zero_interval(self):
        assert daly_interval(-5.0, 3600.0) == 0.0

    def test_infinite_mtbf_never_checkpoints(self):
        import math
        assert daly_interval(1.0, math.inf) == math.inf

    def test_negative_mtbf_is_infinite(self):
        assert daly_interval(1.0, -10.0) == float("inf")

    def test_saturation_boundary_exact(self):
        # δ == 2M is the first saturated point: max(M, δ) == δ there
        assert daly_interval(200.0, 100.0) == 200.0
        # just below the boundary the closed form applies and stays ≥ δ
        assert daly_interval(199.999999, 100.0) >= 199.999999


class TestDegradedWalltimeInteraction:
    """A degraded (always-due) slot must not mask the walltime guard, and
    the guard's final full flush covers the whole chain including the
    degraded slot — the last checkpoint before the job dies is the one
    write that must not skip a tier that might be back."""

    def test_walltime_fires_with_degraded_slot(self):
        clock = FakeClock()
        policy, stores = make_policy({
            "CRAFT_TIER_EVERY": "node:4,pfs:1000",
            "CRAFT_WALLTIME_SECONDS": "100",
            "CRAFT_WALLTIME_MARGIN_SECONDS": "10",
        }, slots=("node", "pfs"), clock=clock)
        policy.note_degraded("node")
        # degraded slot is owed every opportunity while we're inside budget
        d = policy.need_checkpoint(1, next_version=1)
        assert d.write and "node" in d.tiers and not d.final
        policy.record_written(d, 1)
        clock.advance(95.0)
        d = policy.need_checkpoint(2, next_version=2)
        assert d.final and d.full and d.sync
        assert d.tiers == ("node", "pfs")        # whole chain, degraded too
        assert "node" in policy.degraded_slots()  # still owed until landed

    def test_degraded_slot_cleared_only_by_landing(self):
        clock = FakeClock()
        policy, stores = make_policy({
            "CRAFT_TIER_EVERY": "node:2,pfs:1000",
        }, slots=("node", "pfs"), clock=clock)
        policy.note_degraded("node")
        d = policy.need_checkpoint(1, next_version=1)
        assert "node" in d.tiers
        # scheduling alone (record_written) must NOT clear the debt — the
        # write may have been routed away from the slot again
        policy.record_written(d, 1)
        assert "node" in policy.degraded_slots()
        policy.note_tier_written("node")
        assert "node" not in policy.degraded_slots()


class TestRetryJitterBand:
    def test_backoff_jitter_stays_in_band(self):
        """Delay before retry k is backoff · 2^(k−1) · u with u ∈ [0.5, 1.5):
        the fleet-desynchronization contract docs/tuning.md quotes."""
        import errno as _errno

        from repro_torch.core.health import retry_call

        delays = []
        calls = [0]

        def flaky():
            calls[0] += 1
            if calls[0] <= 40:
                raise OSError(_errno.EIO, "transient")
            return "ok"

        assert retry_call(flaky, retries=40, backoff_ms=8.0,
                          sleep=delays.append) == "ok"
        assert len(delays) == 40
        for k, d in enumerate(delays, start=1):
            base = (8.0 / 1000.0) * (2 ** (k - 1))
            assert base * 0.5 <= d < base * 1.5


class TestOnlineRetune:
    def test_retune_replaces_count_cadences_from_live_costs(self):
        clock = FakeClock()
        policy, stores = make_policy({
            "CRAFT_TIER_EVERY": "pfs:1",
            "CRAFT_TUNE_ONLINE": "1",
            "CRAFT_TUNE_EVERY_S": "10",
            "CRAFT_MTBF_SECONDS": "3600",
        }, clock=clock)
        # live estimates: 1 s steps, 2 s writes → Daly interval ≫ 1 step
        policy.observe_step_seconds(1.0)
        stores["pfs"].record_write(2.0)
        assert policy.cadence("pfs") == 1
        clock.advance(11.0)
        policy.need_checkpoint(1, next_version=1)
        expected = max(1, int(round(
            daly_interval(2.0, 3600.0) / policy.step_seconds())))
        assert policy.cadence("pfs") == expected > 1
        assert policy.stats["online_retunes"] == 1
        # stable inputs ⇒ no further retunes
        clock.advance(11.0)
        policy.need_checkpoint(2, next_version=1)
        assert policy.stats["online_retunes"] == 1

    def test_retune_off_by_default_and_gated_on_step_estimate(self):
        clock = FakeClock()
        policy, stores = make_policy({
            "CRAFT_TIER_EVERY": "pfs:1",
            "CRAFT_TUNE_ONLINE": "1",
            "CRAFT_TUNE_EVERY_S": "10",
        }, clock=clock)
        stores["pfs"].record_write(2.0)
        clock.advance(11.0)
        policy.need_checkpoint(None, next_version=1)   # no step estimate yet
        assert policy.cadence("pfs") == 1
        off, _ = make_policy({"CRAFT_TIER_EVERY": "pfs:1"}, clock=clock)
        off.observe_step_seconds(1.0)
        clock.advance(100.0)
        off.need_checkpoint(1, next_version=1)
        assert off.stats["online_retunes"] == 0


# --------------------------------------------------------- across packages
@pytest.mark.parametrize("writer", ["port", "ref"])
def test_preempt_flush_restores_in_the_other_package(tmp_path, writer):
    """An async delta chain ended by a preemption flush (a sync full write
    of the deepest tier), written by one package, restores bit for bit in
    the other."""
    envmap = {
        "CRAFT_CP_PATH": str(tmp_path), "CRAFT_USE_SCR": "0",
        "CRAFT_WRITE_ASYNC": "1", "CRAFT_DELTA": "1",
        "CRAFT_CHUNK_BYTES": str(64 * 1024),
    }
    mk, Env = ((Checkpoint, CraftEnv) if writer == "port"
               else (ref_core.Checkpoint, ref_core.CraftEnv))
    rmk, REnv = ((ref_core.Checkpoint, ref_core.CraftEnv) if writer == "port"
                 else (Checkpoint, CraftEnv))
    rng = np.random.default_rng(0)
    arr = rng.standard_normal((256 * 1024,)).astype(np.float32)
    with mk("pre", env=Env.capture(envmap)) as cp:
        cp.add("arr", arr)
        cp.commit()
        cp.update_and_write()                  # async full
        arr[::1024] += 1.0
        cp.update_and_write()                  # async delta
        arr[::512] -= 0.25                     # unflushed mutation
        expect = arr.copy()
        cp.policy.trigger_preemption()
        assert cp.update_and_write()           # sync full flush
        assert cp.stats["preempt_flushes"] == 1
    restored = np.zeros_like(expect)
    with rmk("pre", env=REnv.capture(envmap)) as cp2:
        cp2.add("arr", restored)
        cp2.commit()
        assert cp2.restart_if_needed()
        assert cp2.version == 3
    assert restored.tobytes() == expect.tobytes()
