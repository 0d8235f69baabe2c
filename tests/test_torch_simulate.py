"""Trace recorder + deterministic replay on the port: the reference's
``tests/test_simulate.py`` run against ``repro_torch`` on the CPU, plus
traces replayed across packages.

The record → replay loop must be faithful enough that a replayed policy
re-derives a live run's decision sequence *exactly* — including a chaos run
with degraded routing — and the what-if simulator's accounting must stay
internally consistent.  A trace recorded by either package replays with the
same decisions under both packages' ``replay``, and both packages'
``simulate_config`` and ``tune`` give equal reports on it.
"""
import dataclasses
import json

import numpy as np
import pytest

import repro.core as ref_core
from repro.core import simulate as ref_simulate
from repro.core import trace as ref_trace
from repro.core import tune as ref_tune
from repro_torch.core import Checkpoint as _Checkpoint
from repro_torch.core import MemFabric
from repro_torch.core import trace as trace_mod
from repro_torch.core.env import CraftEnv
from repro_torch.core.simulate import (
    FakeClock, SimTier, load_trace, replay, simulate_config, summarize,
)
from repro_torch.core.tune import recommend_env_block, tune


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


@pytest.fixture(autouse=True)
def _tracer_cleanup():
    """Every test leaves the process-global tracer disarmed."""
    yield
    trace_mod.uninstall()
    ref_trace.uninstall()


def _env(tmp_path, **extra):
    envmap = {
        "CRAFT_CP_PATH": str(tmp_path / "pfs"),
        "CRAFT_NODE_CP_PATH": str(tmp_path / "node"),
        "CRAFT_IO_BACKOFF_MS": "1",
        **{k: str(v) for k, v in extra.items()},
    }
    return CraftEnv.capture(envmap)


def _run_traced(tmp_path, n_iter=40, **extra):
    """One live run with CRAFT_TRACE armed; returns (events, stats)."""
    tpath = tmp_path / "run-trace.jsonl"
    env = _env(tmp_path, CRAFT_TRACE=tpath, **extra)
    arr = np.arange(4096, dtype=np.float64)
    cp = Checkpoint("traced", env=env)
    cp.add("arr", arr)
    cp.commit()
    cp.restart_if_needed()
    try:
        for it in range(n_iter):
            arr += 1.0
            if cp.need_checkpoint(it):
                cp.update_and_write(it)
        cp.wait()
    finally:
        cp.close()
        stats = dict(cp.stats)
        trace_mod.uninstall()          # flush + close before reading back
    return load_trace(tpath), stats


# ------------------------------------------------------------- recorder layer
class TestRecorder:
    def test_null_tracer_when_env_unset(self, tmp_path):
        env = _env(tmp_path)
        assert env.trace_path == ""
        trace_mod.maybe_install_from_env(env)
        assert not trace_mod.enabled()
        # emits on the disarmed tracer are no-ops, not errors
        trace_mod.emit("step", seconds=1.0)

    def test_install_is_idempotent_and_appends(self, tmp_path):
        p = tmp_path / "t.jsonl"
        trace_mod.install(str(p))
        first = trace_mod.TRACER
        trace_mod.install(str(p))
        assert trace_mod.TRACER is first      # same path: same writer
        trace_mod.emit("step", seconds=0.5)
        trace_mod.uninstall()
        trace_mod.install(str(p))             # re-install appends
        trace_mod.emit("step", seconds=0.7)
        trace_mod.uninstall()
        kinds = [e["kind"] for e in load_trace(p)]
        assert kinds == ["step", "step"]

    def test_load_trace_skips_torn_tail(self, tmp_path):
        p = tmp_path / "torn.jsonl"
        p.write_text(json.dumps({"t": 0.0, "kind": "step", "seconds": 1.0})
                     + "\n" + '{"t": 0.1, "kind": "ste')   # killed mid-line
        events = load_trace(p)
        assert [e["kind"] for e in events] == ["step"]

    def test_live_run_emits_config_and_decisions(self, tmp_path):
        events, stats = _run_traced(tmp_path, n_iter=10,
                                    CRAFT_USE_SCR="0",
                                    CRAFT_TIER_EVERY="pfs:3")
        kinds = [e["kind"] for e in events]
        assert kinds[0] == "config"
        cfg = events[0]
        assert cfg["env"]["CRAFT_TIER_EVERY"] == "pfs:3"
        assert cfg["payload_bytes"] == 4096 * 8
        assert kinds.count("decision") == 10
        assert kinds.count("tier_write") == stats["pfs_writes"] > 0
        # timestamps are a total order
        ts = [e["t"] for e in events]
        assert ts == sorted(ts)


# --------------------------------------------------------------- exact replay
class TestReplay:
    def test_replay_requires_config(self):
        with pytest.raises(ValueError):
            replay([{"t": 0.0, "kind": "step", "seconds": 1.0}])

    def test_replay_matches_live_clean_run(self, tmp_path):
        events, stats = _run_traced(tmp_path, n_iter=30,
                                    CRAFT_TIER_EVERY="node:2,pfs:5")
        r = replay(events)
        assert r.decisions_match, f"mismatches at {r.mismatches[:5]}"
        assert r.scheduled_writes == stats["writes"]
        assert r.tier_landed["node"] == stats["node_writes"]
        assert r.tier_landed["pfs"] == stats["pfs_writes"]
        assert r.tier_landed_bytes["pfs"] == \
            stats["pfs_writes"] * 4096 * 8

    def test_replay_matches_live_chaos_run(self, tmp_path):
        """The cross-validation contract: a chaos run (node-tier outage
        mid-run, breaker trip, degraded routing to the PFS, forced-full
        re-admission) replays with zero decision mismatches and exact
        per-tier accounting."""
        events, stats = _run_traced(
            tmp_path, n_iter=40,
            CRAFT_TIER_EVERY="node:2,pfs:4",
            CRAFT_DELTA="1",
            CRAFT_CHAOS="node:eio:p=1+after=4+count=6",
            CRAFT_IO_RETRIES="0",
            CRAFT_BREAKER_THRESHOLD="2",
            CRAFT_BREAKER_COOLDOWN_S="0.05",
        )
        assert stats["degraded_writes"] > 0      # the fault actually fired
        r = replay(events)
        assert r.decisions_match, f"mismatches at {r.mismatches[:5]}"
        assert r.scheduled_writes == stats["writes"]
        assert r.tier_landed["node"] == stats["node_writes"]
        assert r.tier_landed["pfs"] == stats["pfs_writes"]
        total_bytes = sum(r.tier_landed_bytes.values())
        assert total_bytes == sum(
            e["nbytes"] for e in events if e["kind"] == "tier_write")
        # forced-full decisions re-derived — at least the post-outage
        # re-admission write is full under CRAFT_DELTA=1
        recorded_fulls = sum(1 for e in events
                             if e["kind"] == "decision" and e.get("full"))
        assert r.full_writes == recorded_fulls

    def test_replay_is_deterministic(self, tmp_path):
        events, _ = _run_traced(tmp_path, n_iter=20,
                                CRAFT_TIER_EVERY="node:3,pfs:7")
        a, b = replay(events), replay(events)
        assert a.sim_decisions == b.sim_decisions
        assert a.tier_landed == b.tier_landed


# ------------------------------------------------------------ what-if + tune
class TestSimulateConfig:
    def _summary(self, tmp_path, **extra):
        events, _ = _run_traced(tmp_path, n_iter=20,
                                CRAFT_TIER_EVERY="node:2,pfs:5", **extra)
        return summarize(events)

    def test_summary_distills_costs_and_steps(self, tmp_path):
        s = self._summary(tmp_path)
        assert s.payload_bytes == 4096 * 8
        assert s.steps and all(x > 0 for x in s.steps)
        assert set(s.tier_full_cost) == {"node", "pfs"}
        assert all(v > 0 for v in s.tier_full_cost.values())

    def test_same_seed_same_report(self, tmp_path):
        s = self._summary(tmp_path)
        a = simulate_config(s, {}, seed=3, horizon_steps=400)
        b = simulate_config(s, {}, seed=3, horizon_steps=400)
        assert a.as_dict() == b.as_dict()

    def test_sparser_cadence_cuts_write_overhead_without_failures(
            self, tmp_path):
        s = self._summary(tmp_path, CRAFT_MTBF_SECONDS="1e12")
        dense = simulate_config(s, {"CRAFT_TIER_EVERY": "node:1,pfs:1"},
                                seed=0, horizon_steps=400)
        sparse = simulate_config(s, {"CRAFT_TIER_EVERY": "node:64,pfs:64"},
                                 seed=0, horizon_steps=400)
        assert sparse.write_seconds < dense.write_seconds
        assert sparse.overhead_seconds < dense.overhead_seconds

    def test_failures_charge_rework_and_restores(self, tmp_path):
        s = self._summary(tmp_path)
        # force a failure-rich regime: mtbf of a few simulated steps
        s.failure_gaps = [20 * s.mean_step()]
        rep = simulate_config(s, {}, seed=1, horizon_steps=600)
        assert rep.failures > 0
        assert rep.rework_seconds > 0
        assert rep.restore_seconds > 0

    def test_tune_never_regresses_as_run(self, tmp_path):
        s = self._summary(tmp_path)
        result = tune(s, seed=0, horizon_steps=400)
        assert result["recommended"]["overhead_seconds"] <= \
            result["as_run"]["overhead_seconds"] + 1e-9
        block = recommend_env_block(result)
        assert block.startswith("# craft tune recommendation")

    def test_tune_cli_end_to_end(self, tmp_path, capsys):
        events, _ = _run_traced(tmp_path, n_iter=25,
                                CRAFT_TIER_EVERY="node:1,pfs:2")
        tpath = tmp_path / "run-trace.jsonl"
        out_json = tmp_path / "BENCH_tune.json"
        from repro_torch.tune import main as tune_main

        rc = tune_main(["--trace", str(tpath), "--json", str(out_json),
                        "--fail-on-regression"])
        assert rc == 0
        txt = capsys.readouterr().out
        assert "recommended" in txt and "export CRAFT_" in txt or \
            "already optimal" in txt
        records = json.loads(out_json.read_text())
        names = {r["name"] for r in records}
        assert {"as_run_overhead", "recommended_overhead",
                "improvement"} <= names
        for r in records:
            assert {"bench", "name", "value", "unit"} <= set(r)


# ---------------------------------------------------------------- sim pieces
class TestSimPieces:
    def test_fake_clock(self):
        c = FakeClock(5.0)
        assert c() == 5.0
        c.advance(2.5)
        assert c() == 7.5

    def test_sim_tier_is_cost_only(self):
        t = SimTier("pfs")
        assert t.write_cost() is None
        t.record_write(0.25, 100)
        assert t.write_cost() == 0.25
        with pytest.raises(NotImplementedError):
            t.stage(1)


# --------------------------------------------------------- across packages
_CHAOS = dict(CRAFT_TIER_EVERY="node:2,pfs:4", CRAFT_DELTA="1",
              CRAFT_CHAOS="node:eio:p=1+after=4+count=6",
              CRAFT_IO_RETRIES="0", CRAFT_BREAKER_THRESHOLD="2",
              CRAFT_BREAKER_COOLDOWN_S="0.05")


def _run_traced_by(which, tmp_path, n_iter=40, **extra):
    """One live run of ``which`` package with its tracer armed on a float32
    state; returns (events, stats)."""
    if which == "port":
        mk, Env, tr = Checkpoint, CraftEnv, trace_mod
    else:
        mk, Env, tr = ref_core.Checkpoint, ref_core.CraftEnv, ref_trace
    tpath = tmp_path / f"{which}-trace.jsonl"
    env = Env.capture({
        "CRAFT_CP_PATH": str(tmp_path / which / "pfs"),
        "CRAFT_NODE_CP_PATH": str(tmp_path / which / "node"),
        "CRAFT_IO_BACKOFF_MS": "1", "CRAFT_TRACE": str(tpath),
        **{k: str(v) for k, v in extra.items()}})
    arr = np.arange(4096, dtype=np.float32)
    cp = mk("traced", env=env)
    cp.add("arr", arr)
    cp.commit()
    cp.restart_if_needed()
    try:
        for it in range(n_iter):
            arr += 1.0
            if cp.need_checkpoint(it):
                cp.update_and_write(it)
        cp.wait()
    finally:
        cp.close()
        stats = dict(cp.stats)
        tr.uninstall()
    return load_trace(tpath), stats


@pytest.mark.parametrize("recorder", ["port", "ref"])
@pytest.mark.parametrize("extra", [dict(CRAFT_TIER_EVERY="node:2,pfs:5"),
                                   _CHAOS], ids=["clean", "chaos"])
def test_trace_replays_alike_in_both_packages(tmp_path, recorder, extra):
    events, stats = _run_traced_by(recorder, tmp_path, **extra)
    if extra is _CHAOS:
        assert stats["degraded_writes"] > 0
    assert ref_simulate.load_trace(
        tmp_path / f"{recorder}-trace.jsonl") == events
    mine, theirs = replay(events), ref_simulate.replay(events)
    for r in (mine, theirs):
        assert r.decisions_match, f"mismatches at {r.mismatches[:5]}"
        assert r.tier_landed["node"] == stats["node_writes"]
        assert r.tier_landed["pfs"] == stats["pfs_writes"]
    assert mine.sim_decisions == theirs.sim_decisions
    assert mine.tier_landed == theirs.tier_landed
    assert mine.tier_landed_bytes == theirs.tier_landed_bytes
    assert mine.full_writes == theirs.full_writes


@pytest.mark.parametrize("recorder", ["port", "ref"])
def test_simulate_and_tune_reports_equal_in_both_packages(tmp_path,
                                                          recorder):
    events, _ = _run_traced_by(recorder, tmp_path, n_iter=20, **_CHAOS)
    s, rs = summarize(events), ref_simulate.summarize(events)
    assert dataclasses.asdict(s) == dataclasses.asdict(rs)
    for ov in ({}, {"CRAFT_TIER_EVERY": "node:8,pfs:32"}):
        a = simulate_config(s, ov, seed=5, horizon_steps=300)
        b = ref_simulate.simulate_config(rs, ov, seed=5, horizon_steps=300)
        assert a.as_dict() == b.as_dict()
    mine = tune(s, seed=0, horizon_steps=300)
    theirs = ref_tune.tune(rs, seed=0, horizon_steps=300)
    assert mine == theirs
    assert recommend_env_block(mine) == ref_tune.recommend_env_block(theirs)
