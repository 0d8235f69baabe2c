"""Deterministic trace replay + what-if simulation — the *replay* third of
the record → replay → tune loop (``core/trace.py`` records, ``core/tune.py``
searches).

Two modes, both driving the **real** :class:`~repro_torch.core.scheduler.
CheckpointPolicy` (never a re-implementation of its rules — a fork would
drift the first time the scheduler learns a trick the simulator doesn't):

* :func:`replay` — **exact replay**: walk a recorded trace in order, set a
  fake clock to each event's recorded timestamp, feed the policy the exact
  inputs the live run saw (iteration, ``cp_freq``, writer backpressure,
  landed tier writes, degraded routings, restores, recovery resets) and
  re-derive every decision.  Because count cadences and the recorded-input
  reconstruction are fully deterministic, the simulated decision sequence
  must equal the recorded one bit for bit — ``tests/test_torch_simulate.py``
  asserts exactly that against a live chaos run.

* :func:`simulate_config` — **what-if**: summarize the trace into empirical
  distributions (step durations, per-tier full/delta write costs, restore
  cost, failure inter-arrivals) and run a seeded discrete-event loop over a
  *candidate* config, reporting expected overhead
  ``write + rework-after-failure + restore``.  No wall clock, no global
  RNG: same trace + same seed + same config ⇒ identical report
  (``tests/test_torch_property.py`` holds the line).

Cost scaling for configs the trace never ran: redundancy knobs scale the
measured per-tier costs analytically — Reed-Solomon parity ``m`` over ``k``
data shards amplifies writes by ``(k+m)/k``, ``R`` RAM replicas by
``1+R``, and a delta chain of depth ``D`` pays one full write per ``D``
versions (``(full + (D-1)·delta)/D``).  Everything else (cadences,
intervals) goes through the real policy.
"""
from __future__ import annotations

import dataclasses
import json
import math
import random
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from repro_torch.core.env import CraftEnv
from repro_torch.core.scheduler import (
    DEFAULT_MTBF_SECONDS, CheckpointPolicy, Decision,
)
from repro_torch.core.tiers import StorageTier

__all__ = [
    "load_trace", "summarize", "replay", "simulate_config",
    "TraceSummary", "ReplayReport", "SimReport", "FakeClock", "SimTier",
]


def load_trace(path) -> List[dict]:
    """Parse a JSONL trace; skips blank and torn (truncated) lines — a
    killed run's last line may be partial, which is normal, not an error."""
    events = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                continue          # torn tail line from a killed writer
            if isinstance(ev, dict) and "kind" in ev:
                events.append(ev)
    return events


class FakeClock:
    """Injectable monotonic clock: ``clock()`` returns ``t``; the replayer
    pins it to recorded timestamps, the what-if loop advances it."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class SimTier(StorageTier):
    """Cost-model-only tier: the policy reads ``write_cost()`` off the base
    class; nothing here ever touches a filesystem."""

    def __init__(self, slot: str):
        self.label = slot

    def stage(self, version):
        raise NotImplementedError("SimTier carries costs, not data")

    def publish(self, staged, version, extra_meta=None):
        raise NotImplementedError

    def abort(self, staged):
        raise NotImplementedError

    def latest_version(self) -> int:
        return 0

    def version_dir(self, version):
        return Path("/nonexistent") / f"v-{version}"

    def invalidate_all(self) -> None:
        pass


# ---------------------------------------------------------------------------
# exact replay
# ---------------------------------------------------------------------------
_DECISION_FIELDS = ("write", "tiers", "full", "sync", "final", "reason")


def _normalize(d) -> Tuple:
    """A Decision (or a recorded decision event) as a comparable tuple."""
    if isinstance(d, Decision):
        return (d.write, tuple(d.tiers), d.full, d.sync, d.final, d.reason)
    return (bool(d.get("write")), tuple(d.get("tiers") or ()),
            bool(d.get("full")), bool(d.get("sync")), bool(d.get("final")),
            str(d.get("reason", "")))


@dataclasses.dataclass
class ReplayReport:
    """Exact-replay outcome: the re-derived decision sequence next to the
    recorded one, plus the policy-side write accounting the live
    ``Checkpoint.stats`` must agree with."""

    sim_decisions: List[Tuple]
    recorded_decisions: List[Tuple]
    mismatches: List[int]                 # indices where the two differ
    scheduled_writes: int                 # write=True decisions re-derived
    tier_scheduled: Dict[str, int]        # slot -> scheduled (pre-fault)
    tier_landed: Dict[str, int]           # slot -> landed (from the trace)
    tier_landed_bytes: Dict[str, int]
    full_writes: int                      # re-derived full (non-delta) writes
    config_env: Dict[str, str]

    @property
    def decisions_match(self) -> bool:
        return (not self.mismatches
                and len(self.sim_decisions) == len(self.recorded_decisions))


def replay(events: List[dict],
           env_overrides: Optional[dict] = None) -> ReplayReport:
    """Re-derive every recorded decision through a fresh, real policy.

    External inputs (what the world did) come from the trace; internal
    state (what the policy decides) is recomputed.  ``env_overrides``
    patches the recorded config snapshot — with overrides the decision
    sequences legitimately diverge; without them they must match.
    """
    cfg = next((e for e in events if e["kind"] == "config"), None)
    if cfg is None:
        raise ValueError("trace has no config event — nothing to replay")
    envmap = {"CRAFT_CP_PATH": "/unused", **cfg["env"],
              **(env_overrides or {})}
    env = CraftEnv.capture(envmap)
    clock = FakeClock(float(cfg.get("t", 0.0)))
    stores = {slot: SimTier(slot) for slot in env.tier_chain}
    pending = [0]
    policy = CheckpointPolicy(env, stores, clock=clock,
                              backpressure=lambda: pending[0])
    sim: List[Tuple] = []
    rec: List[Tuple] = []
    mismatches: List[int] = []
    tier_scheduled: Dict[str, int] = {s: 0 for s in env.tier_chain}
    tier_landed: Dict[str, int] = {s: 0 for s in env.tier_chain}
    tier_landed_bytes: Dict[str, int] = {s: 0 for s in env.tier_chain}
    full_writes = 0
    last_write_decision: Optional[Decision] = None

    for ev in events:
        kind = ev["kind"]
        clock.t = float(ev.get("t", clock.t))
        if kind == "decision":
            pending[0] = int(ev.get("pending", 0))
            d = policy.need_checkpoint(
                ev.get("it"), int(ev.get("cp_freq", 1)),
                next_version=int(ev.get("next_version", 1)))
            sim.append(_normalize(d))
            rec.append(_normalize(ev))
            if sim[-1] != rec[-1]:
                mismatches.append(len(sim) - 1)
            if d.write:
                last_write_decision = d
                for slot in d.tiers:
                    tier_scheduled[slot] = tier_scheduled.get(slot, 0) + 1
                if d.full:
                    full_writes += 1
        elif kind == "scheduled":
            d = last_write_decision
            if d is None or not d.write:
                # replay diverged (overrides) — reconstruct from the record
                d = Decision(write=True, tiers=tuple(ev.get("tiers", ())),
                             reason=str(ev.get("reason", "")))
            policy.record_written(d, int(ev["version"]))
            last_write_decision = None
        elif kind == "step":
            policy.observe_step_seconds(float(ev["seconds"]))
        elif kind == "tier_write":
            slot = ev["slot"]
            store = stores.get(slot)
            if store is not None:
                store.record_write(float(ev.get("seconds", 0.0)),
                                   int(ev.get("nbytes", 0)))
            policy.note_tier_written(slot)
            tier_landed[slot] = tier_landed.get(slot, 0) + 1
            tier_landed_bytes[slot] = (
                tier_landed_bytes.get(slot, 0) + int(ev.get("nbytes", 0)))
        elif kind == "degraded":
            policy.note_degraded(ev["slot"])
        elif kind == "restore":
            policy.notify_restore()
        elif kind == "recovery":
            policy.reset_estimators()
        # config (first consumed above), breaker/failure/kill (and
        # the reference's tier_cost and retune): no policy-side input

    return ReplayReport(
        sim_decisions=sim, recorded_decisions=rec, mismatches=mismatches,
        scheduled_writes=sum(1 for d in sim if d[0]),
        tier_scheduled=tier_scheduled, tier_landed=tier_landed,
        tier_landed_bytes=tier_landed_bytes, full_writes=full_writes,
        config_env=dict(cfg["env"]),
    )


# ---------------------------------------------------------------------------
# trace summary (the what-if simulator's empirical inputs)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TraceSummary:
    """Empirical distributions distilled from one trace."""

    config_env: Dict[str, str]
    payload_bytes: int
    comm_size: int
    steps: List[float]                    # observed step durations (seconds)
    tier_full_cost: Dict[str, float]      # slot -> mean full-write seconds
    tier_delta_cost: Dict[str, float]     # slot -> mean delta-write seconds
    tier_write_bytes: Dict[str, float]    # slot -> mean logical bytes
    restore_seconds: Optional[float]      # mean restore latency (None: none)
    failure_gaps: List[float]             # inter-arrival seconds of failures
    duration: float                       # trace wall span (seconds)
    n_decisions: int

    def mtbf(self) -> float:
        """Empirical MTBF from the failure stream, else the configured
        ``CRAFT_MTBF_SECONDS``, else the scheduler's 1-day default."""
        if self.failure_gaps:
            return max(1e-6, sum(self.failure_gaps) / len(self.failure_gaps))
        cfg = float(self.config_env.get("CRAFT_MTBF_SECONDS", "0") or 0)
        if cfg > 0:
            return cfg
        return DEFAULT_MTBF_SECONDS

    def mean_step(self) -> float:
        if self.steps:
            return sum(self.steps) / len(self.steps)
        if self.n_decisions > 0 and self.duration > 0:
            return self.duration / self.n_decisions
        return 1.0


def _mean(xs: List[float]) -> Optional[float]:
    return sum(xs) / len(xs) if xs else None


def summarize(events: List[dict]) -> TraceSummary:
    cfg = next((e for e in events if e["kind"] == "config"), None)
    if cfg is None:
        raise ValueError("trace has no config event — nothing to summarize")
    steps: List[float] = []
    gap_steps: List[float] = []     # fallback when no step events exist
    full_costs: Dict[str, List[float]] = {}
    delta_costs: Dict[str, List[float]] = {}
    wbytes: Dict[str, List[float]] = {}
    restores: List[float] = []
    fail_ts: List[float] = []
    n_decisions = 0
    t_min = t_max = float(cfg.get("t", 0.0))
    prev_decision_t: Optional[float] = None
    prev_decision_it = object()
    for ev in events:
        t = float(ev.get("t", 0.0))
        t_min, t_max = min(t_min, t), max(t_max, t)
        kind = ev["kind"]
        if kind == "step":
            steps.append(float(ev["seconds"]))
        elif kind == "decision":
            n_decisions += 1
            it = ev.get("it")
            if prev_decision_t is not None and it != prev_decision_it:
                gap = t - prev_decision_t
                if gap > 0:
                    gap_steps.append(gap)
            prev_decision_t, prev_decision_it = t, it
        elif kind == "tier_write":
            slot = ev["slot"]
            bucket = full_costs if ev.get("full") else delta_costs
            bucket.setdefault(slot, []).append(float(ev.get("seconds", 0.0)))
            wbytes.setdefault(slot, []).append(float(ev.get("nbytes", 0)))
        elif kind == "restore":
            restores.append(float(ev.get("seconds", 0.0)))
        elif kind in ("failure", "kill"):
            fail_ts.append(t)
    # a tier that only ever wrote one flavor still needs both cost models:
    # borrow the observed flavor (delta ≈ full is conservative for tuning)
    slots = set(full_costs) | set(delta_costs)
    tier_full = {}
    tier_delta = {}
    for slot in slots:
        f = _mean(full_costs.get(slot, []))
        d = _mean(delta_costs.get(slot, []))
        tier_full[slot] = f if f is not None else d
        tier_delta[slot] = d if d is not None else f
    gaps = [b - a for a, b in zip(fail_ts, fail_ts[1:]) if b > a]
    if fail_ts and not gaps and t_max > fail_ts[0]:
        gaps = [max(1e-6, t_max - t_min)]     # one failure over the span
    return TraceSummary(
        config_env=dict(cfg["env"]),
        payload_bytes=int(cfg.get("payload_bytes", 0)),
        comm_size=int(cfg.get("comm_size", 1)),
        steps=steps or gap_steps,
        tier_full_cost=tier_full,
        tier_delta_cost=tier_delta,
        tier_write_bytes={s: _mean(v) or 0.0 for s, v in wbytes.items()},
        restore_seconds=_mean(restores),
        failure_gaps=gaps,
        duration=max(0.0, t_max - t_min),
        n_decisions=n_decisions,
    )


# ---------------------------------------------------------------------------
# what-if simulation
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SimReport:
    """Expected-overhead scorecard for one candidate config."""

    overrides: Dict[str, str]             # CRAFT_* patches vs the trace
    horizon_steps: int
    seed: int
    useful_seconds: float                 # pure compute simulated
    write_seconds: float
    rework_seconds: float                 # lost compute re-done after failures
    restore_seconds: float
    failures: int
    writes: int
    tier_writes: Dict[str, int]

    @property
    def overhead_seconds(self) -> float:
        return self.write_seconds + self.rework_seconds + self.restore_seconds

    @property
    def overhead_fraction(self) -> float:
        return self.overhead_seconds / max(1e-9, self.useful_seconds)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["overhead_seconds"] = round(self.overhead_seconds, 6)
        d["overhead_fraction"] = round(self.overhead_fraction, 6)
        return d


def _cost_scale(env: CraftEnv, base: CraftEnv, slot: str) -> float:
    """Analytic write-cost scale for redundancy knobs vs the as-run config."""
    scale = 1.0
    if slot == "mem":
        scale *= (1.0 + env.mem_replicas) / (1.0 + base.mem_replicas)
    elif slot == "node" and base.node_redundancy.upper() == "RS":
        k = max(1, base.xor_group_size)
        scale *= (k + env.rs_parity) / (k + max(0, base.rs_parity))
    return scale


def simulate_config(summary: TraceSummary,
                    overrides: Optional[dict] = None,
                    *,
                    seed: int = 0,
                    horizon_steps: Optional[int] = None) -> SimReport:
    """Expected overhead of ``overrides`` applied to the recorded config.

    A seeded discrete-event loop drives the real policy step by step on a
    fake clock: compute a step, ask ``need_checkpoint``, pay the modeled
    per-tier write cost for every scheduled tier, and on each sampled
    failure pay the rework (compute since the last completed checkpoint)
    plus a restore.  Deterministic by construction — the only randomness is
    ``random.Random(seed)`` driving the failure inter-arrivals.
    """
    overrides = dict(overrides or {})
    base_env = CraftEnv.capture(
        {"CRAFT_CP_PATH": "/unused", **summary.config_env})
    env = CraftEnv.capture(
        {"CRAFT_CP_PATH": "/unused", **summary.config_env, **overrides})
    if horizon_steps is None:
        horizon_steps = max(1000, 2 * len(summary.steps))
    steps = summary.steps or [summary.mean_step()]
    mtbf = summary.mtbf()

    delta_on = env.delta
    depth = max(1, env.delta_max_chain)

    def tier_cost(slot: str, full: bool) -> float:
        f = summary.tier_full_cost.get(slot)
        d = summary.tier_delta_cost.get(slot)
        if f is None and d is None:
            # never observed (e.g. a breaker kept it dark): model it from
            # the payload at a conservative 200 MB/s, floored at 1 ms
            f = d = max(1e-3, summary.payload_bytes / 200e6)
        scale = _cost_scale(env, base_env, slot)
        if full or not delta_on or slot == "mem":
            return (f if f is not None else d) * scale
        # a depth-D chain pays one full write per D versions on average
        return ((f + (depth - 1) * d) / depth) * scale

    clock = FakeClock(0.0)
    stores = {slot: SimTier(slot) for slot in env.tier_chain}
    policy = CheckpointPolicy(env, stores, clock=clock)
    rng = random.Random(seed)
    t_fail = (rng.expovariate(1.0 / mtbf)
              if math.isfinite(mtbf) and mtbf > 0 else math.inf)
    useful = 0.0
    write_total = 0.0
    rework_total = 0.0
    restore_total = 0.0
    failures = 0
    writes = 0
    version = 0
    tier_writes: Dict[str, int] = {s: 0 for s in env.tier_chain}
    last_cp_t = 0.0     # sim time the last checkpoint finished landing
    restore_cost = summary.restore_seconds
    if restore_cost is None:
        deepest = env.tier_chain[-1] if env.tier_chain else "pfs"
        restore_cost = tier_cost(deepest, True)

    for it in range(horizon_steps):
        s = steps[it % len(steps)]
        clock.advance(s)
        useful += s
        policy.observe_step_seconds(s)
        d = policy.need_checkpoint(it, next_version=version + 1)
        if d.write:
            version += 1
            writes += 1
            cost = 0.0
            for slot in d.tiers:
                c = tier_cost(slot, d.full)
                cost += c
                stores[slot].record_write(c, summary.payload_bytes)
                policy.note_tier_written(slot)
                tier_writes[slot] = tier_writes.get(slot, 0) + 1
            clock.advance(cost)
            write_total += cost
            policy.record_written(d, version)
            last_cp_t = clock.t
        if clock.t >= t_fail:
            failures += 1
            # everything since the last completed checkpoint is redone —
            # a run with no checkpoint yet loses everything from t=0
            lost = clock.t - (last_cp_t if version > 0 else 0.0)
            rework_total += max(0.0, lost)
            restore_total += restore_cost
            clock.advance(restore_cost)
            policy.reset_estimators()
            policy.notify_restore()
            last_cp_t = clock.t
            t_fail = clock.t + rng.expovariate(1.0 / mtbf)
    # an uncheckpointed tail is exposed work; charge its expected loss so a
    # "never checkpoint" config cannot score 0 overhead on short horizons
    if math.isfinite(mtbf):
        tail = clock.t - (last_cp_t if version > 0 else 0.0)
        exposure = 1.0 - math.exp(-max(0.0, tail) / mtbf)
        rework_total += max(0.0, tail) * exposure * 0.5
    return SimReport(
        overrides={k: str(v) for k, v in overrides.items()},
        horizon_steps=horizon_steps, seed=seed,
        useful_seconds=useful, write_seconds=write_total,
        rework_seconds=rework_total, restore_seconds=restore_total,
        failures=failures, writes=writes, tier_writes=tier_writes,
    )
