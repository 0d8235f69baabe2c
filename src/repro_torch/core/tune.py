"""``craft tune`` — coordinate-descent policy auto-tuning over a recorded
trace (the *tune* third of the record → replay → tune loop).

Given a trace recorded with ``CRAFT_TRACE`` (``core/trace.py``), distill it
into empirical distributions (``core/simulate.summarize``) and search the
scheduling knobs for the config with the lowest *expected overhead* —
simulated write + rework-after-failure + restore seconds
(``core/simulate.simulate_config``).

Search space (each dimension only when the recorded config makes it live):

* per-slot ``CRAFT_TIER_EVERY`` opportunity counts, every chained slot;
* ``CRAFT_RS_PARITY`` when the node tier runs Reed-Solomon redundancy;
* ``CRAFT_MEM_REPLICAS`` when the RAM tier is chained;
* ``CRAFT_DELTA_MAX_CHAIN`` when the delta codec is on.

The descent starts **from the as-run config** and only ever moves to a
strictly better score, so the recommendation can never regress the
simulated as-run overhead — that invariant is what the CI ``tune-smoke``
job (``--fail-on-regression``) re-checks end to end.

Everything here is deterministic: same trace + same seed ⇒ same
recommendation (``tests/test_torch_property.py`` pins it).

CLI: ``python -m repro_torch.tune --trace run.jsonl [--json BENCH_tune.json]``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.core.env import CraftEnv
from repro_torch.core.simulate import (
    SimReport, TraceSummary, simulate_config, summarize,
)

__all__ = ["tune", "recommend_env_block", "tune_trace"]

#: Candidate per-slot opportunity counts (powers of two: the overhead curve
#: is flat near Daly's optimum, so a ×2 grid brackets it within ~¼ of the
#: achievable improvement at a fraction of the evaluations).
COUNT_GRID = (1, 2, 4, 8, 16, 32, 64, 128, 256)
RS_PARITY_GRID = (1, 2, 3)
MEM_REPLICAS_GRID = (1, 2, 3)
DELTA_CHAIN_GRID = (1, 2, 4, 8, 16)
MAX_SWEEPS = 4


def _tier_every_string(counts: Dict[str, int]) -> str:
    return ",".join(f"{slot}:{n}" for slot, n in counts.items())


def _as_run_counts(env: CraftEnv, summary: TraceSummary) -> Dict[str, int]:
    """The recorded config's effective per-slot counts — the descent's
    starting point.  ``auto`` (Daly) slots start from the count nearest
    their recorded interval; legacy slots from their modulo equivalents."""
    step = max(1e-9, summary.mean_step())
    counts: Dict[str, int] = {}
    for slot in env.tier_chain:
        spec = env.tier_every_for(slot)
        if isinstance(spec, int):
            counts[slot] = max(1, spec)
        elif spec == "auto":
            # seed from the recorded write rate: observed writes per slot
            # over the trace span, converted to an opportunity count
            cost = summary.tier_full_cost.get(slot) \
                or summary.tier_delta_cost.get(slot)
            if cost:
                from repro_torch.core.scheduler import daly_interval
                interval = daly_interval(cost, summary.mtbf())
                counts[slot] = max(1, min(COUNT_GRID[-1],
                                          int(round(interval / step))))
            else:
                counts[slot] = 1
        else:   # legacy: every version, except PFS behind a node tier
            if slot == "pfs" and "node" in env.tier_chain \
                    and env.pfs_every > 1:
                counts[slot] = env.pfs_every
            else:
                counts[slot] = 1
    return counts


def _dimensions(env: CraftEnv, counts: Dict[str, int]) -> List[Tuple]:
    """[(key, slot_or_None, candidate values)] — the coordinate axes."""
    dims: List[Tuple] = []
    for slot in env.tier_chain:
        grid = sorted(set(COUNT_GRID) | {counts[slot]})
        dims.append(("CRAFT_TIER_EVERY", slot, tuple(grid)))
    if "node" in env.tier_chain and env.node_redundancy.upper() == "RS":
        grid = sorted(set(RS_PARITY_GRID) | {env.rs_parity})
        dims.append(("CRAFT_RS_PARITY", None, tuple(grid)))
    if "mem" in env.tier_chain:
        grid = sorted(set(MEM_REPLICAS_GRID) | {env.mem_replicas})
        dims.append(("CRAFT_MEM_REPLICAS", None, tuple(grid)))
    if env.delta:
        grid = sorted(set(DELTA_CHAIN_GRID) | {env.delta_max_chain})
        dims.append(("CRAFT_DELTA_MAX_CHAIN", None, tuple(grid)))
    return dims


def _overrides(counts: Dict[str, int], scalars: Dict[str, int]) -> dict:
    out = {"CRAFT_TIER_EVERY": _tier_every_string(counts)}
    out.update({k: str(v) for k, v in scalars.items()})
    return out


def tune(summary: TraceSummary, *, seed: int = 0,
         horizon_steps: Optional[int] = None,
         max_sweeps: int = MAX_SWEEPS) -> dict:
    """Coordinate descent from the as-run config; returns the scorecard.

    ``{"as_run": {...}, "recommended": {...}, "improvement_pct": float,
    "evaluations": int, "sweeps": int}`` where each side carries its
    simulated :class:`SimReport` dict and its ``CRAFT_*`` override map.
    """
    env = CraftEnv.capture({"CRAFT_CP_PATH": "/unused",
                            **summary.config_env})
    counts = _as_run_counts(env, summary)
    scalars = {}
    dims = _dimensions(env, counts)
    for key, _slot, _grid in dims:
        if key == "CRAFT_RS_PARITY":
            scalars[key] = env.rs_parity
        elif key == "CRAFT_MEM_REPLICAS":
            scalars[key] = env.mem_replicas
        elif key == "CRAFT_DELTA_MAX_CHAIN":
            scalars[key] = env.delta_max_chain

    evaluations = 0
    cache: Dict[Tuple, SimReport] = {}

    def score(counts_: Dict[str, int], scalars_: Dict[str, int]) -> SimReport:
        nonlocal evaluations
        key = (tuple(sorted(counts_.items())),
               tuple(sorted(scalars_.items())))
        hit = cache.get(key)
        if hit is not None:
            return hit
        evaluations += 1
        rep = simulate_config(summary, _overrides(counts_, scalars_),
                              seed=seed, horizon_steps=horizon_steps)
        cache[key] = rep
        return rep

    # the as-run score: the recorded config simulated under the same model
    # and seed — the yardstick the recommendation must never regress
    as_run = simulate_config(summary, {}, seed=seed,
                             horizon_steps=horizon_steps)
    best = score(counts, scalars)
    if as_run.overhead_seconds < best.overhead_seconds:
        # the count-normalized start scored worse than the literal as-run
        # config (auto-slot seeding is approximate): keep the literal one
        # as the floor; the descent must beat it to recommend anything
        best = as_run
    sweeps = 0
    for sweep in range(max_sweeps):
        improved = False
        for key, slot, grid in dims:
            for value in grid:
                if key == "CRAFT_TIER_EVERY":
                    if counts[slot] == value:
                        continue
                    trial_counts = {**counts, slot: value}
                    trial_scalars = dict(scalars)
                else:
                    if scalars.get(key) == value:
                        continue
                    trial_counts = dict(counts)
                    trial_scalars = {**scalars, key: value}
                rep = score(trial_counts, trial_scalars)
                if rep.overhead_seconds < best.overhead_seconds:
                    best = rep
                    counts, scalars = trial_counts, trial_scalars
                    improved = True
        sweeps = sweep + 1
        if not improved:
            break

    recommended = best
    rec_overrides = dict(recommended.overrides)
    improvement = 0.0
    if as_run.overhead_seconds > 0:
        improvement = 100.0 * (as_run.overhead_seconds
                               - recommended.overhead_seconds) \
            / as_run.overhead_seconds
    return {
        "as_run": {"overrides": {}, **as_run.as_dict()},
        "recommended": {**recommended.as_dict(),
                        "overrides": rec_overrides},
        "improvement_pct": round(improvement, 3),
        "evaluations": evaluations,
        "sweeps": sweeps,
        "seed": seed,
        "mtbf_seconds": round(summary.mtbf(), 3),
        "mean_step_seconds": round(summary.mean_step(), 6),
    }


def recommend_env_block(result: dict) -> str:
    """The recommendation as a paste-ready shell env block."""
    lines = ["# craft tune recommendation "
             f"(simulated overhead {result['recommended']['overhead_seconds']}s"
             f" vs as-run {result['as_run']['overhead_seconds']}s, "
             f"{result['improvement_pct']}% better)"]
    overrides = result["recommended"]["overrides"]
    if not overrides:
        lines.append("# as-run config already optimal under the model — "
                     "no changes recommended")
    for key in sorted(overrides):
        lines.append(f"export {key}={overrides[key]}")
    return "\n".join(lines)


def tune_trace(path, *, seed: int = 0,
               horizon_steps: Optional[int] = None) -> dict:
    """Convenience: trace file → scorecard (what the CLI calls)."""
    from repro_torch.core.simulate import load_trace

    return tune(summarize(load_trace(path)), seed=seed,
                horizon_steps=horizon_steps)
