"""``python -m repro_torch.tune`` — the ``craft tune`` CLI.

Record a run with ``CRAFT_TRACE=run.jsonl``, then::

    python -m repro_torch.tune --trace run.jsonl --json BENCH_tune.json

prints the recommended ``CRAFT_*`` env block and writes a scorecard
artifact in the shared ``BENCH_*.json`` record shape (``benchmarks/
common.py``).  ``--fail-on-regression`` exits non-zero if the recommended
config's simulated overhead exceeds the as-run config's — the CI
``tune-smoke`` job's end-to-end invariant.  See ``docs/tuning.md``.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.core.simulate import load_trace, summarize
from repro_torch.core.tune import recommend_env_block, tune


def _records(result: dict) -> list:
    """The scorecard as BENCH_*.json records (bench/name/value/unit rows)."""
    rows = []

    def emit(name, value, unit, **extra):
        rows.append({"bench": "craft_tune", "name": name, "value": value,
                     "unit": unit, **extra})

    for side in ("as_run", "recommended"):
        rep = result[side]
        emit(f"{side}_overhead", rep["overhead_seconds"], "s",
             config=rep["overrides"] or "as-run")
        emit(f"{side}_overhead_fraction", rep["overhead_fraction"], "ratio")
        emit(f"{side}_writes", rep["writes"], "count")
        emit(f"{side}_failures", rep["failures"], "count")
    emit("improvement", result["improvement_pct"], "%")
    emit("evaluations", result["evaluations"], "count")
    emit("mtbf", result["mtbf_seconds"], "s")
    emit("mean_step", result["mean_step_seconds"], "s")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tune",
        description="Auto-tune CRAFT checkpoint policy knobs from a "
                    "CRAFT_TRACE recording.")
    ap.add_argument("--trace", required=True,
                    help="JSONL trace recorded with CRAFT_TRACE=<path>")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="write the scorecard as BENCH-style JSON records")
    ap.add_argument("--seed", type=int, default=0,
                    help="failure-stream seed (default 0; deterministic)")
    ap.add_argument("--horizon", type=int, default=None,
                    help="simulated steps per candidate (default: "
                         "max(1000, 2x recorded))")
    ap.add_argument("--fail-on-regression", action="store_true",
                    help="exit 1 if the recommendation scores worse than "
                         "the as-run config")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the human-readable report")
    args = ap.parse_args(argv)

    events = load_trace(args.trace)
    summary = summarize(events)
    result = tune(summary, seed=args.seed, horizon_steps=args.horizon)

    if not args.quiet:
        rec, base = result["recommended"], result["as_run"]
        print(f"trace: {args.trace} ({len(events)} events, "
              f"mtbf {result['mtbf_seconds']}s, "
              f"step {result['mean_step_seconds']}s)")
        print(f"as-run     : overhead {base['overhead_seconds']}s "
              f"({100 * base['overhead_fraction']:.2f}% of compute), "
              f"{base['writes']} writes, {base['failures']} failures")
        print(f"recommended: overhead {rec['overhead_seconds']}s "
              f"({100 * rec['overhead_fraction']:.2f}% of compute), "
              f"{rec['writes']} writes, {rec['failures']} failures")
        print(f"improvement: {result['improvement_pct']}% "
              f"({result['evaluations']} configs simulated)")
        print()
        print(recommend_env_block(result))

    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump(_records(result), fh, indent=1)
        if not args.quiet:
            print(f"\nwrote scorecard to {args.json_out}")

    if args.fail_on_regression and (
            result["recommended"]["overhead_seconds"]
            > result["as_run"]["overhead_seconds"] + 1e-9):
        print("REGRESSION: recommended config scores worse than as-run",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
