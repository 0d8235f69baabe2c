#!/usr/bin/env python3
"""Run cells of the benchmark one after another, each in its own process,
and keep every run's result.

    python3 bench/tools/runs.py --out "$TMPDIR/set1.jsonl" \
        --run graphene-8192.lanczos:101:10:0 --run ...

Each ``--run`` is ``cell:seed:seconds:trace``.  A line of ``--out`` per
run: the command's exit code, its wall seconds, the result line, the
``bench-host`` line and the end of its standard error.  A summary line per
run goes to standard output, and per cell the median, the quartiles and
the spread (interquartile range over the median, as the bounds take it)
of every end-to-end metric.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def one(cell: str, seed: str, seconds: str, trace: str,
        timeout: float) -> dict:
    cmd = [sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
           cell, "--seed", seed, "--seconds", seconds, "--trace", trace]
    t0 = time.perf_counter()
    try:
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           timeout=timeout)
        rc, out, err = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as exc:
        rc, out, err = 124, exc.stdout or "", exc.stderr or ""
        out = out if isinstance(out, str) else out.decode(errors="replace")
        err = err if isinstance(err, str) else err.decode(errors="replace")
    rec = {"cell": cell, "seed": int(seed), "seconds": float(seconds),
           "trace": int(trace), "rc": rc,
           "wall_s": time.perf_counter() - t0, "stderr": err[-4000:]}
    lines = [ln for ln in out.splitlines() if ln.strip()]
    for ln in lines:
        if ln.startswith("bench-host: "):
            rec["host"] = json.loads(ln[len("bench-host: "):])
    if lines:
        try:
            rec["result"] = json.loads(lines[-1])
        except json.JSONDecodeError:
            rec["stdout_tail"] = out[-2000:]
    return rec


def spread(values):
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return {"median": q2, "q1": q1, "q3": q3,
            "spread": (q3 - q1) / abs(q2) if q2 else None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--run", action="append", default=[])
    ap.add_argument("--timeout", type=float, default=420.0)
    args = ap.parse_args()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    by_cell = {}
    with open(out, "a") as fh:
        for spec in args.run:
            rec = one(*spec.split(":"), timeout=args.timeout)
            fh.write(json.dumps(rec) + "\n")
            fh.flush()
            res = rec.get("result", {})
            mets = {k: v["value"] for k, v in res.get("metrics", {}).items()}
            checks = {k: v["value"] for k, v in res.get("checks", {}).items()}
            print(json.dumps({"run": spec, "rc": rec["rc"],
                              "wall_s": round(rec["wall_s"], 2),
                              "correct": res.get("correct"),
                              "metrics": mets, "checks": checks,
                              "device": res.get("device")}), flush=True)
            if rec["rc"] != 0 or not res:
                print(rec["stderr"][-1500:], flush=True)
            if not rec["trace"]:
                for k, v in mets.items():
                    by_cell.setdefault(rec["cell"], {}).setdefault(
                        k, []).append(v)
    for cell, mets in by_cell.items():
        print(json.dumps({"cell": cell, **{k: spread(v)
                                           for k, v in mets.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
