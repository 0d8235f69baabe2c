#!/usr/bin/env python3
"""What the program's spans say about one run of a cell, and what they
cost.

    python3 bench/tools/spans.py run --workload <cell> --seed <n> \
        --seconds <s> [--arm] [--trace 1] --out <file.json>
    python3 bench/tools/spans.py cost --out <file.json>

``run`` runs the cell once in this process, as ``bench/run.py`` does, and
keeps its result line.  Traced (``--trace 1``), it also writes what the
result line leaves out, with the program's spans of the window placed on
the card's clock by the offset the device trace's reduction used: each
span name's count, seconds and self seconds; the share of the window's
host-to-device and device-to-host copy seconds that fall inside
``craft::cp.h2d`` and ``craft::cp.d2h`` spans; the idle seconds of every
gap of 1 ms or more by the innermost span around it, the benchmark's and
the program's; and for a restore cell, the mean of
``craft::lanczos.open`` plus ``craft::cp.restart`` a restore beside the
runner's own restore times, and the mean of ``craft::cp.restore`` beside
``restore_tier_s``.  ``--arm`` arms the program's memory recorder for an
untraced run (what the recorder costs end to end).

``cost`` times a span on this host: the disarmed ``span`` and ``timed``,
and both with the memory recorder armed, in ns a span.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
GAP_NS = 1_000_000


def _inside(dev, spans, part, name):
    """(seconds of the device operations whose name holds ``part``, the
    share of them inside spans called ``name``)."""
    from bench.lib.devtrace import _merge

    iv = _merge([(s["start_ns"], s["end_ns"]) for s in spans
                 if s["name"] == name])
    total = inside = 0
    for n, s, e in dev:
        if part not in n:
            continue
        total += e - s
        for a, b in iv:
            if b <= s:
                continue
            if a >= e:
                break
            inside += min(b, e) - max(a, s)
    return total * 1e-9, (inside / total if total else None)


def _gaps(dev, window, spans):
    """Idle seconds of every gap of ``GAP_NS`` or more, by the innermost
    span around its middle, and the ten longest of them."""
    from bench.lib.devtrace import _merge

    w0, w1 = window
    merged = _merge([(max(s, w0), min(e, w1)) for _, s, e in dev
                     if min(e, w1) > max(s, w0)])
    by = defaultdict(float)
    longest = []
    prev = w0
    for s, e in merged + [(w1, w1)]:
        if s - prev >= GAP_NS:
            mid = (prev + s) // 2
            inner = [(b - a, n) for a, b, n in spans if a <= mid <= b]
            label = min(inner)[1] if inner else "between spans"
            by[label] += (s - prev) * 1e-9
            longest.append([label, (s - prev) * 1e-9])
        prev = max(prev, e)
    longest.sort(key=lambda g: -g[1])
    return dict(sorted(by.items(), key=lambda kv: -kv[1])), longest[:10]


def _by_name(spans):
    kids = defaultdict(float)
    for s in spans:
        if s["parent"] is not None:
            kids[s["parent"]] += s["end_ns"] - s["start_ns"]
    out = {}
    for s in spans:
        d = out.setdefault(s["name"], {"count": 0, "s": 0.0, "self_s": 0.0})
        dur = s["end_ns"] - s["start_ns"]
        d["count"] += 1
        d["s"] += dur * 1e-9
        d["self_s"] += (dur - kids.get(s["id"], 0)) * 1e-9
    return out


def run(args) -> dict:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import bench.run as bench_run
    from bench.lib import devtrace, harness
    from bench.lib import spans as sp

    kept = {}
    orig_reduce, orig_execute = devtrace.reduce_events, harness.execute
    orig_tracer_reduce = devtrace.Tracer.reduce

    def tracer_reduce(self):
        kept["tracer"] = self
        return orig_tracer_reduce(self)

    def reduce_events(dev, window, spans):
        kept["reduce"] = (dev, window, spans)
        return orig_reduce(dev, window, spans)

    def execute(ctx):
        if args.arm and not ctx.trace:
            from repro_torch.core import trace
            trace.install_memory()
            try:
                rec = orig_execute(ctx)
            finally:
                kept["armed"] = trace.drain()[1]
                trace.uninstall()
        else:
            rec = orig_execute(ctx)
        kept["rec"] = rec
        return rec

    devtrace.reduce_events, harness.execute = reduce_events, execute
    devtrace.Tracer.reduce = tracer_reduce
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench_run.main(["--workload", args.workload, "--seed",
                             str(args.seed), "--seconds", str(args.seconds),
                             "--trace", str(args.trace)])
    lines = [ln for ln in out.getvalue().splitlines() if ln.strip()]
    res = {"workload": args.workload, "seed": args.seed, "rc": rc,
           "trace": args.trace, "arm": bool(args.arm),
           "result": json.loads(lines[-1]) if rc == 0 else None}
    if "armed" in kept:
        res["armed_dropped"] = kept["armed"]
    rec = kept.get("rec")
    if rec is not None and "reduce" in kept:
        dev, window, bench_spans = kept["reduce"]
        # the card's clock less the host's, as the reduction placed the
        # benchmark's window by it
        off = window[0] - kept["tracer"].window_ns[0]
        spans = [dict(s, start_ns=s["start_ns"] + off,
                      end_ns=s["end_ns"] + off) for s in sp.program()
                 if window[0] <= s["start_ns"] + off
                 and s["end_ns"] + off <= window[1]]
        res["spans"] = _by_name(spans)
        h2d_s, h2d_in = _inside(dev, spans, "Memcpy HtoD", "craft::cp.h2d")
        d2h_s, d2h_in = _inside(dev, spans, "Memcpy DtoH", "craft::cp.d2h")
        res["copies"] = {"h2d_s": h2d_s, "h2d_inside_share": h2d_in,
                         "d2h_s": d2h_s, "d2h_inside_share": d2h_in}
        res["idle_by_span"], res["idle_longest"] = _gaps(
            dev, window, bench_spans + [(s["start_ns"], s["end_ns"],
                                         s["name"]) for s in spans])
        each = rec.notes.get("restore_each_s")
        if each:
            opens = [s for s in spans if s["name"] == "craft::lanczos.open"]
            rests = [s for s in spans if s["name"] == "craft::cp.restart"
                     and s["fields"].get("restored")]
            tier = [s for s in spans if s["name"] == "craft::cp.restore"]
            dur = lambda xs: [(s["end_ns"] - s["start_ns"]) * 1e-9  # noqa
                              for s in xs]
            res["add_up"] = {
                "restores": len(rests), "runner_restores": len(each),
                "open_plus_restart_mean_s": (sum(dur(opens)) + sum(
                    dur(rests))) / max(1, len(rests)),
                "restore_each_mean_s": statistics.fmean(each),
                "cp_restore_mean_s": statistics.fmean(dur(tier))
                if tier else None,
                "restore_tier_s": rec.program.get("restore_seconds_mean")}
    return res


def cost(args) -> dict:
    sys.path[:0] = [str(ROOT / "src")]
    from repro_torch.core import trace

    n = args.n

    def per_span(kind):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with getattr(trace.TRACER, kind)("craft::lanczos.read"):
                pass
        return (time.perf_counter_ns() - t0) / n

    def empty():
        t0 = time.perf_counter_ns()
        for _ in range(n):
            pass
        return (time.perf_counter_ns() - t0) / n

    out = {"n": n, "loop_ns": empty()}
    trace.uninstall()
    out["off_span_ns"], out["off_timed_ns"] = per_span("span"), \
        per_span("timed")
    trace.install_memory(cap=4 * n)
    out["armed_span_ns"] = per_span("span")
    out["armed_timed_ns"] = per_span("timed")
    out["armed_dropped"] = trace.drain()[1]
    trace.uninstall()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="what", required=True)
    r = sub.add_parser("run")
    r.add_argument("--workload", required=True)
    r.add_argument("--seed", type=int, required=True)
    r.add_argument("--seconds", type=float, required=True)
    r.add_argument("--trace", type=int, choices=(0, 1), default=0)
    r.add_argument("--arm", action="store_true")
    r.add_argument("--out", required=True)
    c = sub.add_parser("cost")
    c.add_argument("--n", type=int, default=200_000)
    c.add_argument("--out", required=True)
    args = ap.parse_args()
    res = run(args) if args.what == "run" else cost(args)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, default=str))
    brief = {k: v for k, v in res.items() if k not in ("spans",)}
    print(json.dumps(brief, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
