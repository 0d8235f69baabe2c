#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, on the card it is started on.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

It sets up the cell (load, build, warm up the cell's own shapes), measures
for ``--seconds``, checks what the timed path produced against the plain
reference, and prints one JSON line last on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` and, traced,
``breakdown``, then ``checks``: each number compared beside its limit,
which also ends standard error.  An earlier line gives the bytes the run
wrote, its peak host memory and the card's name and power limit.

It exits non-zero without a result when there is no card (or fewer than
the cell asks for), when the program (``src/repro_torch``) is not beside
it, and when JAX, flax or the JAX package is loaded once the window has
closed.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir() \
            or not (ROOT / "BENCHMARK.json").is_file():
        print(f"bench: no program at {ROOT / 'src' / 'repro_torch'} "
              "(or no BENCHMARK.json): nothing to measure", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    from bench.lib import harness, host, paths, spec
    from bench.lib.record import Ctx

    paths.set_build_caches()
    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"bench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    io0 = host.io_bytes()
    work = paths.workdir(cell.name)
    try:
        rec = harness.execute(Ctx(cell=cell, seed=args.seed,
                                  seconds=args.seconds,
                                  trace=bool(args.trace), device="cuda",
                                  workdir=str(work), t0=T0))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    found = harness.foreign_modules()
    if found:
        print(f"bench: the process holds {', '.join(found)} after the "
              "window: the measured program must not load them",
              file=sys.stderr)
        return 4
    io1 = host.io_bytes()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips}
    line = harness.result(cell, rec, bool(args.trace), device)
    print("bench-host: " + json.dumps({
        "write_bytes": io1.get("write_bytes", 0) - io0.get("write_bytes", 0),
        "wchar": io1.get("wchar", 0) - io0.get("wchar", 0),
        "peak_rss_bytes": host.peak_rss_bytes(),
        "memory_peak_bytes": rec.memory_peak_bytes,
        "card": host.card(), "setup_s": rec.setup_s,
        "window_s": rec.window_s, "notes": rec.notes}, default=str),
        flush=True)
    for c in rec.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
