"""One run of one cell: the runner its traffic names, then the metrics of
the cell read from the run's record, and the result line."""
from __future__ import annotations

import sys
from typing import Dict, Optional

from bench.lib import spec
from bench.lib.record import Ctx, Record

#: top-level module names the process may not hold once the window closed
FOREIGN = ("jax", "jaxlib", "flax", "repro")


def execute(ctx: Ctx) -> Record:
    return spec.runner(ctx.cell.traffic["kind"]).run(ctx)


def end_to_end(cell: spec.Cell, rec: Record) -> Dict[str, dict]:
    out = {}
    for m in cell.end_to_end:
        value = rec.setup_s if m["name"] == "setup_s" else \
            rec.e2e.get(m["name"])
        if value is None:
            raise KeyError(f"{cell.name}: the run measured no "
                           f"{m['name']}")
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def per_layer(cell: spec.Cell, rec: Record) -> Dict[str, dict]:
    out = {}
    for m in cell.per_layer:
        value = spec.reader(m["name"]).read(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def foreign_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of :data:`FOREIGN`,
    compared whole."""
    names = {name.split(".")[0] for name in
             (sys.modules if modules is None else modules)}
    return sorted(names & set(FOREIGN))


def result(cell: spec.Cell, rec: Record, trace: bool,
           device: Optional[dict]) -> dict:
    """The result line: the contract's keys, the checks last."""
    device = dict(device or {})
    device["memory_peak_bytes"] = int(rec.memory_peak_bytes)
    if trace:
        device["busy_s"] = rec.busy_s
        device["window_s"] = rec.trace_window_s
    line = {
        "correct": rec.correct,
        "attempted": int(rec.attempted),
        "failed": int(rec.failed),
        "metrics": per_layer(cell, rec) if trace else end_to_end(cell, rec),
        "device": device,
    }
    if trace and rec.breakdown is not None:
        line["breakdown"] = rec.breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in rec.checks}
    return line
