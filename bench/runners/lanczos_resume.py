"""Restore traffic: the Lanczos state brought back from CRAFT's memory
tier, as the AFT zone body does on every re-entry (paper Listing 9).

Set-up solves the seed's problem through ``run_with_hook`` for
``version_at`` + 1 iterations, writing one version at iteration
``version_at`` to the memory tier, and keeps that uninterrupted solve's
alphas and betas.  Every cycle of the window then calls ``run_with_hook``
again on the same problem: it builds the state afresh, opens the
checkpoint, ``restart_if_needed`` restores the version from host memory
onto the card, and one more iteration proves the state live.  A restore
is timed from the checkpoint's construction to the end of
``restart_if_needed``, the card synchronised (``lib.probes``); the
window's ``restore_s`` is their mean.  The set-up's first cycle warms the
path.  The garbage collector runs between cycles only, outside the timed
restores, with set-up's objects frozen out of its scans: a collection
that fell inside a restore (about 0.2 s) and host buffers freed only at
such a collection made the mean swing from run to run.

The output check: every cycle resumed at ``version_at`` and returned the
uninterrupted solve's alphas and betas bit for bit (the round trip), and
the uninterrupted solve agrees with the float64 reference.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from bench.counts import lanczos as counts
from bench.lib import devtrace, probes
from bench.lib.record import Check, Ctx, Record
from bench.reference import lanczos as ref
from bench.runners.lanczos import NEVER, fresh, setting, solve


def run(ctx: Ctx) -> Record:
    from repro_torch.core import metrics as craft_metrics

    tr = ctx.cell.traffic
    lat = ctx.cell.config["lattice"]
    k = int(tr["version_at"])
    cuda = ctx.device == "cuda"
    rec = Record()
    cfg, env, (prob,) = setting(ctx)
    tracer = devtrace.Tracer(ctx.trace, ctx.device)
    fresh(ctx)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with probes.watch_checkpoints(sync=cuda) as watch:
        first = solve(cfg, env, prob, k + 1, k, ctx.device)
        solve(cfg, env, prob, k + 1, NEVER, ctx.device)     # warm the path
        if cuda:
            torch.cuda.synchronize()
        hist0 = _restore_hist(craft_metrics)
        n0 = len(watch.restores)
        cycles = []
        gc.collect()
        gc.freeze()
        gc.disable()
        try:
            with tracer:
                with tracer.window():
                    w0 = time.perf_counter()
                    rec.setup_s = w0 - ctx.t0
                    while True:
                        with tracer.span("cycle"):
                            out = solve(cfg, env, prob, k + 1, NEVER,
                                        ctx.device)
                        cycles.append((out["resumed_from"], out["alphas"],
                                       out["betas"]))
                        del out
                        with tracer.span("collect"):
                            gc.collect()
                        if time.perf_counter() - w0 >= ctx.seconds:
                            break
                    rec.window_s = time.perf_counter() - w0
        finally:
            gc.enable()
            gc.unfreeze()
        if cuda:
            rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
        restores = watch.restores[n0:]
        hist1 = _restore_hist(craft_metrics)
    fresh(ctx)
    rec.attempted = len(cycles)
    rec.failed = sum(1 for r in restores if not r[2])
    rec.e2e["restore_s"] = sum(t1 - t0 for t0, t1, _ in restores) \
        / max(1, len(restores))
    rec.counts.update(restores=len(restores), cycles=len(cycles),
                      h2d_bytes=len(restores) * counts.version_bytes(lat))
    if hist1 is not None and hist0 is not None and hist1[1] > hist0[1]:
        rec.program["restore_seconds_mean"] = \
            (hist1[0] - hist0[0]) / (hist1[1] - hist0[1])
    red = tracer.reduce()
    if red is not None:
        rec.busy_s, rec.trace_window_s = red["busy_s"], red["window_s"]
        rec.kernels, rec.breakdown = red["kernels"], red["breakdown"]

    # ---- the output check
    mism = sum(1 for at, a, b in cycles
               if at != k or not np.array_equal(a, first["alphas"])
               or not np.array_equal(b, first["betas"]))
    gaps = ref.gaps(first["alphas"], first["betas"],
                    ref.follow(lat, *prob, k + 1))
    lim = ctx.cell.limits
    rec.checks = [Check("round_trip_mismatches", float(mism), 0.0)] + [
        Check(k, gaps[k], lim[k]) for k in ref.NUMBERS if k in lim]
    rec.notes.update(cycles=len(cycles), first_resumed=cycles[0][0],
                     readings=gaps, restore_each_s=[
                         round(t1 - t0, 6) for t0, t1, _ in restores])
    return rec


def _restore_hist(craft_metrics):
    """(sum, count) of the program's ``restore_seconds`` histogram of the
    memory tier, or None when its registry is off."""
    if not craft_metrics.enabled():
        return None
    h = craft_metrics.snapshot()["histograms"].get(
        "restore_seconds|slot=mem")
    return (h["sum"], h["count"]) if h else (0.0, 0)
