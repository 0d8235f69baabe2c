"""Solver traffic: graphene Lanczos solves back to back through
``repro_torch.apps.lanczos.run_with_hook``.

The mix fixes the solve's length (``n_iter``), the checkpoint cadence
(``cp_freq``) and the number of distinct problems (``problems``), drawn
from the seed in set-up and taken in turn.  Set-up solves the first
problem once (the problems share every shape); the window then solves
them in turn and ends at the first solve to end past ``--seconds``.  The
window's rate is the iterations of its solves over its seconds.  The
output check runs the reference over a sample of the window's solves,
drawn from the seed.
"""
from __future__ import annotations

import random
import time
from pathlib import Path

import numpy as np
import torch

from bench.counts import lanczos as counts
from bench.lib import devtrace, paths, probes
from bench.lib.record import Check, Ctx, Record
from bench.reference import lanczos as ref

NEVER = 1_000_000_000


def setting(ctx: Ctx):
    """(GrapheneConfig, CraftEnv, the problems) of the cell."""
    from repro_torch.apps.lanczos import GrapheneConfig
    from repro_torch.core.env import CraftEnv

    lat, tr = ctx.cell.config["lattice"], ctx.cell.traffic
    extra = dict(tr.get("craft_env", {}))
    if ctx.trace:
        extra["CRAFT_METRICS"] = "1"
    env = CraftEnv.capture(paths.craft_env(Path(ctx.workdir), **extra))
    cfg = GrapheneConfig(nx=lat["nx"], ny=lat["ny"], t=lat["t"],
                         disorder=lat["disorder"], seed=0)
    probs = [ref.problem(ctx.seed, lat, ctx.device, i)
             for i in range(int(tr.get("problems", 1)))]
    return cfg, env, probs


def solve(cfg, env, prob, n_iter: int, cp_freq: int, device):
    """One solve through the application's entry point, on one rank."""
    from repro_torch.apps.lanczos import run_with_hook
    from repro_torch.core.comm import NullComm

    return run_with_hook(cfg, n_iter, cp_freq, NullComm(), env,
                         lambda it, cp: None, device=device, init=prob)


def fresh(ctx: Ctx) -> None:
    """Forget every memory-tier version (solves of new problems do not
    restore an earlier solve's state)."""
    from repro_torch.core.mem_level import MemFabric

    MemFabric.instance().reset()


def run(ctx: Ctx) -> Record:
    tr = ctx.cell.traffic
    lat = ctx.cell.config["lattice"]
    n_iter, cp_freq = int(tr["n_iter"]), int(tr.get("cp_freq") or NEVER)
    cuda = ctx.device == "cuda"
    rec = Record()
    cfg, env, probs = setting(ctx)
    tracer = devtrace.Tracer(ctx.trace, ctx.device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with probes.watch_checkpoints(sync=cuda):
        fresh(ctx)                               # set-up: every shape warm
        solve(cfg, env, probs[0], n_iter, cp_freq, ctx.device)
        if cuda:
            torch.cuda.synchronize()
        solves = []
        with tracer:
            with tracer.window():
                w0 = time.perf_counter()
                rec.setup_s = w0 - ctx.t0
                while True:
                    i = len(solves) % len(probs)
                    fresh(ctx)
                    with tracer.span("solve"):
                        out = solve(cfg, env, probs[i], n_iter, cp_freq,
                                    ctx.device)
                    solves.append((i, out["alphas"], out["betas"]))
                    if time.perf_counter() - w0 >= ctx.seconds:
                        break
                rec.window_s = time.perf_counter() - w0
        if cuda:
            rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    fresh(ctx)
    iters = sum(len(a) for _, a, _ in solves)
    rec.attempted = len(solves)
    rec.failed = sum(1 for _, a, _ in solves if len(a) != n_iter
                     or not np.all(np.isfinite(a)))
    rec.e2e["lanczos_iters_per_s"] = iters / rec.window_s
    rec.counts.update(iters=iters, solves=len(solves),
                      iter_bytes=counts.iteration_bytes(lat))
    red = tracer.reduce()
    if red is not None:
        rec.busy_s, rec.trace_window_s = red["busy_s"], red["window_s"]
        rec.kernels, rec.breakdown = red["kernels"], red["breakdown"]
        rec.counts["device_s"] = sum(v[1] for v in red["kernels"].values())

    # ---- the output check: a sample of the window's solves
    sample = random.Random(ctx.seed).sample(
        range(len(solves)), min(int(tr.get("check_solves", 2)), len(solves)))
    worst = dict.fromkeys(ref.NUMBERS, 0.0)
    refs = {}
    for j in sample:
        i, alphas, betas = solves[j]
        if i not in refs:
            refs[i] = ref.follow(lat, *probs[i], n_iter)
        got = ref.gaps(alphas, betas, refs[i])
        for k in worst:
            worst[k] = max(worst[k], got[k]) if got[k] == got[k] \
                else float("inf")
    lim = ctx.cell.limits
    rec.checks = [Check(k, v, lim[k]) for k, v in worst.items() if k in lim]
    rec.notes.update(sampled=sample, solves=len(solves), readings=worst)
    return rec
