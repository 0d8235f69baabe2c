"""Restore traffic of a training job: Zamba2's weights and AdamW state
brought back from CRAFT's memory tier, as a job that was preempted or lost
a rank does before its next step.

The configuration file holds the published ``config.json`` keys (cut as
its ``reduced`` says); ``repro_torch.configs.zamba2_7b.from_hf_config``
reads them and the cut configuration is registered under the
configuration's name, so ``repro_torch.launch.train.run`` trains it like
any other architecture.  Set-up runs ``version_at`` + 1 steps of the
seed's synthetic data with one version written at step ``version_at`` to
the memory tier, and keeps the last step's loss and gradient norm; then
one cycle warms the path.  Every cycle of the window calls ``run`` again:
it builds the state afresh, ``restart_if_needed`` restores the version
from host memory, and one step follows.  A restore is timed from the
checkpoint's construction to the end of ``restart_if_needed``, the card
synchronised (``lib.probes``); the window's ``restore_s`` is their mean.
The garbage collector runs between cycles only, set-up's objects frozen
out of its scans (as in ``lanczos_resume``).

The output check: every cycle resumed at ``version_at``, its step's loss
and gradient norm equal the uninterrupted run's bit for bit, and so does
its whole state after that step (the weights, AdamW's moments and count),
by a digest of each tensor's bits (:func:`digest`).  Before the window
one more restore with no step gives the program's weights at
``version_at``; after it, the program's forward on the next step's batch
is held to the plain reference (``bench/reference/zamba2.py``, float32 on
the card, on the same weights): the logits at ``check_positions``
positions drawn from the seed, over the whole vocabulary, and the loss.
Nothing of the program runs after the window, so the span readers take
the window's restores as the last ones (``bench/lib/spans.py``).
"""
from __future__ import annotations

import dataclasses
import gc
import random
import time
from pathlib import Path

import torch
import torch.utils._pytree as pytree

from bench.counts import zamba2 as counts
from bench.lib import devtrace, paths, probes
from bench.lib.record import Check, Ctx, Record
from bench.reference import zamba2 as ref
from bench.runners.lanczos_resume import _restore_hist
# the released block's configuration: a checkout without it fails here,
# at once
from repro_torch.configs import zamba2_7b

#: numbers of the output check beside their limits (limits/<cell>.json)
NUMBERS = ("logits_rel_err", "loss_rel_gap")


def model_config(cell):
    """The cell's ``ModelConfig``, registered under the configuration's
    name."""
    from repro_torch.configs import register_config

    cfg = zamba2_7b.from_hf_config(cell.config, arch_id=cell.config_name)
    register_config(cell.config_name, cfg)
    return cfg


def setting(ctx: Ctx):
    """(ModelConfig, CraftEnv, TrainConfig of set-up and of each cycle)."""
    from repro_torch.core.env import CraftEnv
    from repro_torch.launch.train import TrainConfig

    tr = ctx.cell.traffic
    cfg = model_config(ctx.cell)
    extra = dict(tr.get("craft_env", {}))
    if ctx.trace:
        extra["CRAFT_METRICS"] = "1"
    env = CraftEnv.capture(paths.craft_env(Path(ctx.workdir), **extra))
    k = int(tr["version_at"])
    # the data pipeline keys its generator with 32 bits of the seed
    tc = TrainConfig(arch=ctx.cell.config_name, tiny=False, steps=k + 1,
                     global_batch=int(tr["global_batch"]),
                     seq_len=int(tr["seq_len"]), cp_freq=k,
                     seed=ctx.seed % (1 << 32), device=ctx.device)
    return cfg, env, tc


def fresh(ctx: Ctx) -> None:
    """Forget every memory-tier version."""
    from repro_torch.core.mem_level import MemFabric

    MemFabric.instance().reset()


def run(ctx: Ctx) -> Record:
    from repro_torch.core import metrics as craft_metrics
    from repro_torch.launch.train import run as train

    tr = ctx.cell.traffic
    k = int(tr["version_at"])
    cuda = ctx.device == "cuda"
    rec = Record()
    cfg, env, tc = setting(ctx)
    tracer = devtrace.Tracer(ctx.trace, ctx.device)
    deterministic = torch.are_deterministic_algorithms_enabled()
    # a bit-exact resume on the card needs deterministic kernels (the
    # embedding's backward accumulates with atomics otherwise)
    torch.use_deterministic_algorithms(True)
    fresh(ctx)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    try:
        with probes.watch_checkpoints(sync=cuda) as watch:
            first = train(tc, env=env)
            want = (first["losses"][k], first["grad_norms"][k],
                    digest(first["state"]))
            rec.notes["setup_steps_s"] = first["step_s"]
            rec.notes["version_write_s"] = first["cp_writes"]
            del first
            train(tc, env=env)                        # warm the path
            # the program's weights at version_at, restored with no step
            held = train(dataclasses.replace(tc, steps=k), env=env)
            held_at, params = held["start_step"], held["state"]["params"]
            del held                            # the moments are not read
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
                                out = train(tc, env=env)
                            with tracer.span("digest"):
                                cycles.append((out["start_step"],
                                               out["losses"],
                                               out["grad_norms"],
                                               out["step_s"],
                                               digest(out["state"])))
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
            rec.notes["routes_224"] = _routes_224()
        checks, readings = _check(ctx, cfg, held_at, params, k, want[0])
        del params
    finally:
        torch.use_deterministic_algorithms(deterministic)
        fresh(ctx)
    rec.attempted = len(cycles)
    rec.failed = sum(1 for r in restores if not r[2])
    rec.e2e["restore_s"] = sum(t1 - t0 for t0, t1, _ in restores) \
        / max(1, len(restores))
    rec.counts.update(restores=len(restores), cycles=len(cycles),
                      h2d_bytes=len(restores)
                      * counts.version_bytes(ctx.cell.config))
    if hist1 is not None and hist0 is not None and hist1[1] > hist0[1]:
        rec.program["restore_seconds_mean"] = \
            (hist1[0] - hist0[0]) / (hist1[1] - hist0[1])
    red = tracer.reduce()
    if red is not None:
        rec.busy_s, rec.trace_window_s = red["busy_s"], red["window_s"]
        rec.kernels, rec.breakdown = red["kernels"], red["breakdown"]

    mism = sum(1 for at, losses, gnorms, _, dig in cycles
               if at != k or losses != [want[0]] or gnorms != [want[1]]
               or dig != want[2])
    rec.checks = [Check("round_trip_mismatches", float(mism), 0.0)] + checks
    rec.notes.update(
        cycles=len(cycles), first_resumed=cycles[0][0] if cycles else None,
        readings=readings, step_loss=want[0], step_grad_norm=want[1],
        restore_each_s=[round(t1 - t0, 6) for t0, t1, _ in restores],
        step_each_s=[round(c[3][0], 6) if c[3] else None for c in cycles])
    return rec


#: words of a tensor's bits summed at once by :func:`digest`
_CHUNK = 1 << 24


def digest(tree) -> dict:
    """Per tensor of ``tree``, by its path (a restored tree may hold its
    keys in another order), two sums over its bits read as 16-bit words:
    the plain sum, and the sum weighted by each word's place (mod 65521,
    plus 1).  Integer sums are exact in any order, so a state equal bit
    for bit gives an equal digest, and a state that differs in one word
    a different one; a word moved elsewhere changes the weighted sum."""
    sums = {}
    for path, x in pytree.tree_flatten_with_path(tree)[0]:
        words = x.detach().contiguous().reshape(-1)
        words = words.view(torch.uint8 if words.element_size() == 1
                           else torch.int16)
        place = torch.arange(min(_CHUNK, words.numel()), dtype=torch.int32,
                             device=words.device)
        plain = weighted = torch.zeros((), dtype=torch.int64,
                                       device=words.device)
        for lo in range(0, words.numel(), _CHUNK):
            w = words[lo:lo + _CHUNK].to(torch.int32)
            plain = plain + w.sum(dtype=torch.int64)
            # |word| <= 2**15 and weight <= 65521: the product fits in 32 bits
            weighted = weighted + (w * ((place[:w.numel()] + lo) % 65521 + 1)
                                   ).sum(dtype=torch.int64)
        sums[pytree.keystr(path)] = torch.stack([plain, weighted])
    return {k: v.tolist() for k, v in sums.items()}


def _routes_224() -> dict:
    """The flash kernel's launches at head dim 224, by route (none on the
    CPU)."""
    try:
        from repro_torch.kernels.flash_attention.kernel import \
            flash_attention_cuda
    except ImportError:
        return {}
    return {r: n for (d, r), n in getattr(flash_attention_cuda, "dims",
                                          {}).items() if d == 224}


def _check(ctx: Ctx, cfg, held_at: int, params, k: int, step_loss: float):
    """The program's logits and step loss against the reference's, on the
    weights restored at ``k`` (``held_at``: the step the restore gave) and
    the batch of step ``k`` + 1 (cursor k)."""
    lim = ctx.cell.limits
    if held_at != k:
        nan = float("nan")
        return ([Check(n, nan, lim[n]) for n in NUMBERS],
                {"restored_at": held_at})
    tokens, labels, pos = check_batch(ctx, cfg, k)
    got = program_logits(cfg, params, tokens, pos)
    readings = compare(got, step_loss, reference_logits(
        ctx, cfg, params, tokens), labels, pos)
    return [Check(n, readings[n], lim[n]) for n in NUMBERS], readings


def check_batch(ctx: Ctx, cfg, k: int):
    """(tokens, labels) of the step after ``k`` on the device, and the
    positions compared, drawn from the seed."""
    from repro_torch.data.pipeline import SyntheticTokens

    tr = ctx.cell.traffic
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=int(tr["seq_len"]),
                           global_batch=int(tr["global_batch"]),
                           seed=ctx.seed % (1 << 32))
    batch = data.batch(k)
    dev = torch.device(ctx.device)
    tokens = torch.as_tensor(batch["tokens"]).to(dev)
    labels = torch.as_tensor(batch["labels"]).to(dev)
    pos = sorted(random.Random(ctx.seed).sample(
        range(tokens.shape[1]), min(int(tr["check_positions"]),
                                    tokens.shape[1])))
    return tokens, labels, torch.tensor(pos, device=dev)


def program_logits(cfg, params, tokens, pos):
    """The program's float32 logits at ``pos`` through its forward."""
    from repro_torch.models import model as M

    with torch.no_grad():
        hidden, _, _ = M.forward_hidden(params, cfg, tokens=tokens)
        return M.unembed(params, cfg, hidden[:, pos]).float()


def reference_logits(ctx: Ctx, cfg, params, tokens):
    """The reference's logits (B, L, V) on the program's weights, named as
    the released checkpoint names them."""
    with torch.no_grad():
        return ref.logits(zamba2_7b.hf_state_dict(params, cfg),
                          ctx.cell.config, tokens)


def compare(got, step_loss: float, lg, labels, pos) -> dict:
    """The check's numbers: the logits' relative error (Frobenius, over
    the positions and the whole vocabulary) and the loss's relative gap."""
    with torch.no_grad():
        ref_loss = float(ref.cross_entropy(lg, labels))
        want = lg[:, pos]
        return {"logits_rel_err": float((got - want).norm() / want.norm()),
                "loss_rel_gap": abs(step_loss - ref_loss) / abs(ref_loss),
                "logits_max_abs_err": float((got - want).abs().max()),
                "logits_max_abs": float(want.abs().max()),
                "ref_loss": ref_loss, "positions": int(pos.numel())}
