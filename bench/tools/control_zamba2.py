#!/usr/bin/env python3
"""Readings of the zamba2 restore cell's check without the timed window:
the program's weights after ``version_at`` steps of the seed's data, then
the program (bfloat16) against the float32 reference as the cell compares
it, and two controls put in the program's place: the reference one
precision below the configuration's (every weight and every normed
activation rounded to float8 e4m3, scaled per tensor) and the reference
without the MLP adapters (a part of the mathematics left out).

    python3 bench/tools/control_zamba2.py --seeds 1,2,3

Prints one JSON line a seed with the three readings and the limits.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _q8(x):
    import torch

    s = x.abs().amax().clamp(min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


@contextlib.contextmanager
def _float8(ref):
    w, norm = ref._w, ref.rms_norm
    ref._w = lambda sd, name: _q8(sd[name].float())
    ref.rms_norm = lambda x, wt, eps: _q8(norm(x, wt, eps))
    try:
        yield
    finally:
        ref._w, ref.rms_norm = w, norm


def readings(cell, seed: int, device: str = "cuda") -> dict:
    import torch

    from bench.lib.record import Ctx
    from bench.reference import zamba2 as ref
    from bench.runners import train_resume as tr
    from repro_torch.launch.train import run as train
    from repro_torch.train import steps as S

    k = int(cell.traffic["version_at"])
    with tempfile.TemporaryDirectory() as work:
        ctx = Ctx(cell=cell, seed=seed, seconds=0.0, trace=False,
                  device=device, workdir=work, t0=time.perf_counter())
        cfg, env, tc = tr.setting(ctx)
        torch.use_deterministic_algorithms(True)
        out = train(dataclasses.replace(tc, steps=k, cp_freq=10 ** 9),
                    env=env)
    params = out["state"]["params"]
    del out
    tokens, labels, pos = tr.check_batch(ctx, cfg, k)
    with torch.no_grad():
        loss, _ = S._loss_fn(params, cfg, S.TrainStepConfig(loss_chunk=32),
                             {"tokens": tokens, "labels": labels})
    got = tr.program_logits(cfg, params, tokens, pos)
    lg = tr.reference_logits(ctx, cfg, params, tokens)
    row = {"program": tr.compare(got, float(loss), lg, labels, pos)}
    sd = __import__("repro_torch.configs.zamba2_7b", fromlist=["x"]) \
        .hf_state_dict(params, cfg)
    hp = cell.config
    with torch.no_grad():
        with _float8(ref):
            low = ref.logits(sd, hp, tokens)
        row["float8"] = tr.compare(low[:, pos], float(
            ref.cross_entropy(low, labels)), lg, labels, pos)
        del low
        cut = ref.logits(sd, dict(hp, use_shared_mlp_adapter=False), tokens)
        row["no_adapter"] = tr.compare(cut[:, pos], float(
            ref.cross_entropy(cut, labels)), lg, labels, pos)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--workload", default="zamba2-7b-d12.resume-mem")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench.lib import paths, spec

    paths.set_build_caches()
    cell = spec.cell(args.workload)
    for s in args.seeds.split(","):
        r = readings(cell, int(s))
        print(json.dumps({"cell": cell.name, "seed": int(s), **r,
                          "limits": cell.limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
