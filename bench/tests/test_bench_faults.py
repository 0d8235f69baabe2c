"""Runs of each cell on the CPU at a small size, the chip's look skipped,
with the timed path broken underneath: ``correct`` must come out false
for every fault the cell can have, and true without one.

Faults: a step that returns its state unchanged; half of the matvec's
rows left out and the rest doubled; an answer (an alpha) altered where it
is produced; for the restore cell, a restore that reads nothing.  One card
holds each cell, so no exchange between chips can be left out.
"""
from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.lib import harness, paths, spec  # noqa: E402
from bench.lib.record import Ctx  # noqa: E402

RESUME = "graphene-8192.resume-mem"
SOLVES = "graphene-8192.lanczos"


def small(name: str) -> spec.Cell:
    c = copy.deepcopy(spec.cell(name))
    c.config["lattice"].update(nx=32, ny=32)
    c.traffic["problems"] = min(c.traffic.get("problems", 1), 2)
    if "n_iter" in c.traffic:
        c.traffic["n_iter"] = 40
    return c


def drive(name: str, seed: int = 2 ** 31 + 11, seconds: float = 1.0):
    torch.manual_seed(0)
    c = small(name)
    rec = harness.execute(Ctx(cell=c, seed=seed, seconds=seconds,
                              trace=False, device="cpu",
                              workdir=str(paths.workdir("faults")),
                              t0=time.perf_counter()))
    return harness.result(c, rec, False, {"platform": "cpu"})


# ---------------------------------------------------------------- faults
def _unchanged_lanczos_step(monkeypatch):
    import repro_torch.apps.lanczos as lz

    orig = lz.lanczos_step

    def step(cfg, eps, v_prev, v_cur, beta):
        alpha, beta_new, _, _ = orig(cfg, eps, v_prev, v_cur, beta)
        return alpha, beta_new, v_prev, v_cur

    monkeypatch.setattr(lz, "lanczos_step", step)


def _altered_alpha(monkeypatch):
    import repro_torch.apps.lanczos as lz

    orig = lz.lanczos_step

    def step(cfg, eps, v_prev, v_cur, beta):
        alpha, beta_new, vp, vn = orig(cfg, eps, v_prev, v_cur, beta)
        return alpha * 1.001, beta_new, vp, vn

    monkeypatch.setattr(lz, "lanczos_step", step)


def _half_dot(monkeypatch):
    import repro_torch.apps.lanczos as lz

    orig = lz.matvec

    def matvec(cfg, eps, psi):
        out = orig(cfg, eps, psi).clone()
        out[: out.shape[0] // 2] *= 2.0
        out[out.shape[0] // 2:] = 0.0
        return out

    monkeypatch.setattr(lz, "matvec", matvec)


def _restore_reads_nothing(monkeypatch):
    from repro_torch.core.checkpoint import Checkpoint

    monkeypatch.setattr(Checkpoint, "_read_version",
                        lambda self, version: None)


FAULTS = {
    RESUME: [_unchanged_lanczos_step, _altered_alpha, _half_dot,
             _restore_reads_nothing],
    SOLVES: [_unchanged_lanczos_step, _altered_alpha, _half_dot],
}


@pytest.mark.parametrize("name", [RESUME, SOLVES])
def test_a_sound_run_is_correct(name):
    line = drive(name)
    assert line["correct"] is True, line["checks"]


@pytest.mark.parametrize("seed", [5, 2 ** 32 + 3])
@pytest.mark.parametrize("name", [RESUME, SOLVES])
def test_a_sound_run_is_correct_on_other_seeds(name, seed):
    line = drive(name, seed)
    assert line["correct"] is True, line["checks"]


@pytest.mark.parametrize("name,fault", [
    (n, f) for n, fs in FAULTS.items() for f in fs],
    ids=lambda x: x if isinstance(x, str) else x.__name__.strip("_"))
def test_a_broken_run_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    line = drive(name)
    assert line["correct"] is False, line["checks"]
