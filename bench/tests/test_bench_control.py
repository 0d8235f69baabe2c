"""The control of each cell on the card: the reference computed one
precision below the configuration's must fail the cell's limits (the
chip's readings at the cells' own sizes are in ``PERF.md``; here at a
size a test run holds: a smaller lattice).

    python -m pytest -q -m cuda bench/tests/test_bench_control.py
"""
from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.lib import spec  # noqa: E402
from bench.tools import control  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is read where the cells "
                    "run")
    return "cuda"


def _smaller(name: str) -> spec.Cell:
    c = copy.deepcopy(spec.cell(name))
    c.config["lattice"].update(nx=2048, ny=2048)
    return c


@pytest.mark.parametrize("name", [w["name"] for w in
                                  spec.benchmark()["workloads"]])
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5])
def test_the_control_fails_the_cells_limits(card, name, seed):
    c = _smaller(name)
    got = control.readings(c, seed, card)["control"]
    failed = [k for k, v in got.items() if k in c.limits
              and not v <= c.limits[k]]
    assert failed, (got, c.limits)
