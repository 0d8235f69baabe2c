#!/usr/bin/env python3
"""Readings of a cell's control: the reference, computed one precision
below the configuration's, put in the program's place and compared as the
cell compares the program (Lanczos: bfloat16 vectors against float64).

    python3 bench/tools/control.py --workload <cell> --seeds 1,2,3

Prints one JSON line a seed with the cell's numbers and its limits.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def readings(cell, seed: int, device: str = "cuda") -> dict:
    import torch

    from bench.reference import lanczos as ref

    lat, tr = cell.config["lattice"], cell.traffic
    n = int(tr.get("n_iter") or int(tr["version_at"]) + 1)
    prob = ref.problem(seed, lat, device, 0)
    exact = ref.follow(lat, *prob, n)
    low = ref.follow(lat, *prob, n, dtype=torch.bfloat16)
    return {"control": ref.gaps(low["alphas"], low["betas"][:n], exact)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT)]
    from bench.lib import spec

    cell = spec.cell(args.workload)
    for s in args.seeds.split(","):
        r = readings(cell, int(s))
        print(json.dumps({"cell": cell.name, "seed": int(s), **r,
                          "limits": cell.limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
