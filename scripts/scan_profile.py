#!/usr/bin/env python3
"""Device time of each kernel of the selective-scan routes on one CUDA card.

    PYTHONPATH=src python3 scripts/scan_profile.py

Runs ``ssd_scan_cuda`` and ``s6_scan_cuda`` of the PyTorch port at the
serving path's float32 shapes (zamba2-2.7b: (2, 8192, 80, 64, 64) with one
B/C group broadcast over the heads; falcon-mamba-7b: (2, 8192, 8192, 16)),
each route a few times under torch.profiler, and prints one JSON line per
(scan, route) with the mean device microseconds of every kernel a call
launches (the chunked route's states, carry and outputs passes), then the
card's name and power limit.  Exits non-zero without a CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

REPS = 5
SHAPES = {"ssd_scan": (2, 8192, (80, 64), 64),
          "s6_scan": (2, 8192, (8192,), 16)}


def inputs(name, gen, dev):
    import torch

    b, l, heads, st = SHAPES[name]
    if name == "ssd_scan":
        nh, hd = heads
        dtx = torch.randn((b, l, nh, hd), generator=gen, device=dev)
        bh, ch = (torch.randn((b, l, 1, st), generator=gen, device=dev)
                  .expand(b, l, nh, st) for _ in range(2))
        dt = torch.rand((b, l, nh), generator=gen, device=dev) * 0.025
        A = -(0.5 + 1.5 * torch.rand((nh,), generator=gen, device=dev))
        h0 = torch.randn((b, nh, hd, st), generator=gen, device=dev)
    else:
        (di,) = heads
        dtx = torch.randn((b, l, di), generator=gen, device=dev)
        bh, ch = (torch.randn((b, l, st), generator=gen, device=dev)
                  for _ in range(2))
        dt = torch.rand((b, l, di), generator=gen, device=dev) * 0.025
        A = -(0.5 + 1.5 * torch.rand((di, st), generator=gen, device=dev))
        h0 = torch.randn((b, di, st), generator=gen, device=dev)
    return dtx, bh, ch, dt, A, h0


def kernel_name(name: str) -> str:
    """``ssd_outputs_kernel<float, true>`` of a profiler's demangled
    ``void (anonymous namespace)::ssd_outputs_kernel<float, true>(...)``."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0]


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.ssm_scan.kernel import (ROUTES, s6_scan_cuda,
                                                     ssd_scan_cuda)

    if not torch.cuda.is_available():
        print("scan_profile.py: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    for name, fn in (("ssd_scan", ssd_scan_cuda), ("s6_scan", s6_scan_cuda)):
        args = inputs(name, gen, dev)
        for route in ROUTES:
            fn(*args, route=route)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(REPS):
                    fn(*args, route=route)
                torch.cuda.synchronize()
            us: dict = {}
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    key = kernel_name(e.name)
                    us[key] = us.get(key, 0.0) + e.time_range.elapsed_us()
            print(json.dumps({"scan": name, "route": route,
                              "shape": [list(a.shape) for a in args],
                              "device_us_per_call": {
                                  k: v / REPS for k, v in us.items()},
                              "total_us": sum(us.values()) / REPS}),
                  flush=True)
        del args
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
