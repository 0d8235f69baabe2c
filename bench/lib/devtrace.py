"""The device trace of a run's window: ``torch.profiler`` over the window,
reduced to the device's busy seconds, each kernel's launches and seconds,
and the breakdown the result line carries (the device operations that
took most time, and the longest idle gaps by the benchmark's span they
fall in).

The profiler records the card's activity alone: recording every host
operator as well slowed a training step about twice (NVIDIA H100 80GB
HBM3, PyTorch 2.11), which would distort the host-clock readings of the
traced run.  The benchmark's spans are host ``perf_counter_ns`` ranges,
put on the card's clock by one marker kernel launched after a
synchronisation when the trace starts (its start on the card less the
host time of its launch: off by the launch latency, microseconds).
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch

NAME_CHARS = 96
MARKER = "spin_kernel"          # the kernel of torch.cuda._sleep


class Tracer:
    """``with Tracer(on, device):`` profiles the card when ``on`` and the
    device is a card; does nothing otherwise.  ``window()`` marks the
    traced window and ``span(name)`` a span of the benchmark in it."""

    def __init__(self, enabled: bool, device: str = "cuda"):
        self.enabled = bool(enabled) and device == "cuda"
        self.prof = None
        self.spans: List[Tuple[int, int, str]] = []
        self.window_ns: Optional[Tuple[int, int]] = None
        self.marker_ns: Optional[int] = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            torch.cuda.synchronize()
            self.marker_ns = time.perf_counter_ns()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            torch.cuda.synchronize()
            self.prof.__exit__(*exc)
        return False

    @contextlib.contextmanager
    def window(self):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.window_ns = (t0, time.perf_counter_ns())

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            if self.enabled:
                self.spans.append((t0, time.perf_counter_ns(),
                                   f"bench::{name}"))

    def reduce(self) -> Optional[dict]:
        """{"busy_s", "window_s", "kernels", "breakdown"} of the traced
        window, or None when nothing was traced."""
        if self.prof is None or self.window_ns is None:
            return None
        events = [(ev.name(), int(ev.start_ns()), int(ev.end_ns()))
                  for ev in self.prof.profiler.kineto_results.events()
                  if ev.device_type() == torch.autograd.DeviceType.CUDA
                  and not ev.is_user_annotation()]
        marks = [s for n, s, _ in events if MARKER in n]
        if not marks:
            return None
        off = min(marks) - self.marker_ns
        return reduce_events(
            [(n, s, e) for n, s, e in events if MARKER not in n],
            (self.window_ns[0] + off, self.window_ns[1] + off),
            [(s + off, e + off, n) for s, e, n in self.spans])


def _merge(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def reduce_events(dev: List[Tuple[str, int, int]], window: Tuple[int, int],
                  spans: List[Tuple[int, int, str]]) -> dict:
    """The reduction of the card's events ``(name, start_ns, end_ns)`` over
    ``window`` (ns, the card's clock), idle gaps labelled by the innermost
    of ``spans`` ``(start_ns, end_ns, name)`` around their middle."""
    w0, w1 = window
    kernels: Dict[str, List[float]] = {}
    busy_iv = []
    for name, s, e in dev:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (e - s) * 1e-9
        busy_iv.append((s, e))
    merged = _merge(busy_iv)
    busy = sum(e - s for s, e in merged) * 1e-9
    gaps = []
    prev = w0
    for s, e in merged + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = []
    for g0, g1 in gaps[:10]:
        mid = (g0 + g1) // 2
        inner = [(e - s, n) for s, e, n in spans if s <= mid <= e]
        label = min(inner)[1] if inner else "between spans"
        labelled.append([label, (g1 - g0) * 1e-9])
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "busy_s": busy,
        "window_s": (w1 - w0) * 1e-9,
        "kernels": kernels,
        "breakdown": {
            "device_ops": [[_short(n), v[1]] for n, v in top],
            "idle_gaps": labelled,
        },
    }


def kernel_time(kernels: Dict[str, List[float]],
                *parts: str) -> Tuple[int, float]:
    """(launches, seconds) of the kernels whose name holds any of
    ``parts``."""
    n, t = 0, 0.0
    for name, (count, secs) in kernels.items():
        if any(p in name for p in parts):
            n += int(count)
            t += secs
    return n, t
