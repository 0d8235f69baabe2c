"""Arithmetic the per-layer readers share."""
from __future__ import annotations

from typing import Optional

from bench.counts import PEAKS
from bench.lib.record import Record


def idle_share(rec: Record) -> Optional[float]:
    """Per cent of the traced window with no kernel and no copy on the
    card."""
    if rec.busy_s is None or not rec.trace_window_s:
        return None
    return 100.0 * (1.0 - rec.busy_s / rec.trace_window_s)


def bound_s(flops: float = 0.0, flops_peak: str = "bf16_flops",
            nbytes: float = 0.0) -> float:
    """The larger of the operations' and the bytes' least time."""
    return max(flops / PEAKS[flops_peak], nbytes / PEAKS["hbm_bytes_per_s"])
