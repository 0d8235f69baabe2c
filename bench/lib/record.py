"""What one run hands from its runner to the readers and the result line."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from bench.lib.spec import Cell


@dataclasses.dataclass
class Ctx:
    """What a runner is given."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    workdir: Optional[str] = None      # CRAFT's paths go under it
    t0: float = 0.0                    # perf_counter at the process's start


@dataclasses.dataclass
class Check:
    """One number of the output check beside its limit (passes when the
    number is at most the limit)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclasses.dataclass
class Record:
    """A run's measurements.  ``e2e`` holds the end-to-end metrics (host
    clock); ``counts`` what the run counted (steps, tokens, restores,
    operations); ``kernels`` the traced device time by kernel name
    ({name: [launches, seconds]}); ``program`` readings the program itself
    gave (its metrics registry); ``notes`` what the run prints beside its
    result for the record (the check's every reading, step and restore
    times)."""
    setup_s: float = 0.0
    window_s: float = 0.0
    e2e: Dict[str, float] = dataclasses.field(default_factory=dict)
    counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernels: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    program: Dict[str, float] = dataclasses.field(default_factory=dict)
    busy_s: Optional[float] = None
    trace_window_s: Optional[float] = None
    breakdown: Optional[dict] = None
    memory_peak_bytes: int = 0
    attempted: int = 0
    failed: int = 0
    checks: List[Check] = dataclasses.field(default_factory=list)
    notes: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)
