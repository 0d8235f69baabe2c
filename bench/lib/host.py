"""Host-side facts a run prints beside its result: bytes written, peak host
memory, and the card's name and power limit."""
from __future__ import annotations

import resource
import shutil
import subprocess
from typing import Dict


def io_bytes() -> Dict[str, int]:
    """``/proc/self/io``'s counters of this process (empty where the
    kernel gives none)."""
    try:
        with open("/proc/self/io") as fh:
            return {k: int(v) for k, v in
                    (line.split(": ") for line in fh if ": " in line)}
    except OSError:
        return {}


def peak_rss_bytes() -> int:
    return int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024


def card() -> str:
    """``nvidia-smi``'s name and power limit of the cards, one line."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi not found"
    try:
        out = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc}"
    return " | ".join(line.strip() for line in out.stdout.splitlines())
