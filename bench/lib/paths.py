"""Where a run reads and writes.

* Build and kernel caches go to fixed directories inside the checkout:
  the program builds its CUDA kernels into ``<checkout>/build/
  torch_kernels`` (fixed in ``repro_torch.kernels._build``), and the
  benchmark points ``TORCH_EXTENSIONS_DIR`` and ``TRITON_CACHE_DIR`` at
  ``<checkout>/build/`` too, so only a checkout's first run builds.
* CRAFT's checkpoint paths (``CRAFT_CP_PATH``, ``CRAFT_NODE_CP_PATH``,
  ``CRAFT_MEM_SCRATCH``) go under ``$TMPDIR/craft-bench/<cell>``, emptied
  before and after the run, never to ``/dev/shm`` or a fixed ``/tmp``
  path.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from pathlib import Path

from bench.lib.spec import ROOT


def set_build_caches() -> None:
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def workdir(cell: str) -> Path:
    """``$TMPDIR/craft-bench/<cell>``, empty."""
    base = Path(os.environ.get("TMPDIR") or tempfile.gettempdir())
    d = base / "craft-bench" / cell
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


def craft_env(work: Path, **extra: str) -> dict:
    """The closed environment a run's checkpoints are captured under:
    CRAFT's paths under ``work`` and ``extra`` on top."""
    env = {
        "CRAFT_CP_PATH": str(work / "pfs"),
        "CRAFT_NODE_CP_PATH": str(work / "node"),
        "CRAFT_MEM_SCRATCH": str(work / "mem"),
    }
    env.update({k: str(v) for k, v in extra.items()})
    return env
