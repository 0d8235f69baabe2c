"""Spans of the benchmark around the calls into CRAFT's checkpoint layer.

``watch_checkpoints()`` wraps ``Checkpoint`` for the length of a ``with``
block: it keeps what each checkpoint registers (so a runner can read the
application's live state at a hook, as the checkpoint itself would) and
times every reopening of a checkpoint, from its construction to the end
of ``restart_if_needed`` with the device synchronised.  The wrapped
methods call the originals unchanged.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Tuple

import torch


class Watch:
    def __init__(self):
        self.items: Dict[Tuple[str, str], object] = {}
        # (opened, restored, whether a version was read) per restart call
        self.restores: List[Tuple[float, float, bool]] = []


@contextlib.contextmanager
def watch_checkpoints(sync: bool = True):
    from repro_torch.core.checkpoint import Checkpoint

    w = Watch()
    orig_init = Checkpoint.__init__
    orig_add = Checkpoint.add
    orig_restart = Checkpoint.restart_if_needed

    def init(self, *a, **kw):
        self._bench_opened = time.perf_counter()
        orig_init(self, *a, **kw)

    def add(self, key, obj, **kw):
        w.items[(self.name, key)] = obj
        return orig_add(self, key, obj, **kw)

    def restart(self, *a, **kw):
        ok = orig_restart(self, *a, **kw)
        if sync and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        w.restores.append((getattr(self, "_bench_opened", time.perf_counter()),
                           time.perf_counter(), bool(ok)))
        return ok

    Checkpoint.__init__ = init
    Checkpoint.add = add
    Checkpoint.restart_if_needed = restart
    try:
        yield w
    finally:
        Checkpoint.__init__ = orig_init
        Checkpoint.add = orig_add
        Checkpoint.restart_if_needed = orig_restart
