"""Seconds of a restore the host spends outside the copy onto the card:
each ``craft::cp.restart`` that read a version less the seconds its
``craft::cp.h2d`` spans cover (agreeing on the version, materialising it,
checking its manifest, assembling each item), mean over the window's
restores."""
from bench.lib import spans as sp

UNIT = "s"
SOURCE = "program_span"
LAYER = "checkpoint path"
MOVES = "restore_s"


def read(rec):
    spans = sp.program()
    kids = sp.children(spans)
    return sp.mean([sp.seconds(r)
                    - sp.covered_s(sp.under(kids, r, "craft::cp.h2d"))
                    for r in sp.restores(spans, rec)])
