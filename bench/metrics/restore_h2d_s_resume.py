"""Seconds of a restore spent copying the version onto the card: the
host clock covered by the program's ``craft::cp.h2d`` spans inside each
``craft::cp.restart`` that read a version, mean over the window's
restores."""
from bench.lib import spans as sp

UNIT = "s"
SOURCE = "program_span"
LAYER = "checkpoint path"
MOVES = "restore_s"


def read(rec):
    spans = sp.program()
    kids = sp.children(spans)
    return sp.mean([sp.covered_s(sp.under(kids, r, "craft::cp.h2d"))
                    for r in sp.restores(spans, rec)])
