"""Host milliseconds of a restore per tensor restored: each
``craft::cp.restart`` that read a version, less the host clock its
``craft::cp.h2d`` spans cover, over the ``leaves`` its ``craft::cp.restore``
span counts; mean over the window's restores.  A program whose restore
span counts no leaves gives nothing."""
from bench.lib import spans as sp

UNIT = "ms"
SOURCE = "program_span"
LAYER = "checkpoint path"
MOVES = "restore_s"


def read(rec):
    spans = sp.program()
    kids = sp.children(spans)
    each = []
    for r in sp.restores(spans, rec):
        leaves = sum(s["fields"].get("leaves", 0)
                     for s in sp.under(kids, r, "craft::cp.restore"))
        if not leaves:
            return None
        host = sp.seconds(r) - sp.covered_s(sp.under(kids, r,
                                                     "craft::cp.h2d"))
        each.append(1e3 * host / leaves)
    return sp.mean(each)
