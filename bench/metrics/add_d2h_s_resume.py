"""Seconds a restore cycle spends copying the state to the host when the
checkpoint is opened: the program's ``craft::cp.d2h`` spans inside the
``craft::cp.add`` spans of the solve that holds each restore, mean over
the window's restores."""
from bench.lib import spans as sp

UNIT = "s"
SOURCE = "program_span"
LAYER = "checkpoint path"
MOVES = "restore_s"


def read(rec):
    spans = sp.program()
    kids = sp.children(spans)
    by_id = {s["id"]: s for s in spans}
    each = []
    for r in sp.restores(spans, rec):
        solve = by_id.get(r["parent"])
        if solve is None:
            return None
        each.append(sum(sp.seconds(d)
                        for a in sp.under(kids, solve, "craft::cp.add")
                        for d in sp.under(kids, a, "craft::cp.d2h")))
    return sp.mean(each)
