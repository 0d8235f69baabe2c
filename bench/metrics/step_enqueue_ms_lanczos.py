"""Milliseconds of host time an iteration takes to enqueue its work: each
``craft::lanczos.step`` less its ``craft::lanczos.read`` (the host's wait
for alpha and beta), mean over the iterations of the window's solves."""
from bench.lib import spans as sp

UNIT = "ms"
SOURCE = "program_span"
LAYER = "driver"
MOVES = "lanczos_iters_per_s"


def read(rec):
    spans = sp.program()
    kids = sp.children(spans)
    return sp.mean([1e3 * (sp.seconds(s) - sum(
        sp.seconds(r) for r in kids.get(s["id"], ())
        if r["name"] == "craft::lanczos.read"))
        for solve in sp.solves(spans, rec)
        for s in sp.under(kids, solve, "craft::lanczos.step")])
