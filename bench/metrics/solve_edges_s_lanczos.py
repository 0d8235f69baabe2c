"""Seconds of a solve outside its iterations: each
``craft::lanczos.solve`` less its ``craft::lanczos.iterate`` (the state
built, the checkpoint opened, the restart probe, the close), mean over
the window's solves."""
from bench.lib import spans as sp

UNIT = "s"
SOURCE = "program_span"
LAYER = "driver"
MOVES = "lanczos_iters_per_s"


def read(rec):
    spans = sp.program()
    kids = sp.children(spans)
    return sp.mean([sp.seconds(s) - sum(
        sp.seconds(i) for i in kids.get(s["id"], ())
        if i["name"] == "craft::lanczos.iterate")
        for s in sp.solves(spans, rec)])
