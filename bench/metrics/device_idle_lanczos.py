"""Share of the traced solve window with no kernel and no copy on the
card."""
from bench.lib.readers import idle_share

UNIT = "%"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "lanczos_iters_per_s"


def read(rec):
    return idle_share(rec)
