"""Share of the traced restore window with no kernel and no copy on the
card."""
from bench.lib.readers import idle_share

UNIT = "%"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "restore_s"


def read(rec):
    return idle_share(rec)
