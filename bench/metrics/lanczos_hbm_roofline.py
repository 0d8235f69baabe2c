"""The iterations' least bytes (``counts.lanczos``: each vector read once
or written once) at the HBM peak, over the traced window's device
seconds."""
from bench.lib.readers import bound_s

UNIT = "%"
SOURCE = "device_trace"
LAYER = "driver"
MOVES = "lanczos_iters_per_s"


def read(rec):
    dev = rec.counts.get("device_s")
    if not dev or not rec.counts.get("iters"):
        return None
    return 100.0 * rec.counts["iters"] * bound_s(
        nbytes=rec.counts["iter_bytes"]) / dev
