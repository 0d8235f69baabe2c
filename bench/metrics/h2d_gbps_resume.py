"""Host-to-device copy rate of the restores: the bytes of the traced
window's host-to-device copies over their device seconds."""
from bench.lib.devtrace import kernel_time

UNIT = "GB/s"
SOURCE = "device_trace"
LAYER = "checkpoint path"
MOVES = "restore_s"


def read(rec):
    nbytes = rec.counts.get("h2d_bytes")
    _, secs = kernel_time(rec.kernels, "Memcpy HtoD")
    if not nbytes or secs <= 0:
        return None
    return nbytes / secs / 1e9
