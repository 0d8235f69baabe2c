"""The program's own reading of a restore: its metrics registry's
``restore_seconds`` of the memory tier (timed in ``Checkpoint`` around the
tier read, ``CRAFT_METRICS`` on in the traced run), mean over the
window's restores."""
UNIT = "s"
SOURCE = "program_counter"
LAYER = "checkpoint path"
MOVES = "restore_s"


def read(rec):
    return rec.program.get("restore_seconds_mean")
