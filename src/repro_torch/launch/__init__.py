"""Drivers of the LM workload (the serving driver in this slice)."""
