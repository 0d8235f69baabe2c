"""Drivers of the LM workload: training and serving."""
