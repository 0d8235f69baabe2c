"""Step functions of the LM workload (serving steps in this slice)."""
