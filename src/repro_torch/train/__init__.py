"""Step functions of the LM workload: training and serving."""
