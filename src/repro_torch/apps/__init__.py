"""Benchmark applications (the paper's showcase workloads)."""
