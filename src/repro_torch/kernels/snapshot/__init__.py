"""Fused snapshot kernel family: per-chunk digest + dirty mask + histogram."""
