"""Roofline analysis of traced steps."""
