"""Measurement scripts of the port: `ab.py` (tree against tree on one
card) and the kernel probes (`probes.py` and the four scripts it runs)."""
