"""kernel_b.roofline_pct: kernel B's share of its roofline in the traced
stretch (see _roofline.py)."""
from benchmark.metrics._roofline import reader

read = reader("kernel_b")
