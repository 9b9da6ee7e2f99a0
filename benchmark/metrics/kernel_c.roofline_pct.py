"""kernel_c.roofline_pct: kernel C's share of its roofline in the traced
stretch (see _roofline.py)."""
from benchmark.metrics._roofline import reader

read = reader("kernel_c")
