"""capture_s: set-up's host seconds in the program's ``capture`` spans, one
graph's warm-up and capture each (the cold solve's graphs and the step's),
from the program's spans (see _spans.py)."""
from __future__ import annotations

from benchmark.metrics import _spans


def read(result):
    return _spans.setup_capture_s(result)
