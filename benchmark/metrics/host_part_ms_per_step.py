"""host_part_ms_per_step: host milliseconds a step spends outside its graphs
in the program's own Python, the ``step.inputs`` span (the window and the
copy of the inputs) and the ``step.out`` span (the results' clone), per
window step outside the profiler's stretch (the program's spans, see
_spans.py)."""
from __future__ import annotations

from benchmark.metrics import _spans


def read(result):
    qs = _spans.steps(result)
    if not qs:
        return None
    return sum(q["host_part_ms"] for q in qs) / len(qs)
