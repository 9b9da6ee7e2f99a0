"""outside_graphs_pct: the share of the steps' host time in which no graph
replay ran on the device: 100 x (1 - the device ms of every graph replay,
its before-event to its after-event, over the steps' host ms), over the
window's steps outside the profiler's stretch (the program's spans, see
_spans.py). The card's idle share without the profiler; None without
device events (the CPU)."""
from __future__ import annotations

from benchmark.metrics import _spans


def read(result):
    qs = [q for q in _spans.steps(result)
          if q["graphs_ms"] is not None]
    host_ms = sum(q["host_ms"] for q in qs)
    if not host_ms:
        return None
    return 100.0 * (1.0 - sum(q["graphs_ms"] for q in qs) / host_ms)
