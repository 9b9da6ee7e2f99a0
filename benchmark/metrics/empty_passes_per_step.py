"""empty_passes_per_step: solver-loop passes of replays that no live lane
entered (the ``loop.*`` spans' ``empty`` x ``check_every``: a catch-all
that finds every lane done still runs one replay), per kept step of the
window (the program's spans and counters, see _spans.py)."""
from __future__ import annotations

from benchmark.metrics import _spans


def read(result):
    qs = _spans.steps(result)
    if not qs:
        return None
    return sum(q["empty_passes"] for q in qs) / len(qs)
