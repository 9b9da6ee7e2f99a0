"""live_lane_share: the live lanes entering the solver loop's replays over
the lanes of their batches (100 x the ``replay`` spans' ``live_in`` summed
over the lanes of their ``loop.*`` runs), over every kept step of the
window (the program's spans and counters, see _spans.py): the share of
the loop's lane slots that do work."""
from __future__ import annotations

from benchmark.metrics import _spans


def read(result):
    qs = _spans.steps(result)
    slots = sum(q["lane_slots"] for q in qs)
    if not slots:
        return None
    return 100.0 * sum(q["live_in"] for q in qs) / slots
