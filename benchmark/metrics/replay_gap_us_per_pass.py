"""replay_gap_us_per_pass: device microseconds between consecutive loop
replays of one loop run (a replay's after-event to the next one's
before-event: the host's sync, its read of the live counts and the next
launch), summed over the window's steps outside the profiler's stretch,
per solver-loop pass of those steps (the program's spans, see _spans.py);
None without device events (the CPU)."""
from __future__ import annotations

from benchmark.metrics import _spans


def read(result):
    qs = [q for q in _spans.steps(result)
          if q["gaps_us"]]
    passes = sum(q["passes"] for q in qs)
    if not passes:
        return None
    return sum(sum(q["gaps_us"]) for q in qs) / passes
