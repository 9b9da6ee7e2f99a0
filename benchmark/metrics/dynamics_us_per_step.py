"""dynamics_us_per_step: host microseconds a step spends copying its
dynamics window into the step's input buffers (the ``step.dynamics``
spans), per window step outside the profiler's stretch whose spans the
tracer kept (see _spans.py); None where the program records no such span
(a step on fixed dynamics, a program without the span)."""
from __future__ import annotations

from benchmark.metrics import _spans


def read(result):
    qs = _spans.steps(result)
    if not qs:
        return None
    steps = {q["step"] for q in qs}
    kept = {rid for rid, i in result.spans["window"].items() if i in steps}
    durs = [r["dur"] for r in result.spans["records"]
            if r["name"] == "step.dynamics" and r["request"] in kept
            and r["dur"] is not None]
    if not durs:
        return None
    return sum(durs) / len(qs)
