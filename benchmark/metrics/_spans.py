"""The program's spans as the per-layer readers take them
(``Result.spans``, a ``--trace 1`` run's: ``harness.window_spans``).

Per window step, a frozen copy of the arithmetic of the port's
``utils/profiling.py: summarize``, so that a change to the program cannot
move the yardstick: the step's host ms (its ``step`` span), the host part
(``step.inputs`` and ``step.out``), the device ms of its graph replays (each
from its before-event to its after-event; None without device events, as on
the CPU), the device gaps between consecutive replays of one loop run, its
passes and empty passes (``loop.*``: ``passes``, ``empty`` x
``check_every``), and the live lanes entering its loop replays beside the
lanes of their batches.

The steps read are the window's steps whose spans the tracer kept: it is
off over the steps the profiler runs over, and it keeps the newest
``MAX_SPANS`` spans (at ~130 spans a step, ~8,000 steps).
"""
from __future__ import annotations


def _summaries(spans: dict) -> dict:
    """Per window request id, the step's summary (see the docstring)."""
    window = spans["window"]
    by_id = {r["id"]: r for r in spans["records"]}
    out = {rid: {"step": i, "host_ms": None, "host_part_ms": 0.0,
                 "graphs_ms": None, "gaps_us": [], "passes": 0,
                 "empty_passes": 0, "live_in": 0, "lane_slots": 0}
           for rid, i in window.items()}
    prev = {}
    for r in spans["records"]:
        q = out.get(r["request"])
        if q is None:
            continue
        name, parent = r["name"], by_id.get(r["parent"])
        if name == "step" and r["parent"] is None:
            q["host_ms"] = None if r["dur"] is None else r["dur"] * 1e-3
        if name in ("step.inputs", "step.out") and r["dur"] is not None:
            q["host_part_ms"] += r["dur"] * 1e-3
        if r["device"] is not None:
            q["graphs_ms"] = ((q["graphs_ms"] or 0.0) + r["device"][1]
                              - r["device"][0])
        a = r["args"]
        if name.startswith("loop.") and "replays" in a:
            q["passes"] += a["passes"]
            q["empty_passes"] += a["empty"] * a["check_every"]
        if name == "replay" and parent is not None:
            q["live_in"] += a.get("live_in", 0)
            q["lane_slots"] += parent["args"]["lanes"]
            before = prev.get(parent["id"])
            if before is not None and r["device"] is not None:
                q["gaps_us"].append((r["device"][0] - before[1]) * 1e3)
            prev[parent["id"]] = r["device"]
    return out


def steps(result) -> list:
    """The summaries of the window's steps with spans, in order; empty
    without spans."""
    spans = result.spans
    if spans is None:
        return []
    if "summaries" not in spans:
        spans["summaries"] = _summaries(spans)
    qs = sorted(spans["summaries"].values(), key=lambda q: q["step"])
    return [q for q in qs if q["host_ms"] is not None]


def setup_capture_s(result):
    """Host seconds of the ``capture`` spans (one graph's warm-up and
    capture each) outside the window's steps: set-up's; None where there
    are none."""
    spans = result.spans
    if spans is None:
        return None
    durs = [r["dur"] for r in spans["records"]
            if r["name"] == "capture" and r["dur"] is not None
            and r["request"] not in spans["window"]]
    return sum(durs) * 1e-6 if durs else None


def passes_check(result):
    """(the ``loop.*`` spans' passes, the pass counter's) summed over the
    window's kept steps that the counter recorded; None without spans or
    per-step counts."""
    if result.step_passes is None:
        return None
    qs = [q for q in steps(result) if q["step"] < len(result.step_passes)]
    if not qs:
        return None
    return (sum(q["passes"] for q in qs),
            int(sum(int(result.step_passes[q["step"]]) for q in qs)))
