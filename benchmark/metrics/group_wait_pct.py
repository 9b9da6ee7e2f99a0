"""group_wait_pct: the share of group-iterations spent waiting on the
slowest group, 100 x (1 - sum_t sum_g it_{g,t} / sum_t G max_g it_{g,t}),
it_{g,t} group g's lane-max iterations in step t (the ``group_iters`` of
the step's ``step.out`` span), over the window's kept steps (the program's
spans, see _spans.py). Grouped compaction would reclaim it; None where the
program records no groups (an ungrouped step, a program without the
counter)."""
from __future__ import annotations

from benchmark.metrics import _spans


def kept_requests(result) -> set:
    """The request ids of the window's steps whose spans the tracer kept."""
    steps = {q["step"] for q in _spans.steps(result)}
    return {rid for rid, i in result.spans["window"].items() if i in steps}


def read(result):
    if result.spans is None:
        return None
    kept = kept_requests(result)
    rows = [r["args"]["group_iters"] for r in result.spans["records"]
            if r["name"] == "step.out" and r["request"] in kept
            and "group_iters" in r["args"]]
    worst = sum(len(its) * max(its) for its in rows)
    if not worst:
        return None
    return 100.0 * (1.0 - sum(sum(its) for its in rows) / worst)
