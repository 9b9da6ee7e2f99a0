"""passes_per_step: solver-loop passes (``solver.altro.pass_count``: every
batch a step ran, compaction's levels and the frozen passes of a graph
replay included) per step over the window."""
from __future__ import annotations


def read(result):
    return result.passes_window / result.steps if result.steps else None
