"""glue_ms_per_pass: device milliseconds of every kernel that is not one of
the port's hand-written kernels (kernels A-D), per solver-loop pass
(``solver.altro.pass_count``), over the traced stretch."""
from __future__ import annotations

from benchmark.metrics import _kinds


def read(result):
    tr = result.trace
    if tr is None or not tr.passes or not tr.kernels():
        return None
    ms = sum(k.dur * 1e-3 for k in tr.kernels()
             if _kinds.kind_of(k.name) not in _kinds.HAND_WRITTEN)
    return ms / tr.passes
