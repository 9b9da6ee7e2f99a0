"""pass_tail.launches_per_pass: launches of the pass-tail kernel (a kernel
whose lower-cased name holds ``al_pass_tail``) in the traced stretch per
solver-loop pass (``solver.altro.pass_count``): 1 where every pass ends in
it, 0 on a program without it."""
from __future__ import annotations


def read(result):
    tr = result.trace
    if tr is None or not tr.passes:
        return None
    return sum("al_pass_tail" in k.name.lower()
               for k in tr.kernels()) / tr.passes
