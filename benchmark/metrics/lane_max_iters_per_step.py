"""lane_max_iters_per_step: the mean over the window's steps of the largest
lane iteration count (``MPCResults.iters``)."""
from __future__ import annotations


def read(result):
    if not result.steps or result.lane_max_sum is None:
        return None
    return result.lane_max_sum / result.steps
