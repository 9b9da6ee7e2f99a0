"""device_idle_pct: the share of the traced stretch (the host's first call
into CUDA to the end of the last device operation) in which no operation ran
on the device, from one run's trace."""
from __future__ import annotations


def read(result):
    tr = result.trace
    if tr is None or not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
