"""A hand-written kernel's share of its roofline over the traced stretch:
the least time the card could take for every launch of the kernel (its
bytes and FLOPs at the lanes it ran, ``_work.py``, over the data sheet's
peaks) over the launches' device time. A launch's lanes are read from its
grid: the cell's largest launch of the kernel runs the whole batch,
and a smaller grid (a compaction level's batch) runs that share of it."""
from __future__ import annotations

from math import prod

from benchmark.metrics import _kinds, _work


def share(result, kind: str):
    tr = result.trace
    if tr is None or kind not in result.kernels:
        return None
    launches = [k for k in tr.kernels() if _kinds.kind_of(k.name) == kind]
    if not launches or any(k.grid is None for k in launches):
        return None
    full = max(prod(k.grid) for k in launches)
    work = _work.WORK[kind]
    bound_ms = device_ms = 0.0
    for k in launches:
        lanes = max(1, round(result.lanes * prod(k.grid) / full))
        nbytes, flops = work(lanes, *result.kernels[kind], result.itemsize)
        bound_ms += _work.bound_ms(nbytes, flops, result.itemsize)[0]
        device_ms += k.dur * 1e-3
    if device_ms == 0.0:
        return None
    return 100.0 * bound_ms / device_ms


def reader(kind: str):
    def read(result):
        return share(result, kind)
    return read
