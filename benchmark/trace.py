"""Reading a torch.profiler trace (its Chrome-trace export): the device
operations with their grids, and the host's calls into the CUDA runtime and
driver, which bound the traced steps and label the device's idle gaps."""
from __future__ import annotations

import bisect
import heapq
import json
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class DeviceOp:
    name: str
    cat: str
    ts: float                # microseconds, the trace's clock
    dur: float
    grid: Optional[Tuple[int, int, int]]


@dataclass
class Trace:
    """The traced stretch: from the host's first call into the CUDA runtime
    or driver to the end of the last device operation or call
    (``t0``, ``t1``, microseconds; the profiler records only the traced
    steps, each of which starts with a call and ends in a synchronise), the
    device operations, the host's calls, and the solver passes and steps
    the stretch ran."""

    t0: float
    t1: float
    ops: List[DeviceOp]
    host: List[Tuple[float, float, str]]
    passes: int = 0
    steps: int = 0
    extra: dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def kernels(self) -> List[DeviceOp]:
        return [o for o in self.ops if o.cat == "kernel"]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, clipped to the
        stretch, as disjoint sorted intervals."""
        spans = sorted((max(o.ts, self.t0), min(o.ts + o.dur, self.t1))
                       for o in self.ops)
        merged: List[List[float]] = []
        for a, b in spans:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def idle_gaps(self) -> List[Tuple[float, float]]:
        gaps, last = [], self.t0
        for a, b in self.busy_intervals():
            if a > last:
                gaps.append((last, a))
            last = max(last, b)
        if self.t1 > last:
            gaps.append((last, self.t1))
        return gaps


def load(path: str, passes: int, steps: int) -> Optional[Trace]:
    """The stretch of the Chrome trace at ``path``; None where it holds no
    call into CUDA (a run on the CPU)."""
    with open(path) as fh:
        events = json.load(fh)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    ops, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            grid = (e.get("args") or {}).get("grid")
            ops.append(DeviceOp(name, cat, ts, dur,
                                tuple(int(g) for g in grid) if grid else None))
        elif cat in HOST_CATS:
            host.append((ts, ts + dur, name))
    if not host:
        return None
    t0 = min(a for a, _, _ in host)
    t1 = max([b for _, b, _ in host] + [o.ts + o.dur for o in ops])
    ops = [o for o in ops if o.ts >= t0]
    return Trace(t0=t0, t1=t1, ops=ops, host=host, passes=passes,
                 steps=steps)


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps summed
    by the innermost call into CUDA running at each gap's midpoint ("host",
    the host's own work, where none was), each list with at most ``top``
    entries, in seconds."""
    by_name: dict = {}
    for o in tr.ops:
        by_name[o.name] = by_name.get(o.name, 0.0) + o.dur * 1e-6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    host = sorted(h for h in tr.host if h[1] > tr.t0 and h[0] < tr.t1)
    starts = [h[0] for h in host]
    gaps_by: dict = {}
    active: list = []            # heap of (-start, end, name)
    i = 0
    for a, b in tr.idle_gaps():
        mid = 0.5 * (a + b)
        j = bisect.bisect_right(starts, mid)
        while i < j:
            heapq.heappush(active, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        label = "host"
        for _, end, name in sorted(active):
            if end > mid:
                label = name
                break
        active = [h for h in active if h[1] > mid]
        heapq.heapify(active)
        gaps_by[label] = gaps_by.get(label, 0.0) + (b - a) * 1e-6
    idle = sorted(gaps_by.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in device_ops],
            "idle_gaps": [[k, v] for k, v in idle]}
