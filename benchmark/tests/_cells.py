"""Small versions of the benchmark's cells for the CPU tests: the cell's
configuration at its published sizes, a batch of a few lanes, episodes of
three steps, few lane-steps compared and a short traced stretch, traced on
the host (a CPU has no CUDA activity to trace)."""
from __future__ import annotations

import contextlib
import dataclasses

from benchmark import harness, run

SEED = 3_000_000_001
SMALL = {"CHECK_STEPS": 4, "CHECK_LANES": 2, "TRACE_FROM": 0.2,
         "TRACE_SECONDS": 0.3, "TRACE_ACTIVITIES": ("CPU",)}


@contextlib.contextmanager
def small_sample(**consts):
    """The harness's sampling and tracing constants at SMALL (and
    ``consts``) while the block runs."""
    new = dict(SMALL, **consts)
    old = {k: getattr(harness, k) for k in new}
    for k, v in new.items():
        setattr(harness, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(harness, k, v)


def tiny(name: str, **traffic):
    wl = harness.workload(name)
    t = dict(wl.traffic, batch=8, episode_steps=3)
    t.update(traffic)
    return dataclasses.replace(wl, traffic=t)


def execute(name: str, seconds: float = 1.0, trace: int = 0, **consts):
    args = run.parse(["--workload", name, "--seed", str(SEED), "--seconds",
                      str(seconds), "--trace", str(trace)])
    with small_sample(**consts):
        return run.execute(args, "cpu", tiny(name))
