"""Timing and tracing (the port's counterpart of
``altro_tpu/utils/profiling.py``):

- :func:`timed`: wall time of a block, fenced by a device synchronise on a
  CUDA device (the counterpart of ``block_until_ready``);
- :func:`fenced`: run a function and wait for the device; returns (its
  result, seconds);
- :func:`trace`: a ``torch.profiler`` trace of the block (CPU and, where
  there is one, CUDA activity), written as a Chrome trace.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def timed(label: str = "", results: dict = None, device=None):
    """Wall seconds of the block, with the device (``device``: a CUDA
    device, or None for host work) synchronised on entry and exit; stored
    under ``label`` in ``results`` or printed in ms."""
    _sync(device)
    t0 = time.perf_counter()
    yield
    _sync(device)
    dt = time.perf_counter() - t0
    if results is not None:
        results[label] = dt
    else:
        print(f"[{label}] {dt * 1e3:.3f} ms")


def fenced(fn, *args, device=None, **kwargs):
    """Run ``fn`` and wait until the device has finished it; returns (out,
    seconds)."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    _sync(device)
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def trace(path: str = "build/torch_trace.json"):
    """Profile the block with ``torch.profiler`` (CUDA activity too when a
    device is available) and write a Chrome trace to ``path`` (relative to
    the working directory); yields the profiler, whose ``key_averages()``
    sum the time by operator and kernel."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    prof.export_chrome_trace(path)
