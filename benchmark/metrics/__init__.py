"""Per-layer metrics: one reader per metric, ``metrics/<name>.py``, whose
``read(result)`` takes the run's :class:`~benchmark.harness.Result`
(counters, per-step records and, in a traced run, the parsed trace) and
returns the metric's value, or None where it finds nothing to read (the
metric is then left out of the result line)."""
from __future__ import annotations

import os

HERE = os.path.dirname(os.path.abspath(__file__))


def reader(name: str):
    from benchmark.harness import load_module
    path = os.path.join(HERE, name + ".py")
    return load_module(path, "benchmark_metric_" + name.replace(".", "_"))


def read_all(wl, result) -> dict:
    out = {}
    for m in wl.per_layer:
        value = reader(m["name"]).read(result)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
