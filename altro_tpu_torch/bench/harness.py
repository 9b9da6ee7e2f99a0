"""Benchmark harness: timing, persistence, box-plot statistics (PyTorch
counterpart of ``altro_tpu/bench/harness.py``).

- ``benchmark_fn``: BenchmarkTools' ``benchmark_solve!`` (median of samples
  x evals, random_linear_problem.jl:161-174), fenced with
  ``torch.cuda.synchronize`` on a CUDA device, since a call returns before
  the device finishes;
- ``save_results`` / ``load_results``: the JLD2 ``@save`` / ``@load``
  persistence (run_random_linear.jl:125,139,153), as JSON;
- ``boxplot_stats``: the quartile/whisker/outlier computation of
  ``PGFBoxPlot`` (benchmarks/plotting.jl:12-51);
- ``comparison_plot``: per-solver box plots against a sweep variable
  (matplotlib, imported only here: the drivers run without it).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, List

import numpy as np
import torch


@dataclasses.dataclass
class BenchResult:
    name: str
    median_ms: float
    mean_ms: float
    std_ms: float
    min_ms: float
    samples_ms: List[float]
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _fence() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def benchmark_fn(fn: Callable[[], Any], samples: int = 5, evals: int = 5,
                 name: str = "", warmup: int = 1, **meta) -> BenchResult:
    """Median-of-samples timing of a thunk: each sample times ``evals``
    back-to-back calls, fenced by a device synchronise, and divides."""
    for _ in range(warmup):
        fn()
        _fence()
    times = []
    for _ in range(samples):
        t0 = time.perf_counter()
        for _ in range(evals):
            fn()
        _fence()
        times.append((time.perf_counter() - t0) / evals * 1e3)
    arr = np.asarray(times)
    return BenchResult(name=name, median_ms=float(np.median(arr)),
                       mean_ms=float(arr.mean()), std_ms=float(arr.std()),
                       min_ms=float(arr.min()), samples_ms=times, meta=meta)


def boxplot_stats(x, outlier_sigmas: float = 3.0):
    """Quartiles/whiskers/outliers (PGFBoxPlot, plotting.jl:12-51)."""
    x = np.asarray(x, np.float64)
    q1, med, q3 = np.percentile(x, [25, 50, 75])
    mu, sigma = x.mean(), x.std()
    inliers = x[np.abs(x - mu) < outlier_sigmas * sigma]
    lw = inliers.min() if inliers.size else x.min()
    uw = inliers.max() if inliers.size else x.max()
    outliers = x[(x < lw) | (x > uw)]
    return dict(q1=float(q1), median=float(med), q3=float(q3),
                lower_whisker=float(lw), upper_whisker=float(uw),
                mean=float(mu), outliers=outliers.tolist())


def _to_jsonable(obj):
    if isinstance(obj, BenchResult):
        return dataclasses.asdict(obj)
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().tolist()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    return obj


def save_results(path: str, results) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(_to_jsonable(results), f, indent=1)


def load_results(path: str):
    with open(path) as f:
        return json.load(f)


def comparison_plot(results: Dict[str, Dict[float, List[float]]], xlabel: str,
                    path: str, title: str = "", logy: bool = True):
    """Per-solver box plots and mean lines against a sweep variable
    (comparison_plot, plotting.jl:53-110); results[solver][x] =
    samples_ms."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    colors = {"ALTRO": "tab:red", "OSQP": "tab:blue", "ECOS": "tab:cyan",
              "COSMO": "tab:orange", "Mosek": "tab:purple",
              "ADMM-QP": "tab:blue", "ADMM-Conic": "tab:cyan"}
    fig, ax = plt.subplots(figsize=(6, 4))
    for solver, series in results.items():
        xs = sorted(series)
        means = [float(np.mean(series[x])) for x in xs]
        color = colors.get(solver, None)
        ax.plot(xs, means, "--", color=color, label=solver)
        for x in xs:
            s = boxplot_stats(series[x])
            ax.vlines(x, s["q1"], s["q3"], color=color, lw=4, alpha=0.5)
    ax.set_xlabel(xlabel)
    ax.set_ylabel("computation time (ms)")
    if logy:
        ax.set_yscale("log")
    if title:
        ax.set_title(title)
    ax.legend()
    ax.grid(True, alpha=0.3)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, bbox_inches="tight", dpi=120)
    plt.close(fig)
