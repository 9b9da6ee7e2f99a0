"""Each cell end to end on the CPU at a small batch (the kernels' plain
versions): the result line's keys and order, its metrics, and a correct
check."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import harness, run
from benchmark.tests._cells import execute

# every cell of BENCHMARK.json. The plain versions on the CPU are not the
# card's kernels, so a run here is held to the card's limits in its
# propagated states only; the card's verdict is test_cell_on_the_card's
CELLS = [w["name"] for w in harness.load_json(
    harness.ROOT, "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs(name):
    out, lines = execute(name)
    assert list(out)[:3] == ["correct", "attempted", "failed"]
    assert list(out)[-1] == "check"
    x0 = out["check"]["x0_err"]
    assert x0["value"] <= x0["limit"], lines
    assert out["attempted"] > 0 and out["failed"] == 0
    wl = harness.workload(name)
    assert set(out["metrics"]) == {m["name"] for m in wl.end_to_end}
    assert out["metrics"]["solves_per_s"]["value"] > 0
    assert out["device"]["count"] == 1
    assert lines[-len(out["check"]):] == [
        f"check {k} {v['value']!r} limit {v['limit']!r}"
        for k, v in out["check"].items()]
    json.dumps(out)


def test_traced_run_reports_per_layer_metrics():
    out, _ = execute("rocket.track.b1024", trace=1, seconds=2.0)
    wl = harness.workload("rocket.track.b1024")
    names = {m["name"] for m in wl.per_layer}
    # on the CPU the trace holds no device operation: only the counters
    assert set(out["metrics"]) <= names
    assert out["metrics"]["passes_per_step"]["value"] >= 1.0
    assert out["metrics"]["lane_max_iters_per_step"]["value"] >= 1.0


def test_profiler_cost_splits_the_steps():
    step_s = np.array([0.010, 0.011, 0.030, 0.031, 0.032, 0.012])
    cost = run.profiler_cost(step_s, np.array([2, 3, 4]))
    assert cost == {"traced_steps": 3,
                    "step_ms_median_traced": pytest.approx(31.0),
                    "step_ms_median_untraced": pytest.approx(11.0)}
    assert run.profiler_cost(step_s, np.array([], dtype=np.int64)) == {}


@pytest.mark.parametrize("seed", [0, 2_147_483_659, 5_000_000_000, -7])
def test_the_seed_draws_each_episodes_noise(seed):
    """An episode's noise comes from the run's seed and the episode's index
    alone: the same pair draws the same rows, another episode or another
    seed other rows."""
    shape = (3, 4, 6)
    a = harness.episode_noise(seed, 0, shape, "cpu")
    assert torch.equal(a, harness.episode_noise(seed, 0, shape, "cpu"))
    assert not torch.equal(a, harness.episode_noise(seed, 1, shape, "cpu"))
    assert not torch.equal(a, harness.episode_noise(seed + 1, 0, shape,
                                                    "cpu"))
    assert a.dtype == torch.float32 and a.shape == shape


def test_every_cell_has_its_files():
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    for w in bench["workloads"]:
        wl = harness.workload(w["name"], bench)
        assert wl.chips == 1
        assert {"x0_err", "cost_gap_p90", "viol_max"} <= set(wl.limits)
    for m in bench["per_layer"]:
        from benchmark import metrics
        assert callable(metrics.reader(m["name"]).read)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         "2147483659", "--seconds", "5", "--trace", "0"], cwd=harness.ROOT,
        env=env, capture_output=True, text=True, timeout=1500)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"], proc.stderr[-3000:]
    assert out["device"]["platform"] == "gpu"


def _run_script(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, script, "--workload", "rocket.track.b1024",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=600)


def test_no_result_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    proc = _run_script(harness.ROOT, "benchmark/run.py")
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_no_result_from_the_benchmark_alone(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files (no program), a run prints no result and fails."""
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run_script(tmp_path, "benchmark/run.py")
    assert proc.returncode != 0
    assert proc.stdout == ""
