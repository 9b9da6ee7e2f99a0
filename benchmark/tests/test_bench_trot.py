"""The trot cell rehearsed on the CPU at tiny traffic (one lane a group,
episodes of six steps, every step of the window recorded): the check
reads ``correct`` true, and false with a fault planted under the timed
path, a step that propagates each lane with the dynamics of the window it
is about to solve (window k) in place of the window its applied control
was planned in (window k - 1). The two differ where a group's first
knot crosses a phase boundary between two windows: groups 3 and 7 at the
second step, 2 and 6 at the fourth, 1 and 5 at the fifth. A
traced run reads both of the cell's own per-layer metrics."""
from __future__ import annotations

import pytest
import torch

from benchmark import run
from benchmark.tests._cells import SEED, small_sample, tiny

NAME = "quadruped.trot.b1024"


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _execute(trace: int = 0, seconds: float = 3.0):
    args = run.parse(["--workload", NAME, "--seed", str(SEED), "--seconds",
                      str(seconds), "--trace", str(trace)])
    with small_sample(CHECK_STEPS=64, CHECK_LANES=8):
        return run.execute(args, "cpu", tiny(NAME, episode_steps=6))


def plant_previous_window_fault(setattr) -> None:
    """Steps propagate with the first knot of window k, not k - 1."""
    from altro_tpu_torch import mpc

    window = mpc._StepPieces.window

    def faulty(self, k_new):
        w = window(self, k_new)
        if self.dynamics_fn is None:
            return w
        return w[:4] + (mpc.knot0(self.dynamics_fn(k_new)),)

    setattr(mpc._StepPieces, "window", faulty)


def test_trot_cell_is_correct():
    out, lines = _execute()
    assert out["correct"], lines
    assert out["failed"] == 0


def test_previous_window_fault_is_not_correct(monkeypatch):
    plant_previous_window_fault(monkeypatch.setattr)
    out, lines = _execute()
    assert not out["correct"], lines
    assert out["check"]["x0_err"]["value"] > out["check"]["x0_err"]["limit"]


def test_traced_run_reads_the_cells_metrics():
    out, lines = _execute(trace=1)
    assert out["correct"], lines
    wait = out["metrics"]["group_wait_pct"]["value"]
    assert 0.0 <= wait < 100.0
    assert out["metrics"]["dynamics_us_per_step"]["value"] > 0.0
