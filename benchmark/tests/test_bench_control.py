"""The lower-precision control: the reference put in the program's place and
computed in TF32 (every product's operands rounded to TF32), on the
recorded lane-steps of a small run, fails the cell's limits."""
from __future__ import annotations

import time

from benchmark import check, harness
from benchmark.tests._cells import SEED, small_sample, tiny


def test_tf32_control_is_not_correct(tmp_path):
    wl = tiny("rocket.track.b1024")
    with small_sample(CHECK_LANES=3):
        res, cell = harness.run_cell(wl, SEED, 1.0, False, device="cpu",
                                     t_start=time.perf_counter(),
                                     out_dir=str(tmp_path))
    _, program = check.judge(cell, res.samples, res.start, "cpu")
    answers = check.control_answers(cell, res.samples, res.start, "cpu")
    _, control = check.judge(cell, res.samples, res.start, "cpu",
                             answers=answers)
    # the plain versions on the CPU are not the card's kernels: of the
    # program, only the propagation is held to the card's limit here
    assert program["x0_err"] <= wl.limits["x0_err"]
    ok, rows = check.verdict(control, wl.limits)
    assert not ok, rows
    assert control["x0_err"] > wl.limits["x0_err"]
