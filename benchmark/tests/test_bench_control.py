"""The lower-precision control: the reference put in the program's place and
computed in TF32 (every product's operands rounded to TF32), on the
recorded lane-steps of a small run, fails the cell's limits."""
from __future__ import annotations

import time

import torch

from benchmark import check, harness
from benchmark.tests._cells import SEED, small_sample, tiny


def test_tf32_control_is_not_correct(tmp_path):
    wl = tiny("rocket.track.b1024")
    # a window of several steps, in one thread (a pool of them is slower
    # on a loaded host): an episode's first step starts from the
    # configuration's x0, which TF32 holds exactly, so a window of that
    # step alone shows the control no rounding in its propagation
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with small_sample(CHECK_LANES=3):
            res, cell = harness.run_cell(wl, SEED, 3.0, False, device="cpu",
                                         t_start=time.perf_counter(),
                                         out_dir=str(tmp_path))
    finally:
        torch.set_num_threads(threads)
    assert res.steps >= 2
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
