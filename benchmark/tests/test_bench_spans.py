"""The per-layer readers of the program's spans (``Result.spans``): on
hand-built records of the set-up and of the window's steps outside the
profiler's stretch, each reader's value against a hand count, and None
without spans; on a traced run of the small rocket cell on the CPU (the
graphs' functions over their buffers, no device events), the readers of
host times and counts read numbers, those of device times None, and the
``loop.*`` spans' passes sum to the pass counter's over the same steps."""
from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import harness
from benchmark.metrics import _spans, reader
from benchmark.tests._cells import SEED, small_sample, tiny

SPAN_READERS = ("host_part_ms_per_step", "capture_s", "outside_graphs_pct",
                "replay_gap_us_per_pass", "live_lane_share",
                "empty_passes_per_step")
ON_THE_CPU = ("host_part_ms_per_step", "capture_s", "live_lane_share",
              "empty_passes_per_step")


class _Records:
    """Chrome-like span records: ``add`` returns the new span's id."""

    def __init__(self):
        self.rows = []

    def add(self, name, parent=None, request=None, ts=0.0, dur=1.0,
            device=None, **args):
        self.rows.append({"id": len(self.rows), "name": name,
                          "parent": parent, "request": request, "ts": ts,
                          "dur": dur, "device": device, "args": args})
        return len(self.rows) - 1


def _step(rec, request, t0):
    """One step's spans from ``t0`` (µs): inputs 200 µs, a start graph, a
    loop run of two replays over 8 lanes (8 then 3 live), a catch-all of
    one empty replay, a finish graph, out 300 µs; 5 ms in all. Device
    intervals in ms from the step's first event."""
    def dev(a, b):
        return [a, b]
    st = rec.add("step", None, request, t0, 5000.0)
    rec.add("step.inputs", st, request, t0, 200.0)
    rec.add("graph.start", st, request, t0 + 200, 50.0, dev(0.0, 0.5))
    lp = rec.add("loop.L0", st, request, t0 + 300, 2500.0, level=0, lanes=8,
                 cap=16, check_every=1, replays=2, passes=2, empty=0)
    rec.add("replay", lp, request, t0 + 300, 100.0, dev(0.6, 1.6),
            live_in=8, live_out=3)
    rec.add("sync", lp, request, t0 + 400, 1200.0)
    rec.add("replay", lp, request, t0 + 1600, 100.0, dev(1.7, 2.7),
            live_in=3, live_out=0)
    rec.add("sync", lp, request, t0 + 1700, 1000.0)
    rest = rec.add("loop.L0.rest", st, request, t0 + 2800, 1000.0, level=0,
                   lanes=8, cap=None, check_every=1, replays=1, passes=1,
                   empty=1)
    rec.add("replay", rest, request, t0 + 2800, 100.0, dev(2.8, 3.0),
            live_in=0, live_out=0)
    rec.add("sync", rest, request, t0 + 2900, 500.0)
    rec.add("graph.finish", st, request, t0 + 3800, 50.0, dev(3.1, 3.5))
    rec.add("step.out", st, request, t0 + 4700, 300.0)


def _result():
    """Set-up (a build with a capture of 0.4 s, a warm-up step request 0
    whose build captured for 0.1 s), then window steps 0 (request 1), 1
    (the profiler's: the tracer is off, no spans) and 2 (request 2)."""
    rec = _Records()
    b = rec.add("build", ts=-1e6, dur=5e5, lanes=8)
    rec.add("capture", b, None, -1e6, 4e5, graph="loop")
    st = rec.add("step", None, 0, -4e5, 2e5)
    b = rec.add("build", st, 0, -4e5, 1.5e5, lanes=8)
    rec.add("capture", b, 0, -4e5, 1e5, graph="start")
    _step(rec, 1, 0.0)
    _step(rec, 2, 10000.0)
    return SimpleNamespace(spans=harness.window_spans(rec.rows, 3, [1]),
                           step_passes=np.array([3, 7, 3]))


def test_window_steps_are_the_last_step_requests():
    spans = _result().spans
    assert spans["window"] == {1: 0, 2: 2}
    # the tracer dropped the oldest spans, up to the last window step's:
    # the set-up and the window's first step are gone
    first = next(i for i, r in enumerate(spans["records"])
                 if r["request"] == 2)
    kept = spans["records"][first:]
    assert harness.window_spans(kept, 3, [1])["window"] == {2: 2}
    # and only the middle of the first step's: it is no window step
    kept = spans["records"][first - 3:]
    assert harness.window_spans(kept, 3, [1])["window"] == {2: 2}


def test_readers_on_hand_built_spans():
    r = _result()
    got = {name: reader(name).read(r) for name in SPAN_READERS}
    assert got == {
        "host_part_ms_per_step": pytest.approx(0.5),
        "capture_s": pytest.approx(0.5),
        # graphs 0.5 + 1.0 + 1.0 + 0.2 + 0.4 ms of each 5 ms step
        "outside_graphs_pct": pytest.approx(100.0 * (1.0 - 3.1 / 5.0)),
        # one gap of 0.1 ms between the loop's two replays, 3 passes a step
        "replay_gap_us_per_pass": pytest.approx(100.0 / 3.0),
        # 11 live of 24 lane slots a step
        "live_lane_share": pytest.approx(100.0 * 11.0 / 24.0),
        "empty_passes_per_step": pytest.approx(1.0),
    }
    # steps 0 and 2: the profiler's step 1 has no spans
    assert _spans.passes_check(r) == (6, 6)


def test_readers_read_nothing_without_spans():
    r = _result()
    r.spans = None
    for name in SPAN_READERS:
        assert reader(name).read(r) is None, name
    assert _spans.passes_check(r) is None


def test_traced_run_on_the_cpu(tmp_path):
    wl = tiny("rocket.track.b1024")
    with small_sample():
        res, _ = harness.run_cell(wl, SEED, 2.0, True, device="cpu",
                                  t_start=time.perf_counter(),
                                  out_dir=str(tmp_path))
    assert res.spans is not None
    assert 0 < len(res.spans["window"]) <= res.steps
    # the tracer is off over the profiler's steps: the step requests are
    # set-up's warm-up step and the window's other steps
    roots = [r for r in res.spans["records"]
             if r["name"] == "step" and r["parent"] is None]
    assert len(roots) == 1 + len(res.spans["window"])
    if len(res.traced_steps):
        assert len(res.spans["window"]) < res.steps
    got = {name: reader(name).read(res) for name in SPAN_READERS}
    for name in ON_THE_CPU:
        assert got[name] is not None and got[name] > 0.0, (name, got)
    for name in set(SPAN_READERS) - set(ON_THE_CPU):
        assert got[name] is None, (name, got)
    assert 0.0 < got["live_lane_share"] <= 100.0
    span_passes, counter_passes = _spans.passes_check(res)
    assert span_passes == counter_passes > 0
