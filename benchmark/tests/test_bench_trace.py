"""Reading a profiler trace: the stretch from the host's first call into CUDA
to the last device operation's end, the device's busy union, the idle gaps
labelled by the call into CUDA running at their midpoint, and the per-layer
readers on it."""
from __future__ import annotations

import json

import pytest

from benchmark import trace
from benchmark.metrics import _kinds


def _events():
    def x(cat, name, ts, dur, **args):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if args:
            e["args"] = args
        return e
    return [
        # the traced steps' calls into CUDA bound the stretch: [100, 260]
        x("cuda_runtime", "cudaGraphLaunch", 100.0, 8.0),
        x("cuda_runtime", "cudaGraphLaunch", 140.0, 50.0),
        x("cuda_runtime", "cudaEventSynchronize", 200.0, 60.0),
        x("kernel", "fused_expand_backward_kernel<float>", 110.0, 20.0,
          grid=[512, 1, 1]),
        x("kernel", "void at::native::elementwise_kernel<4>", 125.0, 10.0,
          grid=[8, 1, 1]),
        x("gpu_memcpy", "Memcpy DtoD", 210.0, 5.0),
        x("kernel", "ls_rollout_al_kernel<float, 6>", 230.0, 20.0,
          grid=[64, 6, 1]),
        # the host's own operators are not the trace's
        x("cpu_op", "aten::copy_", 150.0, 10.0),
    ]


def test_stretch_busy_and_gaps(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": _events()}))
    tr = trace.load(str(path), passes=4, steps=2)
    assert (tr.t0, tr.t1) == (100.0, 260.0)
    assert len(tr.ops) == 4
    # busy: [110, 135] + [210, 215] + [230, 250] = 50 us of 160
    assert tr.busy_s() == pytest.approx(50e-6)
    assert tr.window_s == pytest.approx(160e-6)
    assert tr.idle_gaps() == [(100.0, 110.0), (135.0, 210.0),
                              (215.0, 230.0), (250.0, 260.0)]
    bd = trace.breakdown(tr)
    assert bd["device_ops"][0][0].startswith("fused_expand_backward")
    labels = dict(bd["idle_gaps"])
    # the gaps [100, 110] and [135, 210] have their midpoints inside the
    # launches, [215, 230] and [250, 260] inside the synchronise
    assert labels == {"cudaGraphLaunch": pytest.approx(85e-6),
                      "cudaEventSynchronize": pytest.approx(25e-6)}


def test_a_trace_without_calls_into_cuda_reads_nothing(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps([e for e in _events()
                                if e["cat"] == "cpu_op"]))
    assert trace.load(str(path), passes=4, steps=2) is None


def test_readers_on_a_trace(tmp_path):
    from benchmark.metrics import reader

    path = tmp_path / "t.json"
    path.write_text(json.dumps(_events()))
    tr = trace.load(str(path), passes=4, steps=2)

    class R:
        pass
    r = R()
    r.trace, r.lanes, r.itemsize, r.steps = tr, 1024, 4, 2
    r.passes_window, r.lane_max_sum, r.step_passes = 8, 6, None
    r.kernels = {"kernel_b": (21, 6, 3, 15, (4, 4, 7)),
                 "kernel_c": (21, 6, 3, 15, 6)}
    idle = reader("device_idle_pct").read(r)
    assert idle == pytest.approx(100.0 * 110.0 / 160.0)
    glue = reader("glue_ms_per_pass").read(r)
    assert glue == pytest.approx(10e-3 / 4)
    assert reader("passes_per_step").read(r) == 4.0
    assert reader("lane_max_iters_per_step").read(r) == 3.0
    b = reader("kernel_b.roofline_pct").read(r)
    assert 0.0 < b <= 100.0
    assert reader("kernel_a.roofline_pct").read(r) is None
    assert _kinds.kind_of("ls_rollout_al_kernel<float, 6>") == "kernel_c"
