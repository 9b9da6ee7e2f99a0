"""The tracer inside the port's MPC step (``utils/profiling.py``), on the
CPU's fixed-buffer route (``graphed=True``: the graphs' functions over
their buffers, no capture), on the rocket's compacted tracking step:

- the carry and ``MPCResults`` are bit-equal with the tracer on and off, in
  float64 and float32, and the tracer keeps nothing while it is off;
- per step, the passes of the ``loop.*`` spans sum to the
  ``solver.altro.pass_count`` delta;
- each replay's entering live count is ``cond(state).sum()`` read just
  before it;
- a catch-all that finds no live lane records exactly one empty replay;
- the exported spans share ``torch.profiler``'s clock: a step's span holds
  its ``aten::`` operators once both are on the trace's base time;

and, on a CUDA device, the same step's graphs with device times: every
replay's events in order, the loop replays' gaps, and the results of the
traced steps equal to the untraced ones.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import altro_tpu_torch as tt  # noqa: E402
from altro_tpu_torch.bench.conic import WARM_OPTS  # noqa: E402
from altro_tpu_torch.models import rocket  # noqa: E402
from altro_tpu_torch.mpc import (gen_tracking_mpc,  # noqa: E402
                                 make_mpc_step_device_compacted)
from altro_tpu_torch.solver import altro  # noqa: E402
from altro_tpu_torch.solver.graph import tensors  # noqa: E402
from altro_tpu_torch.utils import profiling  # noqa: E402

torch.set_num_threads(1)
B, T = 8, 2
# caps and blocks small enough that both levels and both catch-alls engage
SCHED = dict(it_cap=1, block=4, levels=((1, 2),))


@pytest.fixture(scope="module")
def track():
    """The port's cold solve of the rocket's N=41 landing over 15 s."""
    tp = rocket.rocket_problem(N=41, tf=15.0)
    cold = tt.solve(dataclasses.replace(tp, x0=tp.x0[None]), tt.SolverOptions(
        cost_tolerance=1e-5, gradient_tolerance=1e-6,
        constraint_tolerance=1e-4, penalty_initial=1e-2,
        penalty_scaling=500.0, iterations_outer=40, iterations_inner=100),
        U0=rocket.hover_controls(tp)[None])
    return cold.X[0], cold.U[0]


def _step(track, dtype=torch.float64, device="cpu", **sched):
    X_tr, U_tr = (a.to(dtype=dtype, device=device) for a in track)
    pm = gen_tracking_mpc(rocket.rocket_problem(N=41, tf=15.0, dtype=dtype,
                                                device=device),
                          X_tr, U_tr, 11, dt=0.05)
    step, init = make_mpc_step_device_compacted(
        pm, tt.SolverOptions(**WARM_OPTS), X_tr, U_tr,
        noise_model=rocket.rocket_noise_model(), warm_start="track",
        graphed=True, **(sched or SCHED))
    noise = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (T, B, 6)), dtype=dtype, device=device)
    return step, init(B), noise


def _run(step, carry, noise):
    outs, passes = [], []
    for t in range(T):
        before = altro.pass_count
        carry, out = step(carry, noise[t], t)
        outs.append(out)
        passes.append(altro.pass_count - before)
    return carry, outs, passes


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tracer_keeps_the_step_bit_equal(track, dtype):
    step, carry0, noise = _step(track, dtype)
    step(carry0, noise[0], 0)                     # builds the graphs
    plain = _run(step, carry0, noise)
    with profiling.tracing() as tr:
        traced = _run(step, carry0, noise)
    kept = len(tr.spans)
    after = _run(step, carry0, noise)
    assert profiling.tracer is None and len(tr.spans) == kept
    for other in (traced, after):
        for got, want in zip(tensors(other[0]), tensors(plain[0])):
            assert torch.equal(got, want)
        for o, p in zip(other[1], plain[1]):
            for f in dataclasses.fields(p):
                assert torch.equal(getattr(o, f.name), getattr(p, f.name))
    steps = profiling.summarize(tr.records())
    assert [q["name"] for q in steps] == ["step"] * T
    # the block and the sub-block ran past the caps
    assert all(q["loops"]["loop.L2"]["passes"] > 0 for q in steps)
    assert [q["passes"] for q in steps] == traced[2] == plain[2]
    for q in steps:
        assert 0 < q["live_in"] <= q["lane_slots"]
        assert q["graphs_ms"] is None and q["host_part_ms"] > 0


def test_tracer_off_keeps_nothing(track):
    step, carry0, noise = _step(track)
    tr = profiling.Tracer()
    _run(step, carry0, noise)
    assert profiling.tracer is None and len(tr.spans) == 0
    assert tr.records() == []


def test_entering_count_is_the_live_mask(track):
    step, carry0, noise = _step(track)
    step(carry0, noise[0], 0)
    seen = []
    for g in step.sets.values():
        for loop in g.loops:
            def launch(loop=loop, launch=loop.graph.launch):
                seen.append(int(loop._cond(loop.state).sum()))
                launch()
            loop.graph.launch = launch
    with profiling.tracing() as tr:
        _run(step, carry0, noise)
    replays = [r for r in tr.records() if r["name"] == "replay"]
    assert [r["args"]["live_in"] for r in replays] == seen
    assert len(set(seen)) > 2


def test_empty_catch_all_is_one_empty_replay(track):
    """A block as large as the batch takes every unconverged lane, so the
    catch-all after its scatter finds no live lane."""
    step, carry0, noise = _step(track, it_cap=1, block=B)
    with profiling.tracing() as tr:
        _run(step, carry0, noise)
    for q in profiling.summarize(tr.records()):
        rest = q["loops"]["loop.L0.rest"]
        assert (rest["replays"], rest["empty"]) == (1, 1)
        assert q["loops"]["loop.L0"]["empty"] == 0
        assert q["empty_passes"] == 1
    loops = [r for r in tr.records() if r["name"].startswith("loop.")]
    assert [r["args"]["cap"] for r in loops[:3]] == [1, None, None]


def test_spans_share_the_profilers_clock(track, tmp_path):
    step, carry0, noise = _step(track)
    n0 = noise[0]
    step(carry0, n0, 0)
    with profiling.tracing() as tr, torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(carry0, n0, 0)
    prof.export_chrome_trace(str(tmp_path / "torch.json"))
    trace = json.loads((tmp_path / "torch.json").read_text())
    base = int(trace["baseTimeNanoseconds"])
    tr.export(str(tmp_path / "spans.json"), base_ns=base)
    spans = json.loads((tmp_path / "spans.json").read_text())["traceEvents"]
    (st,) = [e for e in spans if e["name"] == "step"]
    assert {e["name"] for e in spans} >= {
        "step", "step.inputs", "graph.start", "loop.L0", "replay", "sync",
        "graph.gather.L0", "loop.L1", "graph.gather.L1", "loop.L2",
        "graph.scatter.L1", "loop.L1.rest", "graph.scatter.L0",
        "loop.L0.rest", "graph.finish", "step.out"}
    ops = [e["ts"] for e in trace["traceEvents"]
           if e.get("ph") == "X" and e.get("name", "").startswith("aten::")]
    assert len(ops) > 100
    slack = 100.0                                 # microseconds
    assert st["ts"] - slack <= min(ops)
    assert max(ops) <= st["ts"] + st["dur"] + slack


@pytest.mark.cuda
def test_device_times_on_the_card(track):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    step, carry0, noise = _step(track, torch.float32, "cuda")
    step(carry0, noise[0], 0)
    plain = _run(step, carry0, noise)
    with profiling.tracing() as tr:
        traced = _run(step, carry0, noise)
    torch.cuda.synchronize()
    for o, p in zip(traced[1], plain[1]):
        for f in ("x0", "U", "status", "iters"):
            assert torch.equal(getattr(o, f), getattr(p, f)), f
    recs = tr.records()
    steps = profiling.summarize(recs)
    assert [q["passes"] for q in steps] == traced[2]
    for q in steps:
        timed = [r for r in recs if r["request"] == q["request"]
                 and r["device"] is not None]
        names = {r["name"] for r in timed}
        assert names >= {"graph.start", "replay", "graph.gather.L0",
                         "graph.scatter.L0", "graph.finish"}
        assert all(0.0 <= r["device"][0] <= r["device"][1] for r in timed)
        starts = [r["device"][0] for r in timed]
        assert starts == sorted(starts)
        assert q["gaps_us"] and min(q["gaps_us"]) >= 0.0
        assert 0.0 < q["graphs_ms"]
