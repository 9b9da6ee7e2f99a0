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
- every ``loop.*`` span counts one pass per replay, its ``check_every``
  the constant 1;
- the exported spans share ``torch.profiler``'s clock: a step's span holds
  its ``aten::`` operators once both are on the trace's base time;
- each loop graph's ``capture`` span names the body kernel B takes in its
  passes (the plain version on the CPU; on the card, the rocket's m <= 8
  body and the trot's narrow body above m = 8);
- on a step whose dynamics window moves and is grouped (the quadruped
  trot's, ``mpc.make_mpc_step(dynamics_fn=...)``), a ``step.dynamics`` span
  inside ``step.inputs`` with the window's bytes, and on ``step.out`` the
  group count and each group's lane-max iterations, the results' own;
  neither on the rocket's fixed, ungrouped step; the benchmark's two
  readers of them (``group_wait_pct``, ``dynamics_us_per_step``) on a
  hand-built span list;

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
from altro_tpu_torch.models.quadruped import (config, controller,  # noqa
                                              episode)
from altro_tpu_torch.mpc import (gen_tracking_mpc,  # noqa: E402
                                 make_mpc_step,
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
        for loop in g.levels.loops:
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


def test_loop_spans_are_one_pass_per_replay(track):
    """Every ``loop.*`` span of the compacted step (every level and
    catch-all) counts one pass per replay, and keeps ``check_every`` as
    the constant 1 that the benchmark's span reader multiplies by."""
    step, carry0, noise = _step(track)
    with profiling.tracing() as tr:
        _run(step, carry0, noise)
    loops = [r for r in tr.records() if r["name"].startswith("loop.")]
    assert {r["name"] for r in loops} == {
        "loop.L0", "loop.L1", "loop.L2", "loop.L0.rest", "loop.L1.rest"}
    for r in loops:
        a = r["args"]
        assert a["check_every"] == 1 and a["passes"] == a["replays"] > 0


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


def _trot_step(groups=2, lanes=2, device="cpu"):
    """The trot's grouped step (offset 350 ms) in float64 on the
    fixed-buffer route (on a CUDA ``device``, its graphs), its initial
    carry and two steps' noise."""
    from altro_tpu_torch.convert import tree_to

    cfg = config.MPCConfig(linearized_friction=False)
    prob, x_des = controller.build_mpc_problem(cfg, torch.float64)
    windows = episode.trot_windows(cfg, prob, T + 1, groups, 350)
    N = cfg.N
    if device != "cpu":
        prob, x_des = tree_to((prob, x_des), device)
        windows = windows.to(device, torch.float64)
    step, init = make_mpc_step(
        prob, tt.SolverOptions(cost_tolerance=1e-4, penalty_initial=10.0,
                               penalty_scaling=100.0),
        x_des.expand(N, 12),
        torch.zeros((N - 1, 12), dtype=torch.float64, device=device),
        noise_model=lambda x, e: x + 0.005 * e, graphed=True,
        dynamics_fn=windows)
    noise = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (T, groups * lanes, 12)), device=device)
    return step, init(groups * lanes), noise


def _loop_captures(step, carry0, noise) -> list:
    """The ``capture`` spans' arguments of the loop graphs that the first
    call of ``step`` builds."""
    with profiling.tracing() as tr:
        step(carry0, noise[0], 0)
    return [r["args"] for r in tr.records()
            if r["name"] == "capture" and r["args"]["graph"] == "loop"]


def test_loop_capture_spans_name_kernel_b_body(track):
    """Each loop graph's ``capture`` span names the body kernel B takes in
    its passes (``solver.altro.b_body``): on the CPU the plain version,
    at the rocket's and the trot's shapes; the split route runs no B."""
    caps = _loop_captures(*_step(track))
    assert len(caps) >= 3 and all(a["b_body"] == "plain" for a in caps)
    caps = _loop_captures(*_trot_step())
    assert caps and all(a["b_body"] == "plain" for a in caps)
    prob = rocket.rocket_problem(N=11, tf=5.0)
    opts = tt.SolverOptions(**WARM_OPTS)
    assert altro.b_body(prob, opts, "cpu") == "plain"
    split = dataclasses.replace(opts, fused_expansion=False)
    assert altro.b_body(prob, split, "cuda") is None


def test_grouped_dynamics_spans():
    G, lanes = 2, 2
    step, carry0, noise = _trot_step(G, lanes)
    with profiling.tracing() as tr:
        _, outs, _ = _run(step, carry0, noise)
    recs = tr.records()
    by_id = {r["id"]: r for r in recs}
    # the window (15 knots' stacks less one) and the plant's first knot
    nbytes = 8 * G * 15 * (12 * 12 + 12 * 12 + 12)
    for t, out in enumerate(outs):
        mine = [r for r in recs if r["request"] == t]
        (dyn,) = [r for r in mine if r["name"] == "step.dynamics"]
        assert by_id[dyn["parent"]]["name"] == "step.inputs"
        assert dyn["args"] == {"bytes": nbytes} and dyn["dur"] > 0
        (so,) = [r for r in mine if r["name"] == "step.out"]
        assert so["args"]["groups"] == G
        assert so["args"]["group_iters"] == out.iters.reshape(
            G, lanes).amax(dim=1).tolist()
        assert min(so["args"]["group_iters"]) > 0


def test_fixed_ungrouped_step_has_neither(track):
    step, carry0, noise = _step(track)
    with profiling.tracing() as tr:
        _run(step, carry0, noise)
    recs = tr.records()
    assert not [r for r in recs if r["name"] == "step.dynamics"]
    outs = [r for r in recs if r["name"] == "step.out"]
    assert len(outs) == T and all(r["args"] == {} for r in outs)


def _span(id_, name, parent, request, dur, **args):
    return {"id": id_, "name": name, "parent": parent, "request": request,
            "ts": 0.0, "dur": dur, "device": None, "args": args}


def test_group_readers_on_hand_built_spans():
    from types import SimpleNamespace

    from benchmark.metrics import reader

    recs = [_span(0, "step", None, 0, 1000.0),
            _span(1, "step.inputs", 0, 0, 80.0),
            _span(2, "step.dynamics", 1, 0, 40.0, bytes=100),
            _span(3, "step.out", 0, 0, 20.0, groups=2, group_iters=[3, 5]),
            _span(4, "step", None, 1, 900.0),
            _span(5, "step.dynamics", 4, 1, 60.0, bytes=100),
            _span(6, "step.out", 4, 1, 20.0, groups=2, group_iters=[4, 4]),
            # a request outside the window (the profiler's stretch)
            _span(7, "step", None, 2, 900.0),
            _span(8, "step.dynamics", 7, 2, 500.0, bytes=100),
            _span(9, "step.out", 7, 2, 20.0, groups=2, group_iters=[1, 9])]
    res = SimpleNamespace(spans={"records": recs, "window": {0: 0, 1: 1}})
    # (3 + 5 + 4 + 4) group-iterations of 2 x 5 + 2 x 4 at the slowest
    assert reader("group_wait_pct").read(res) == pytest.approx(
        100.0 * (1.0 - 16.0 / 18.0))
    assert reader("dynamics_us_per_step").read(res) == pytest.approx(50.0)
    plain = SimpleNamespace(spans={"records": [
        r for r in recs if r["name"] != "step.dynamics" and r["id"] not in
        (3, 6, 9)] + [_span(3, "step.out", 0, 0, 20.0)], "window": {0: 0}})
    for name in ("group_wait_pct", "dynamics_us_per_step"):
        assert reader(name).read(plain) is None
        assert reader(name).read(SimpleNamespace(spans=None)) is None


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


@pytest.mark.cuda
def test_capture_spans_name_the_card_body(track):
    """On the card the loop graphs' ``capture`` spans name the kernel's
    own choice: the m <= 8 body at the rocket's m = 3, the narrow body
    above m = 8 at the trot's m = 12."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    caps = _loop_captures(*_step(track, torch.float32, "cuda"))
    assert caps and all(a["b_body"] == "narrow_m8" for a in caps)
    caps = _loop_captures(*_trot_step(device="cuda"))
    assert caps and all(a["b_body"] == "narrow_m16" for a in caps)
