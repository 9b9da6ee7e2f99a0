"""The pass-tail kernel (``altro_tpu_torch/ops/pass_tail.py``,
``csrc/pass_tail.cu``): the tail of a solver pass on the fused-ladder route
after kernel C, written into the loop state in place.

On the CPU: the wrapper runs the plain version and writes its result into
the state (bit for bit the loop body's own tail), freezes by a given live
mask and counts the live lanes; the gate (``solver.altro.uses_pass_tail``)
picks the kernel on a CUDA device for the rocket and grasp problems and the
plain tail elsewhere; the benchmark's reader of its launches; its kernel
name is none of kernels A-D's.

On the card (CUDA-marked): the kernel against the plain version on pass
inputs recorded from the rocket window at B = 1024, 256, 128 and 1 and a
grasp window, as recorded and with frozen lanes, rejected rungs, inf
residuals, an iteration cap, round ends with and without convergence and
SOC rows inside, in the polar and on the boundary. Every int and bool
field, the adopted X and U, K, reg, the gradient metric and rho must be
equal; the multipliers and the violation within the rounding bound of the
kernel's arithmetic around a float64 witness on the same inputs (the
kernel sums the residual rows in another order than the einsum), and equal
to the plain version's where that bound is not finite
(``bench/kernels.py: pass_tail_witness``).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re

import pytest
import torch

from altro_tpu_torch.bench import kernels as kbench
from altro_tpu_torch.bench.flagship import flagship_setup
from altro_tpu_torch.dynamics import LTVDynamics, NonlinearDynamics
from altro_tpu_torch.models import grasp as tgrasp
from altro_tpu_torch.models import rocket as trocket
from altro_tpu_torch.mpc import gen_tracking_mpc
from altro_tpu_torch.ops import pass_tail
from altro_tpu_torch.solver import altro
from altro_tpu_torch.solver.graph import clone_tree
from altro_tpu_torch.solver.options import SolverOptions

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARM = dict(cost_tolerance=1e-6, gradient_tolerance=1e-6,
            constraint_tolerance=1e-4, penalty_initial=1e2,
            penalty_scaling=10.0, reset_duals=True, reset_penalties=True,
            iterations_outer=15, iterations_inner=50, reg_min=1e-8,
            iterations_linesearch=5)


def _leaves(s):
    return pass_tail._leaves(s)


def _rocket_window(dtype=torch.float64, device="cpu", N_mpc=11):
    """The rocket's tracking window along the open-loop hover trajectory of
    the N=41 problem (no cold solve: the window only has to be a rocket
    window)."""
    tp = trocket.rocket_problem(N=41, tf=15.0, dtype=dtype, device=device)
    U_tr = trocket.hover_controls(tp)
    s0 = altro._warmstart_state(dataclasses.replace(tp, x0=tp.x0[None]),
                                SolverOptions(), U_tr[None], None)
    return gen_tracking_mpc(tp, s0[0][0], U_tr, N_mpc, dt=0.05), s0[0][0], U_tr


def _cpu_records(B=8, it_cap=6, dtype=torch.float64):
    """The plain tail's inputs and outputs at every pass of a CPU solve of
    the rocket window on the fused ladder (``ls_fused="on"``)."""
    pm, X_tr, U_tr = _rocket_window(dtype)
    N = pm.N
    g = torch.Generator().manual_seed(0)
    x0 = X_tr[0] + 0.05 * torch.randn((B, pm.n), generator=g,
                                      dtype=X_tr.dtype)
    prob = dataclasses.replace(pm, x0=x0)
    opts = SolverOptions(**dict(WARM, ls_fused="on", iterations_inner=3))
    recs, plain = [], pass_tail.pass_tail_reference

    def record(blocks, o, s, live, *ins, rungs=None):
        out = plain(blocks, o, s, live, *ins, rungs=rungs)
        recs.append((clone_tree(s), live.clone(), clone_tree(ins), rungs,
                     clone_tree(out)))
        return out

    altro.pass_tail_reference = record
    try:
        altro.solve_partial(
            prob, opts, U_tr[:N - 1].expand(B, -1, -1).contiguous(),
            X0=X_tr[:N].expand(B, -1, -1).contiguous(), it_cap=it_cap)
    finally:
        altro.pass_tail_reference = plain
    return prob, opts, recs


@pytest.fixture(scope="module")
def cpu_records():
    return _cpu_records()


@pytest.fixture(scope="module")
def cpu_records32():
    return _cpu_records(dtype=torch.float32)


def _warm_start(prob):
    _, X_tr, U_tr = _rocket_window(prob.x0.dtype)
    B, N = prob.x0.shape[0], prob.N
    return (U_tr[:N - 1].expand(B, -1, -1).contiguous(),
            X_tr[:N].expand(B, -1, -1).contiguous())


def test_wrapper_on_cpu_tensors_runs_the_plain_version(cpu_records):
    """The wrapper on CPU tensors writes the plain version's new state into
    the state's own tensors (bit for bit) and counts the live lanes."""
    prob, opts, recs = cpu_records
    assert len(recs) == 6
    for s, live, ins, rungs, want in recs:
        assert rungs is None                      # the fused ladder's tail
        Knew, dff, dV1, dV2, Xts, Uts, Jts, alphas, _ = ins
        got = clone_tree(s)
        before = [t.data_ptr() for t in _leaves(got)]
        counts = torch.zeros(2, dtype=torch.int32)
        ret = pass_tail.al_pass_tail(
            prob.constraints, opts, got, Knew, dff, dV1, dV2, Xts, Uts, Jts,
            alphas.tolist(), it_cap=6, counts=counts)
        assert ret is got
        assert [t.data_ptr() for t in _leaves(got)] == before
        for a, b in zip(_leaves(got), _leaves(want)):
            assert torch.equal(a, b)
        assert counts.tolist() == [
            int(live.sum()), int(pass_tail.live_mask(want, opts, 6).sum())]
    # the solve moved: some lane took a rung, some lane ended a round
    assert any(not torch.equal(r[0][0], r[4][0]) for r in recs)
    assert any(bool((r[4][9] > r[0][9]).any()) for r in recs)


def test_wrapper_freezes_by_the_callers_live_mask(cpu_records):
    prob, opts, recs = cpu_records
    s, _, ins, _, _ = recs[1]
    Knew, dff, dV1, dV2, Xts, Uts, Jts, alphas, lanes = ins
    live = torch.arange(s[0].shape[0]) % 2 == 0
    want = pass_tail.pass_tail_reference(prob.constraints, opts, s, live,
                                         *ins)
    got = pass_tail.al_pass_tail(prob.constraints, opts, clone_tree(s),
                                 Knew, dff, dV1, dV2, Xts, Uts, Jts,
                                 alphas.tolist(), live=live)
    for a, b, old in zip(_leaves(got), _leaves(want), _leaves(s)):
        assert torch.equal(a, b)
        assert torch.equal(a[~live], old[~live])
    assert bool((got[8][live] == s[8][live] + 1).all())


def test_wrapper_refuses_mismatched_state(cpu_records):
    prob, opts, recs = cpu_records
    s, _, ins, _, _ = recs[0]
    Knew, dff, dV1, dV2, Xts, Uts, Jts, alphas, _ = ins
    bad = list(s)
    bad[7] = bad[7].to(torch.int64)
    with pytest.raises(ValueError, match="it_rd"):
        pass_tail.al_pass_tail(prob.constraints, opts, tuple(bad), Knew, dff,
                               dV1, dV2, Xts, Uts, Jts, alphas.tolist())
    with pytest.raises(ValueError, match="Jts"):
        pass_tail.al_pass_tail(prob.constraints, opts, s, Knew, dff, dV1,
                               dV2, Xts, Uts, Jts[:, :-1], alphas.tolist())


def test_forced_route_on_cpu_gives_the_plain_routes_bits(
        monkeypatch, cpu_records):
    """With the gate forced on the CPU the loop body takes the wrapper (the
    plain version written into the state in place): the eager solve and the
    fixed-buffer loop (the in-place passes and their live counts) give the
    plain route's bits, replays and passes, and the caller's warm start is
    left as it was."""
    from altro_tpu_torch.solver import graph
    prob, opts, _ = cpu_records
    _, X_tr, U_tr = _rocket_window()
    B, N = prob.x0.shape[0], prob.N
    U0 = U_tr[:N - 1].expand(B, -1, -1).contiguous()
    X0 = X_tr[:N].expand(B, -1, -1).contiguous()
    kept = U0.clone()

    def run():
        passes = altro.pass_count
        eager = altro.solve(prob, opts, U0, X0=X0)
        gs = graph.GraphedSolve(prob, opts, states=True)
        fixed = gs(U0=U0, X0=X0)
        return eager, fixed, gs.replays, altro.pass_count - passes

    plain = run()
    monkeypatch.setattr(altro, "uses_pass_tail", lambda *a: True)
    launches = pass_tail.launch_count
    forced = run()
    assert pass_tail.launch_count == launches    # the CPU runs no kernel
    assert forced[2:] == plain[2:]
    for a, b in zip(forced[:2], plain[:2]):
        for x, y in zip(graph.tensors(a), graph.tensors(b)):
            assert torch.equal(x, y)
    assert torch.equal(U0, kept)
    assert int(plain[0].stats.iterations.max()) > 3


def _gate_problem(name):
    pm, _, _ = _rocket_window()
    if name in ("rocket", "rocket ls off", "rocket split"):
        return pm
    if name == "grasp":
        o = tgrasp.make_grasp_object(61, 6.0)
        return tgrasp.grasp_problem(o, 61, 6.0)
    if name == "flagship":
        return flagship_setup(8, 1, dtype=torch.float64,
                              device="cpu").prob_mpc
    dyn = pm.dynamics
    if name == "per-lane dynamics":
        lanes = lambda t: t[None].expand((4,) + t.shape).contiguous()
        return dataclasses.replace(pm, dynamics=LTVDynamics(
            A=lanes(dyn.A), B=lanes(dyn.B), d=lanes(dyn.d)))
    if name == "per-lane blocks":
        c = pm.constraints[0]
        lanes = lambda t: t[None].expand((4,) + t.shape).contiguous()
        return dataclasses.replace(pm, constraints=(dataclasses.replace(
            c, Cx=lanes(c.Cx), Cu=lanes(c.Cu), b=lanes(c.b)),)
            + pm.constraints[1:])
    if name == "nonlinear dynamics":
        return dataclasses.replace(pm, dynamics=NonlinearDynamics(
            f=lambda p, x, u, k: p[0][k] @ x + p[1][k] @ u + p[2][k],
            params=(dyn.A, dyn.B, dyn.d), n_=pm.n, m_=pm.m, N_=pm.N))
    raise KeyError(name)


GATE = {"rocket": (True, {}), "grasp": (True, {}), "flagship": (False, {}),
        "per-lane dynamics": (False, {}), "per-lane blocks": (False, {}),
        "nonlinear dynamics": (False, {}),
        "rocket ls off": (False, dict(ls_fused="off")),
        "rocket split": (False, dict(fused_expansion=False))}


@pytest.mark.parametrize("device_type", ["cuda", "cpu"])
@pytest.mark.parametrize("name", sorted(GATE))
def test_gate(name, device_type):
    """The kernel on a CUDA device where B and C both run on shared data
    (the rocket's three SOC blocks, grasp's five blocks); the plain tail
    for the flagship's single block (the classical ladder on "auto"),
    per-lane data, nonlinear dynamics, the split route, ls_fused off and
    the CPU."""
    want, kw = GATE[name]
    prob = _gate_problem(name)
    opts = SolverOptions(**kw)
    assert altro.uses_pass_tail(opts, prob, device_type) == (
        want and device_type == "cuda")


def test_cpu_loop_takes_the_plain_tail(cpu_records):
    prob, opts, _ = cpu_records
    s = altro._warmstart_state(prob, opts, None, None)
    ctx, _, _ = altro.loop_fns(prob, opts, s)
    assert not ctx.pass_tail and ctx.packed is None


def test_kernel_name_is_glue():
    """The kernel's name carries none of kernels A-D's keys, so the
    benchmark counts it as glue and no roofline share absorbs it."""
    from benchmark.metrics import _kinds
    src = open(os.path.join(ROOT, "altro_tpu_torch", "csrc",
                            "pass_tail.cu")).read()
    names = re.findall(r"__global__ void(?: __launch_bounds__\(\w+\))? (\w+)",
                       src)
    assert names == ["al_pass_tail_kernel"]
    for name in names + [f"void (anonymous namespace)::{names[0]}<float>("
                         "(anonymous namespace)::Tail<float>)"]:
        assert _kinds.kind_of(name) not in _kinds.HAND_WRITTEN
        assert "al_pass_tail" in name.lower()


def test_launches_per_pass_reader(tmp_path):
    """``benchmark/metrics/pass_tail.launches_per_pass.py``: launches whose
    name holds ``al_pass_tail`` over the traced passes; 0 where none ran,
    nothing without a trace."""
    from benchmark import trace
    from benchmark.metrics import reader

    def kernel(name, ts):
        return {"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                "dur": 2.0, "pid": 0, "tid": 7, "args": {"grid": [4, 1, 1]}}
    host = {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
            "ts": 0.0, "dur": 1.0, "pid": 1, "tid": 1}
    events = [host] + [kernel(n, 10.0 * i + 5) for i, n in enumerate(
        ["void al_pass_tail_kernel<float>(Tail<float>)",
         "ls_rollout_al_kernel<float, 16, 1>",
         "void al_pass_tail_kernel<float>(Tail<float>)",
         "elementwise_kernel"])]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))

    class R:
        pass
    r = R()
    r.trace = trace.load(str(path), passes=2, steps=1)
    read = reader("pass_tail.launches_per_pass").read
    assert read(r) == pytest.approx(1.0)
    r.trace.ops = [o for o in r.trace.ops if "al_pass_tail" not in o.name]
    assert read(r) == 0.0
    r.trace = None
    assert read(r) is None


def test_pass_fns_body_is_the_tail_of_the_head(cpu_records):
    """``loop_fns``' body is ``pass_fns``' tail of its head: one pass each
    way from the same state gives the same bits, and each counts once."""
    prob, opts, recs = cpu_records
    s = recs[1][0]
    _, _, body = altro.loop_fns(prob, opts, s, it_cap=6)
    _, _, head, tail = altro.pass_fns(prob, opts, s, it_cap=6)
    passes = altro.pass_count
    a = body(clone_tree(s))
    b = tail(clone_tree(s), head(s))
    assert altro.pass_count == passes + 2
    for x, y in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x, y)


def test_records_replay_the_solve(cpu_records):
    """``bench/kernels.py: pass_tail_records`` holds every pass of the
    eager solve: the wrapper on each record gives the next record's state,
    and on the last the capped solve's own."""
    prob, opts, _ = cpu_records
    U0, X0 = _warm_start(prob)
    recs = kbench.pass_tail_records(prob, opts, U0, X0, it_cap=6)
    final = altro.solve_partial(prob, opts, U0, X0=X0, it_cap=6)
    assert len(recs) == 6
    for (s, ins, kw), nxt in zip(recs, [r[0] for r in recs[1:]] + [final]):
        got = pass_tail.al_pass_tail(prob.constraints, opts, clone_tree(s),
                                     *ins, **kw)
        for a, b in zip(_leaves(got), _leaves(nxt)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("kernel", [False, True])
def test_pass_tail_solve_takes_the_route_from_the_context(cpu_records,
                                                          kernel):
    """``bench/kernels.py: pass_tail_solve`` sets the tail by the loop
    context alone; on the CPU the wrapper writes the plain version's bits
    in place, so either way the solve ends in the plain solve's state and
    the caller's warm start is left as it was."""
    prob, opts, _ = cpu_records
    U0, X0 = _warm_start(prob)
    kept = U0.clone()
    s = kbench.pass_tail_solve(prob, opts, U0, X0, kernel)
    sol = altro.solve(prob, opts, U0, X0=X0)
    for a, b in ((s[0], sol.X), (s[1], sol.U), (s[8], sol.stats.iterations),
                 (s[10].to(torch.int32), sol.stats.status)):
        assert torch.equal(a, b)
    assert torch.equal(U0, kept)


def _cpu_passes(prob, opts, recs):
    """(state, live, inputs, plain output) of each recorded pass, as
    recorded and at a round end (every lane's it_rd one short of the inner
    cap), so that the multipliers of the accepted lanes are written."""
    for s, live, ins, _, want in recs:
        ins = ins[:7] + (tuple(ins[7].tolist()),)
        yield s, live, ins, want
        s = clone_tree(s)
        s[7].fill_(opts.iterations_inner - 1)
        lanes = torch.arange(s[0].shape[0])
        alphas = torch.tensor(ins[7], dtype=s[0].dtype)
        yield s, live, ins, pass_tail.pass_tail_reference(
            prob.constraints, opts, s, live, *ins[:7], alphas, lanes)


def test_witness_holds_the_plain_version(cpu_records32):
    """The float64 witness's rounding bound holds the plain float32 version
    on the CPU (the einsum's summation order) at every recorded pass and at
    a round end after it, and the plain version against itself reads 0."""
    prob, opts, recs = cpu_records32
    written = 0
    for s, live, ins, want in _cpu_passes(prob, opts, recs):
        wit = kbench.pass_tail_witness(prob.constraints, opts, s, live, ins,
                                       want)
        dist = kbench.pass_tail_distance(want, want, wit)
        assert dist["lam"] == 0.0 and dist["viol"] == 0.0
        assert dist["lam_plain"] <= 1.0 and dist["viol_plain"] <= 1.0, dist
        written += sum(int((b > 0).sum()) for b in wit[2])
    assert written > 0


def test_witness_catches_planted_faults(cpu_records32):
    """A multiplier moved by ten times its bound, a multiplier moved where
    the plain version keeps it, and a violation zeroed on a lane whose
    residuals are not finite each fail the gate."""
    prob, opts, recs = cpu_records32
    passes = list(_cpu_passes(prob, opts, recs))
    for k, (s, live, ins, want) in enumerate(passes[:2]):
        # the recorded pass writes no multiplier, its round end does
        wit = kbench.pass_tail_witness(prob.constraints, opts, s, live, ins,
                                       want)
        i = max(range(len(wit[2])), key=lambda j: float(wit[2][j].max()))
        bound = wit[2][i]
        assert (float(bound.max()) > 0) == (k == 1)
        where = bound == bound.max()
        step = 10.0 * float(bound.max()) if k else 1e-3
        got = clone_tree(want)
        lam = got[3][i].lam
        at = tuple(a[0] for a in torch.nonzero(where, as_tuple=True))
        lam[at] = lam[at] + step
        assert kbench.pass_tail_distance(got, want, wit)["lam"] > 1.0
    s, live, ins, want = passes[1]

    # a non-finite state at an active knot of lane 0, at a round end
    s2, ins2 = clone_tree(s), list(clone_tree(ins))
    s2[0][0, 5, 0] = float("inf")
    ins2[4][0, :, 5, 0] = float("inf")
    s2[7].fill_(opts.iterations_inner - 1)
    lanes = torch.arange(s2[0].shape[0])
    alphas = torch.tensor(ins2[7], dtype=s2[0].dtype)
    want2 = pass_tail.pass_tail_reference(prob.constraints, opts, s2, live,
                                          *ins2[:7], alphas, lanes)
    wit2 = kbench.pass_tail_witness(prob.constraints, opts, s2, live,
                                    tuple(ins2), want2)
    assert bool(live[0]) and math.isnan(float(wit2[3][0]))
    assert not bool(torch.isfinite(want2[6][0]))
    assert kbench.pass_tail_distance(want2, want2, wit2)["viol"] == 0.0
    got = clone_tree(want2)
    got[6][0] = 0.0
    assert kbench.pass_tail_distance(got, want2, wit2)["viol"] == math.inf


def test_pass_tail_work_counts_what_runs():
    """Frozen lanes cost their counters alone; a live lane its reads and
    writes, more where its rung is accepted and its duals written."""
    N, n, m, P, nb, L = 21, 6, 3, 15, 3, 6
    shared = N * P * (n + m + 2) * 4
    frozen = kbench.pass_tail_work(N, n, m, P, nb, L, 4, (8, 0, 0, 0, 0, 0))
    assert frozen == (shared + 16 * 8, 0)
    live = kbench.pass_tail_work(N, n, m, P, nb, L, 4, (8, 8, 0, 0, 0, 0))
    most = kbench.pass_tail_work(N, n, m, P, nb, L, 4, (8, 8, 8, 8, 8, 8))
    assert frozen[0] < live[0] < most[0]
    assert live[1] == most[1] == 8 * N * P * (2 * (n + m) + 8)


# ---------------------------------------------------------------- the card

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def setups(card):
    from altro_tpu_torch.bench import conic
    return {"rocket": conic.rocket_setup(torch.float32, device=card),
            "grasp": conic.grasp_setup(torch.float32, device=card)}


_RECORDS = {}


def _records(setups, family, B):
    """Pass inputs recorded from an eager solve of the family's window 0 at
    B lanes, x0 the track's first state under the family's noise: (prob,
    opts, [(state, inputs, keywords)] at four passes)."""
    if (family, B) not in _RECORDS:
        su = setups[family]
        pm, N = su.prob_mpc, su.prob_mpc.N
        g = torch.Generator().manual_seed(B)
        noise = torch.randn((B, pm.n), generator=g).to(pm.x0)
        x0 = su.noise_model(su.X_track[0].expand(B, -1), noise)
        prob = dataclasses.replace(pm, x0=x0)
        recs = kbench.pass_tail_records(
            prob, su.opts, su.U_track[:N - 1].expand(B, -1, -1).contiguous(),
            su.X_track[:N].expand(B, -1, -1).contiguous(), it_cap=24)
        pick = sorted({0, 1, len(recs) // 2, len(recs) - 1})
        _RECORDS[family, B] = (prob, su.opts, [recs[i] for i in pick])
    return _RECORDS[family, B]


def _equal(got, want, what):
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    assert bool(same.all()), f"{what}: {int((~same).sum())} entries differ"


def _apply_case(case, prob, opts, s, ins, kw):
    """The case's inputs from a recorded pass (clones; the record stays)."""
    s, ins = clone_tree(s), list(clone_tree(ins))
    kw = dict(kw)
    B = s[0].shape[0]
    lanes = torch.arange(B, device=s[0].device)
    X, U, K, duals, reg, grad, viol, it_rd, it, rounds, done = s
    Xts, Uts, Jts = ins[4], ins[5], ins[6]
    if case == "frozen":
        done[lanes % 3 == 0] = True
        rounds[lanes % 5 == 1] = opts.iterations_outer
    elif case == "rejected":
        # no rung decreases the merit (even lanes), or every rung but the
        # last is NaN (lanes 1 mod 4): the alpha = 0 rung is adopted
        worse = Jts[:, -1:] + Jts[:, -1:].abs() + 1.0
        Jts[lanes % 2 == 0, :-1] = worse[lanes % 2 == 0]
        Jts[lanes % 4 == 1, :-1] = float("nan")
    elif case == "inf":
        # an inf state at an active knot (lanes 0 mod 3) and at the masked
        # terminal knot (lanes 1 mod 3), in every rung and in the kept X
        for sel, k in ((lanes % 3 == 0, 5), (lanes % 3 == 1, X.shape[1] - 1)):
            X[sel, k, 0] = float("inf")
            Xts[sel, :, k, 0] = float("inf")
        it_rd.fill_(opts.iterations_inner - 1)
    elif case == "cap":
        kw["it_cap"] = it.median().to(torch.int32).add(1).reshape(())
        kw["counts"] = torch.zeros(2, dtype=torch.int32, device=X.device)
    elif case in ("round end, converged", "round end, not converged"):
        it_rd.fill_(opts.iterations_inner - 1)
        opts = dataclasses.replace(opts, constraint_tolerance=(
            1e30 if case == "round end, converged" else 0.0))
    elif case == "soc":
        # z = lam + rho c inside (lanes 0 mod 3), in the polar (1 mod 3)
        # and on the boundary (2 mod 3) of the SOC blocks, the trajectories
        # scaled per lane so that c crosses the cones too; a round end, so
        # the multipliers are written
        g = torch.Generator().manual_seed(B)
        f = (1.0 + 0.3 * torch.randn((B, 1, 1, 1), generator=g)).to(X)
        Xts.mul_(f)
        Uts.mul_(f)
        X.mul_(f[:, 0])
        U.mul_(f[:, 0])
        for con, dual in zip(prob.constraints, duals):
            if con.cone.value == "soc":
                dual.lam[lanes % 3 == 0, :, -1] += 1e6
                dual.lam[lanes % 3 == 1, :, -1] -= 1e6
                dual.lam[lanes % 3 == 2, :, 0] += 1e6
        it_rd.fill_(opts.iterations_inner - 1)
    elif case != "recorded":
        raise KeyError(case)
    return opts, s, tuple(ins), kw


def _soc_regions(prob, s, want):
    """Counts of z = lam + rho c inside, in the polar of and on the
    boundary of the SOC blocks, at the adopted trajectory."""
    counts = torch.zeros(3, dtype=torch.int64)
    for con, dual in zip(prob.constraints, s[3]):
        if con.cone.value != "soc":
            continue
        z = dual.lam + dual.rho[..., None] * con.evaluate(want[0], want[1])
        a = torch.linalg.vector_norm(z[..., :-1], dim=-1)
        inside, polar = a <= z[..., -1], a <= -z[..., -1]
        counts += torch.stack([inside.sum(), polar.sum(),
                               (~(inside | polar)).sum()]).cpu()
    return counts


CASES = ["recorded", "frozen", "rejected", "inf", "cap",
         "round end, converged", "round end, not converged", "soc"]
SHAPES = [("rocket", 1024), ("rocket", 256), ("rocket", 128), ("rocket", 1),
          ("grasp", 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("family,B", SHAPES)
def test_kernel_matches_plain_version_on_the_card(setups, family, B, case):
    prob, opts0, recs = _records(setups, family, B)
    for s_rec, ins_rec, kw_rec in recs:
        opts, s, ins, kw = _apply_case(case, prob, opts0, s_rec, ins_rec,
                                       kw_rec)
        Knew, dff, dV1, dV2, Xts, Uts, Jts, alphas_t = ins
        live = pass_tail.live_mask(s, opts, kw["it_cap"])
        lanes = torch.arange(B, device=s[0].device)
        want = pass_tail.pass_tail_reference(
            prob.constraints, opts, s, live, Knew, dff, dV1, dV2, Xts, Uts,
            Jts, torch.tensor(alphas_t, dtype=Xts.dtype,
                              device=Xts.device), lanes)
        got = clone_tree(s)
        launches = pass_tail.launch_count
        pass_tail.al_pass_tail(prob.constraints, opts, got, *ins, **kw)
        assert pass_tail.launch_count == launches + int(Xts.is_cuda)
        X, U, K, duals, *rest = got
        wX, wU, wK, wduals, *wrest = want
        for name, a, b in zip(("X", "U", "K"), (X, U, K), (wX, wU, wK)):
            _equal(a, b, name)
        for name, a, b in zip(("reg", "grad", "viol", "it_rd", "it",
                               "rounds", "done"), rest, wrest):
            if name != "viol":
                _equal(a, b, name)
        for i, (d, w) in enumerate(zip(duals, wduals)):
            _equal(d.rho, w.rho, f"rho{i}")
        dist = kbench.pass_tail_distance(got, want, kbench.pass_tail_witness(
            prob.constraints, opts, s, live, ins, want))
        assert dist["lam"] <= 1.0 and dist["viol"] <= 1.0, dist
        if kw.get("counts") is not None:
            assert kw["counts"].tolist() == [
                int(live.sum()),
                int(pass_tail.live_mask(want, opts, kw["it_cap"]).sum())]
        if case == "frozen":
            frozen = ~live
            assert bool(frozen.any())
            for a, b in zip(_leaves(got), _leaves(s)):
                _equal(a[frozen], b[frozen], "a frozen lane")
        if case == "soc" and B >= 3:
            assert bool((_soc_regions(prob, s, want) > 0).all())
