"""The plain reference against hand-built cases: the barrier solver on
problems with known minimizers, the condensed tracking problem against a
direct KKT solve, the rocket's exact discretization, the TF32 rounding of
the control, and the rocket track's data file."""
from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from benchmark.reference import ipm, rocket
from benchmark.reference.ipm import F64, TF32
from benchmark.reference.tracking import RowBlock, TrackingMPC

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIGS = os.path.join(os.path.dirname(HERE), "configs")


def _spec(name):
    with open(os.path.join(CONFIGS, name + ".json")) as fh:
        return json.load(fh)


def _dt(*a):
    return torch.tensor(a, dtype=torch.float64)


def test_unconstrained_minimum():
    """A box far from the minimizer: z = -P^-1 p."""
    rng = np.random.default_rng(0)
    G = rng.standard_normal((4, 4))
    P = torch.as_tensor(G @ G.T + 4 * np.eye(4))
    p = torch.as_tensor(rng.standard_normal((2, 4)))
    eye = torch.eye(4, dtype=torch.float64)
    box = ipm.Block("nonneg", torch.cat([eye, -eye])[None],
                    torch.full((2, 1, 8), 100.0, dtype=torch.float64))
    z = ipm.solve(ipm.ConicQP(P, p, [box]), torch.zeros(2, 4))
    want = -torch.linalg.solve(P, p.T).T
    assert torch.allclose(z, want, atol=1e-7)


def test_box_clips_at_bound():
    """min 0.5 (u - 5)^2 s.t. |u| <= 3: u = 3; and u - 1 inside: u = 1."""
    P = torch.ones((1, 1), dtype=torch.float64)
    p = _dt([-5.0], [-1.0])
    box = ipm.Block("nonneg", _dt([-1.0], [1.0])[None],
                    torch.full((2, 1, 2), 3.0, dtype=torch.float64))
    z = ipm.solve(ipm.ConicQP(P, p, [box]), torch.zeros(2, 1))
    assert torch.allclose(z[:, 0], _dt(3.0, 1.0), atol=1e-8)


def test_soc_projection():
    """min 0.5 ||u - a||^2 s.t. ||u|| <= r: u = r a / ||a|| when ||a|| > r,
    a otherwise."""
    a = _dt([3.0, 4.0, 0.0], [0.1, -0.2, 0.3])
    r = 2.0
    M = torch.cat([torch.eye(3, dtype=torch.float64),
                   torch.zeros((1, 3), dtype=torch.float64)])[None]
    h = _dt(0.0, 0.0, 0.0, r).expand(2, 1, 4).clone()
    qp = ipm.ConicQP(torch.eye(3, dtype=torch.float64), -a,
                     [ipm.Block("soc", M, h)])
    z = ipm.solve(qp, torch.zeros(2, 3))
    assert torch.allclose(z[0], r * a[0] / a[0].norm(), atol=1e-7)
    assert torch.allclose(z[1], a[1], atol=1e-9)


def test_phase_one_from_an_infeasible_start():
    """The start violates the cone; phase I finds the interior and the
    solve the projection of a point onto {||v|| <= t}."""
    pt = _dt([3.0, 0.0, 1.0])                  # (v, t) with ||v|| > t
    qp = ipm.ConicQP(torch.eye(3, dtype=torch.float64), -pt,
                     [ipm.Block("soc", torch.eye(3, dtype=torch.float64)[None],
                                torch.zeros((1, 1, 3), dtype=torch.float64))])
    z = ipm.solve(qp, pt.clone())
    # projection onto the cone: ((|v| + t) / 2) (v / |v|, 1)
    assert torch.allclose(z[0], _dt(2.0, 0.0, 2.0), atol=1e-6)


def test_infeasible_lane_is_nan():
    """u >= 1 and u <= -1: no point; the lane returns NaN."""
    box = ipm.Block("nonneg", _dt([1.0], [-1.0])[None],
                    _dt([-1.0, -1.0])[None])
    qp = ipm.ConicQP(torch.ones((1, 1), dtype=torch.float64), _dt([0.0]),
                     [box])
    assert torch.isnan(ipm.solve(qp, torch.zeros(1, 1))).all()


def _additive_noise(x, noise, ar):
    return x + noise


def _small_mpc(blocks):
    dt = 0.1
    A = _dt([1.0, dt], [0.0, 1.0])
    B = _dt([0.5 * dt * dt], [dt])
    X = torch.stack([_dt(1.0 - 0.1 * k, 0.0) for k in range(12)])
    return TrackingMPC(
        A=A, B=B, d=_dt(0.0, -0.01), Q=torch.eye(2, dtype=torch.float64),
        R=0.1 * torch.eye(1, dtype=torch.float64),
        Qf=10 * torch.eye(2, dtype=torch.float64), X_track=X,
        U_track=torch.zeros((11, 1), dtype=torch.float64), N=5,
        blocks=blocks, noise_model=_additive_noise)


def test_condensing_matches_the_rollout():
    mpc = _small_mpc([])
    Phi, G, c = mpc.condensed()
    x0 = _dt([0.3, -0.2], [1.0, 0.5])
    U = torch.as_tensor(np.random.default_rng(1).standard_normal((2, 4, 1)))
    X = mpc.rollout(x0, U)
    Xc = (torch.einsum("kij,lj->lki", Phi, x0) + c
          + torch.einsum("kiz,lz->lki", G, U.reshape(2, -1)))
    assert torch.allclose(X, Xc, atol=1e-12)


def test_unconstrained_window_is_the_kkt_solution():
    """No active cone: the window's solution solves the equality-constrained
    QP in (x, u) directly (one KKT system)."""
    mpc = _small_mpc([RowBlock("nonpos", torch.zeros((1, 2)),
                               torch.ones((1, 1)), _dt(-100.0),
                               range(4))])
    x0, k = _dt(0.9, 0.1), torch.tensor([2])
    U = mpc.solve(x0[None], k, torch.zeros((1, 4, 1)))[0]
    # KKT in w = (x_0..x_4, u_0..u_3)
    N, n, m = 5, 2, 1
    nw = N * n + (N - 1) * m
    H = torch.zeros((nw, nw), dtype=torch.float64)
    g = torch.zeros(nw, dtype=torch.float64)
    Xw, Uw = mpc.window(k)
    for i in range(N):
        Qi = mpc.Qf if i == N - 1 else mpc.Q
        H[i * n:(i + 1) * n, i * n:(i + 1) * n] = Qi
        g[i * n:(i + 1) * n] = -Qi @ Xw[0, i]
    for i in range(N - 1):
        j = N * n + i * m
        H[j:j + m, j:j + m] = mpc.R
        g[j:j + m] = -mpc.R @ Uw[0, i]
    rows = [torch.cat([torch.eye(n), torch.zeros((n, nw - n))], 1)]
    rhs = [x0]
    for i in range(N - 1):
        E = torch.zeros((n, nw), dtype=torch.float64)
        E[:, (i + 1) * n:(i + 2) * n] = torch.eye(n)
        E[:, i * n:(i + 1) * n] = -mpc.A
        E[:, N * n + i * m:N * n + (i + 1) * m] = -mpc.B
        rows.append(E)
        rhs.append(mpc.d)
    E = torch.cat(rows).double()
    K = torch.cat([torch.cat([H, E.T], 1),
                   torch.cat([E, torch.zeros((E.shape[0], E.shape[0]),
                                             dtype=torch.float64)], 1)])
    sol = torch.linalg.solve(K, torch.cat([-g, torch.cat(rhs)]))
    assert torch.allclose(U.flatten(), sol[N * n:nw], atol=1e-7)


def test_rocket_discretization_is_exact():
    spec = _spec("rocket_soc_N21")
    dt = 0.05
    Ad, Bd, dd = rocket.dynamics(spec["model"], dt)
    m, g = spec["model"]["mass"], _dt(*spec["model"]["gravity"])
    eye = torch.eye(3, dtype=torch.float64)
    assert torch.allclose(Ad[:3, 3:], dt * eye, atol=1e-14)
    assert torch.allclose(Bd[:3], 0.5 * dt * dt / m * eye, atol=1e-14)
    assert torch.allclose(Bd[3:], dt / m * eye, atol=1e-14)
    assert torch.allclose(dd, torch.cat([0.5 * dt * dt * g, dt * g]),
                          atol=1e-14)


def test_rocket_cones_at_hover():
    """Hover thrust lies inside both thrust cones; a thrust tilted past
    theta_thrust_max leaves the angle cone."""
    spec = _spec("rocket_soc_N21")
    thrust, angle, glide = rocket.cones(spec["model"], 21, 20)
    assert list(glide.knots) == list(range(7, 20))
    u = _dt(0.0, 0.0, 98.1)
    for blk in (thrust, angle):
        c = blk.Cu @ u + blk.b
        assert c[:-1].norm() < c[-1]
    tilt = math.tan(math.radians(6.0)) * 98.1
    c = angle.Cu @ _dt(tilt, 0.0, 98.1) + angle.b
    assert c[:-1].norm() > c[-1]


def test_rocket_track_file():
    """The kept track: it starts at x0, lands at the origin, is the rollout
    of its controls and keeps every cone."""
    spec = _spec("rocket_soc_N21")
    X, U = rocket.load_track()
    prob = rocket.long_problem(spec)
    assert X.shape == (301, 6) and U.shape == (300, 3)
    assert torch.allclose(X[0], _dt(*spec["model"]["x0"]))
    assert float(X[-1].abs().max()) < 1e-9
    assert torch.allclose(prob.rollout(X[:1], U[None])[0], X, atol=1e-9)
    assert float(prob.violation(X[:1], U[None])[0]) < 1e-9


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2.0 ** -12, 1.0 + 3 * 2.0 ** -11, -7.3, 1e-3],
                     dtype=torch.float32)
    r = TF32.r(x)
    bits = r.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    assert bool(((r - x).abs() <= 2.0 ** -11 * x.abs()).all())
    assert float(r[0]) == 1.0
    assert F64.r(x).dtype == torch.float64


def test_tf32_solve_is_coarser():
    """The same window solved in TF32 lands farther from the float64
    optimum than float64 round-off."""
    mpc = _small_mpc([])
    x0, k = _dt([0.9, 0.1], [0.5, -0.3]), torch.tensor([1, 3])
    z0 = torch.zeros((2, 4, 1), dtype=torch.float64)
    U64 = mpc.solve(x0, k, z0)
    U32 = mpc.solve(x0, k, z0, TF32, gap_tol=1e-7)
    gap = (mpc.cost(x0, U32, k) - mpc.cost(x0, U64, k)).abs()
    assert float(gap.max()) > 1e-9
    assert U32.dtype == torch.float32


def test_reference_agrees_with_the_port_in_float64():
    """Two independent solvers of the same windows: the reference's barrier
    method and the port's AL-iLQR in float64 at tight tolerances reach the
    same optimal cost."""
    import dataclasses

    from altro_tpu_torch import mpc
    from altro_tpu_torch.costs import retarget_tracking
    from altro_tpu_torch.models import rocket as port_rocket
    from altro_tpu_torch.solver import altro
    from altro_tpu_torch.solver.options import SolverOptions

    spec = _spec("rocket_soc_N21")
    X, U = rocket.load_track()
    ref = rocket.tracking_mpc(spec, {"X_track": X, "U_track": U})
    z0 = rocket.hover(spec, 2, ref.N)
    rng = np.random.default_rng(2)
    k = torch.tensor([1, 4])
    x0 = ref.X_track[k] + 0.02 * torch.as_tensor(
        rng.standard_normal((2, ref.n))) * ref.X_track[k].abs().amax(1,
                                                                     True)
    U_ref = ref.solve(x0, k, z0)
    w = spec["tracking"]
    m_ = spec["model"]
    long = port_rocket.rocket_problem(
        N=spec["cold"]["knots"], tf=spec["cold"]["tf"], x0=tuple(m_["x0"]),
        dtype=torch.float64)
    pm = mpc.gen_tracking_mpc(long, ref.X_track, ref.U_track, ref.N,
                              Qk=w["Q"], Rk=w["R"], Qfk=w["Qf"], dt=w["dt"])
    opts = SolverOptions(**dict(
        spec["solver"], cost_tolerance=1e-12, gradient_tolerance=1e-10,
        constraint_tolerance=1e-9, iterations_outer=40,
        iterations_inner=300, early_exact_tol=0.0, penalty_scaling=10.0))
    for i in range(2):
        Xw, Uw = mpc.track_window(ref.X_track, ref.U_track, int(k[i]),
                                  ref.N)
        prob = dataclasses.replace(pm, cost=retarget_tracking(pm.cost, Xw,
                                                              Uw),
                                   x0=x0[i:i + 1])
        sol = altro.solve(prob, opts, U0=z0[i:i + 1])
        J_port = ref.cost(x0[i:i + 1], sol.U, k[i:i + 1])
        J_ref = ref.cost(x0[i:i + 1], U_ref[i:i + 1], k[i:i + 1])
        rel = float((J_port - J_ref).abs() / J_ref.abs().clamp(min=1.0))
        assert rel < 1e-6, (i, rel)
        assert float(ref.violation(x0[i:i + 1], sol.U)) < 1e-6
