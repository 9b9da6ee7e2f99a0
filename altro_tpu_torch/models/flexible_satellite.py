"""Flexible-satellite attitude regulator MPC (PyTorch counterpart of
``altro_tpu/models/flexible_satellite.py``).

A 12-state analytic flexible-spacecraft model (MRP attitude kinematics, the
rigid body coupled to three lightly damped flexible modes), discretized
exactly by zero-order hold at dt=0.5; an N=80 regulator to the origin with
Q=10I, R=0.1I and +-0.01 control bounds (one NONPOS block of 6 rows).

The MPC loop is a regulator: each step propagates x0 through the first
control plus process noise and re-solves the same problem, warm-started
from the previous controls and duals, with no window shift
(:func:`run_regulator_mpc`; the batched benchmark's step with re-based
states is ``mpc.make_regulator_step``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constraints import bound_constraint
from ..convert import tree_to
from ..costs import lqr_objective
from ..dynamics import lti_dynamics, zoh_discretize
from ..mpc import MPCResults, stack_results
from ..problem import Problem
from ..solver.altro import solve
from ..solver.options import SolverOptions

DT = 0.5


def _continuous_AB():
    """The continuous (A, B) of the model, in numpy float64."""
    J = np.diag([1.0, 2.0, 3.0])
    B_sc = np.eye(3)
    delta = np.array([[0, 0, 1], [0, 1, 0], [-0.7, 0.1, 0.1]])
    T = np.linalg.inv(J - delta.T @ delta)
    j = 3
    zeta = np.array([0.001, 0.001, 0.001])
    Delta = np.array([0.05, 0.2, 0.125]) * (2 * np.pi)
    C = np.diag(2 * zeta * Delta)
    K = np.diag(Delta ** 2)

    Z33, Z3j = np.zeros((3, 3)), np.zeros((3, j))
    A = np.block([
        [Z33, 0.25 * np.eye(3), Z3j, Z3j],
        [Z33, Z33, T @ delta.T @ K, T @ delta.T @ C],
        [Z3j.T, Z3j.T, np.zeros((j, j)), np.eye(j)],
        [Z3j.T, Z3j.T, -K - delta @ T @ delta.T @ K,
         -C - delta @ T @ delta.T @ C],
    ])
    B = np.vstack([Z33, -T @ B_sc, Z3j, delta @ T @ B_sc])
    return A, B


def flexsat_AB(dtype=torch.float64, device=None):
    """The model's ZOH discretization (Ad [12, 12], Bd [12, 3]) at dt=0.5,
    computed in ``dtype`` as the JAX package does."""
    A, B = _continuous_AB()
    kw = dict(dtype=dtype, device=device)
    Ad, Bd, _ = zoh_discretize(torch.as_tensor(A, **kw),
                               torch.as_tensor(B, **kw), DT)
    return Ad, Bd


def flexsat_problem(N: int = 80, u_bnd: float = 0.01, dtype=torch.float64,
                    device=None) -> Problem:
    """The N=80 regulator from x0 = [.1, .1, .1, 0, ...] with Q=10I, R=0.1I,
    Qf=Q, stage costs scaled by dt=0.1, and the +-u_bnd control bounds.

    Built in float64 on the CPU and then cast to ``dtype`` on ``device``:
    the modes are nearly undamped (zeta = 0.001), and a matrix exponential
    taken in float32 rounds differently in every library, so a float32
    problem and a float64 one describe the same instance only when they
    share one float64 build."""
    f64 = torch.float64
    Ad, Bd = flexsat_AB(f64)
    n, m = Bd.shape
    x0 = torch.zeros(n, dtype=f64)
    x0[:3] = 0.1
    Q = 10.0 * torch.eye(n, dtype=f64)
    R = 0.1 * torch.eye(m, dtype=f64)
    prob = Problem(
        dynamics=lti_dynamics(Ad, Bd, N),
        cost=lqr_objective(Q, R, Q, torch.zeros(n, dtype=f64), N, dt=0.1),
        constraints=(bound_constraint(N, n, m, u_min=-u_bnd, u_max=u_bnd,
                                      dtype=f64),),
        x0=x0)
    return tree_to(prob, device, dtype)


@torch.no_grad()
def run_regulator_mpc(prob: Problem, opts: SolverOptions, x0, noise,
                      noise_scale: float = 2e-4) -> MPCResults:
    """Regulator MPC of a batch: a cold solve from x0 [B, n], then per
    step propagate x0 through the first control plus ``noise_scale`` times
    the step's noise row (``noise`` [T, B, n]) and re-solve from the
    previous controls and duals (no shift; the duals reset as ``opts``
    says), each solve running its own init rollout (no states passed).
    Returns the per-step MPCResults stacked on a leading step axis
    ([T, B, ...])."""
    dyn = prob.dynamics
    sol = solve(dataclasses.replace(prob, x0=x0), opts)
    U, duals = sol.U, sol.duals
    outs = []
    for noise_i in noise:
        x0 = dyn.step(x0, U[:, 0], 0) + noise_scale * noise_i
        sol = solve(dataclasses.replace(prob, x0=x0), opts, U0=U,
                    duals=duals)
        U, duals = sol.U, sol.duals
        outs.append(MPCResults(X=sol.X, U=sol.U, iters=sol.stats.iterations,
                               status=sol.stats.status, viol=sol.stats.viol,
                               x0=x0))
    return stack_results(outs)
