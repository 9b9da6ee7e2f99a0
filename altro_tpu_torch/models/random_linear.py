"""Random marginally-stable linear MPC benchmark (PyTorch counterpart of
``altro_tpu/models/random_linear.py``). The numpy draws are the same, so one
seed builds the same problem in both packages."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..constraints import bound_constraint
from ..costs import lqr_objective
from ..dynamics import lti_dynamics
from ..problem import Problem


def gen_marginally_stable(rng: np.random.Generator, n: int, m: int,
                          tol: float = 1e-4, max_iter: int = 20):
    """Discrete (A, B): A = Q diag(v) Q' with random orthogonal Q and spectrum
    scaled to spectral radius 1/(1+tol); B ~ N(0,1); retried until
    controllable."""
    import warnings

    best = None
    for _ in range(max_iter):
        v = rng.standard_normal(n)
        v = v / (np.max(np.abs(v)) + tol)
        X = rng.standard_normal((n, n))
        Q, _ = np.linalg.qr(X)
        A = Q @ np.diag(v) @ Q.T
        B = rng.standard_normal((n, m))
        # controllability matrix rank check
        R = np.zeros((n, n * m))
        Ak = np.eye(n)
        for k in range(n):
            R[:, k * m:(k + 1) * m] = Ak @ B
            Ak = Ak @ A
        best = (A, B)
        if np.linalg.matrix_rank(R) == n:
            return A, B
    # at large n the numerical rank check fails although random systems are
    # controllable with probability 1: accept the last candidate
    warnings.warn(f"controllability rank check failed numerically at n={n}; "
                  "accepting the last candidate system")
    return best


def gen_random_linear(rng: np.random.Generator, n: int, m: int, N: int,
                      dt: float = 0.1, dtype=torch.float64,
                      device="cpu") -> Problem:
    """LQR problem with Q = diag(10 rand(n)), R = 0.1 I, Qf = Q (N-1),
    +-3 control bounds, x0 = xf = 0."""
    A, B = gen_marginally_stable(rng, n, m)
    Q = np.diag(10 * rng.random(n))
    R = 0.1 * np.eye(m)
    Qf = Q * (N - 1)
    kw = dict(dtype=dtype, device=device)
    t = lambda a: torch.as_tensor(a, **kw)                  # noqa: E731
    dyn = lti_dynamics(t(A), t(B), N)
    cost = lqr_objective(t(Q), t(R), t(Qf), torch.zeros(n, **kw), N, dt=dt)
    cons = (bound_constraint(N, n, m, u_min=-3.0, u_max=3.0, **kw),)
    return Problem(dynamics=dyn, cost=cost, constraints=cons,
                   x0=torch.zeros(n, **kw))


def gen_trajectory(rng: np.random.Generator, prob: Problem, N: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tracking reference: rollout of N-1 standard-normal controls from
    x = 0. Returns (X_track [N, n], U_track [N-1, m])."""
    x0 = prob.x0
    U = torch.as_tensor(rng.standard_normal((N - 1, prob.m)), dtype=x0.dtype,
                        device=x0.device)
    dyn = lti_dynamics(prob.dynamics.A[0], prob.dynamics.B[0], N)
    return dyn.rollout(torch.zeros_like(x0), U), U


def gen_tracking_mpc(prob: Problem, X_track, U_track, N_mpc: int,
                     Qk: float = 10.0, Rk: float = 0.1, Qfk: float = None,
                     dt: float = 0.1) -> Problem:
    """See :func:`altro_tpu_torch.mpc.gen_tracking_mpc`."""
    from ..mpc import gen_tracking_mpc as _gen
    return _gen(prob, X_track, U_track, N_mpc, Qk=Qk, Rk=Rk, Qfk=Qfk, dt=dt)
