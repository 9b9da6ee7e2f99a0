"""Warm-started receding-horizon MPC step (PyTorch counterpart of the
batched ``shared_k`` step of ``altro_tpu/mpc.py``).

Each step of a batch of scenarios:

    propagate x0 through the first control (+ noise)
    advance the tracking-cost window          (once for the whole batch)
    seed the controls: the shifted previous solution (states
        seam-corrected) or the tracking window's controls
    shift duals, reset penalties
    solve (warm-started, batched)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .costs import retarget_tracking, tracking_objective
from .dynamics import LTVDynamics
from .problem import Problem
from .solver.altro import solve
from .solver.options import SolverOptions


def default_noise_model(x_prop, noise_i):
    """1% inf-norm process noise, per scenario: x_prop [B, n]."""
    return x_prop + noise_i * torch.amax(torch.abs(x_prop), dim=-1,
                                         keepdim=True) / 100.0


def gen_tracking_mpc(prob: Problem, X_track, U_track, N_mpc: int,
                     Qk: float = 10.0, Rk: float = 0.1, Qfk: float = None,
                     dt: float = 0.1) -> Problem:
    """Long-horizon problem + reference -> N_mpc-step tracking MPC problem:
    diagonal tracking weights, the same constraints minus any goal block,
    clipped to the window with the window's terminal knot inactive."""
    Qfk = Qk if Qfk is None else Qfk
    n, m = prob.n, prob.m
    kw = dict(dtype=prob.x0.dtype, device=prob.x0.device)
    cost = tracking_objective(torch.eye(n, **kw) * Qk, torch.eye(m, **kw) * Rk,
                              torch.eye(n, **kw) * Qfk, X_track[:N_mpc],
                              U_track[:N_mpc - 1], dt=dt)
    dyn = prob.dynamics
    dyn_mpc = LTVDynamics(A=dyn.A[:N_mpc - 1].contiguous(),
                          B=dyn.B[:N_mpc - 1].contiguous(),
                          d=dyn.d[:N_mpc - 1].contiguous())
    cons = []
    for c in prob.constraints:
        if c.name == "goal":
            continue
        mask = c.mask[:N_mpc].clone()
        mask[N_mpc - 1] = 0.0
        cons.append(dataclasses.replace(
            c, Cx=c.Cx[:N_mpc].contiguous(), Cu=c.Cu[:N_mpc].contiguous(),
            b=c.b[:N_mpc].contiguous(), mask=mask))
    return Problem(dynamics=dyn_mpc, cost=cost, constraints=tuple(cons),
                   x0=X_track[0])


def shift_fill(arr):
    """Shift one knot forward along axis -2, repeating the last entry."""
    return torch.cat([arr[..., 1:, :], arr[..., -1:, :]], dim=-2)


def track_window(X_track, U_track, k0: int, N: int):
    """The [k0, k0+N) tracking window, clamped at the tail like
    ``lax.dynamic_slice``."""
    kx = min(max(int(k0), 0), X_track.shape[0] - N)
    ku = min(max(int(k0), 0), U_track.shape[0] - (N - 1))
    return X_track[kx:kx + N], U_track[ku:ku + N - 1]


@dataclass
class MPCResults:
    """Per-step records of a batch (leading axis = scenario)."""

    X: torch.Tensor           # [B, N, n] ALTRO solutions
    U: torch.Tensor           # [B, N-1, m]
    iters: torch.Tensor       # [B]
    status: torch.Tensor      # [B]
    viol: torch.Tensor        # [B]
    x0: torch.Tensor          # [B, n] noisy initial states


def _xws_corrector(dyn):
    """Exact warm-start state corrector for LTI dynamics.

    With knot-constant (A, B, d) the true rollout of the shifted controls
    from the new x0 is ``x_k = X_shift[k] + A^k e0`` with
    ``e0 = x0_new - X_shift[0]``, so the init rollout is the shifted
    trajectory plus one contraction with the build-time constants
    ``Phi_k = A^k``. The tail knot extends the old trajectory one step under
    the repeated last control. Returns ``None`` for time-varying stacks.
    """
    if not isinstance(dyn, LTVDynamics):
        return None
    A = dyn.A.cpu().numpy()
    Bm = dyn.B.cpu().numpy()
    d = dyn.d.cpu().numpy()
    if not (np.allclose(A, A[:1]) and np.allclose(Bm, Bm[:1])
            and np.allclose(d, d[:1])):
        return None
    N, n = A.shape[0] + 1, A.shape[-1]
    Phis = np.empty((N, n, n), np.float64)
    Phis[0] = np.eye(n)
    for k in range(1, N):
        Phis[k] = A[0].astype(np.float64) @ Phis[k - 1]
    Phis = torch.as_tensor(Phis, dtype=dyn.A.dtype, device=dyn.A.device)
    A_l, B_l, d_l = dyn.A[-1], dyn.B[-1], dyn.d[-1]

    def correct(X, U_ws, x0_new):
        """X [B, N, n], U_ws [B, N-1, m], x0_new [B, n] -> [B, N, n]."""
        x_ext = (torch.einsum("ij,bj->bi", A_l, X[:, -1])
                 + torch.einsum("ij,bj->bi", B_l, U_ws[:, -1]) + d_l)
        Xs = torch.cat([X[:, 1:], x_ext[:, None]], dim=1)
        e0 = x0_new - Xs[:, 0]
        return Xs + torch.einsum("kij,bj->bki", Phis, e0)

    return correct


def make_mpc_step(prob_mpc: Problem, opts: SolverOptions, X_track, U_track,
                  noise_model=default_noise_model, shared_k: bool = True,
                  warm_start: str = "shift"):
    """Build the batched warm-started MPC step
    ``step(carry, noise [B, n], k) -> (carry, MPCResults)`` and
    ``init_carry(batch) -> carry`` with carry = (x0, X, U, duals), all
    batched. Every scenario sits at the same window index ``k``, so the
    tracking window and cost retarget are computed once per step
    (``shared_k=True``, the only form ported).

    ``warm_start``: "shift" carries the previous solution (controls shifted
    one knot, duals shifted, states seam-corrected by
    :func:`_xws_corrector`); "track" seeds every solve from the tracking
    window's controls, with no states (the solve runs its init rollout),
    while the duals still shift (``opts.reset_duals`` then zeroes them)."""
    if not shared_k:
        raise NotImplementedError("only shared_k=True is ported")
    if warm_start not in ("shift", "track"):
        raise ValueError(f"warm_start must be 'shift' or 'track', got "
                         f"{warm_start!r}")
    N = prob_mpc.N
    dyn = prob_mpc.dynamics
    xws = _xws_corrector(dyn)

    def step(carry, noise_i, k: int):
        x0, X, U, duals = carry
        x0_new = noise_model(dyn.step(x0, U[:, 0], 0), noise_i)
        Xw, Uw = track_window(X_track, U_track, k + 1, N)
        prob_k = dataclasses.replace(
            prob_mpc, cost=retarget_tracking(prob_mpc.cost, Xw, Uw),
            x0=x0_new)
        if warm_start == "shift":
            U_ws = shift_fill(U)
            X_ws = None if xws is None else xws(X, U_ws, x0_new)
        else:
            U_ws = Uw.expand(U.shape).contiguous()
            X_ws = None
        duals_ws = tuple(d.shift() for d in duals)
        sol = solve(prob_k, opts, U0=U_ws, duals=duals_ws, X0=X_ws)
        out = MPCResults(X=sol.X, U=sol.U, iters=sol.stats.iterations,
                         status=sol.stats.status, viol=sol.stats.viol,
                         x0=x0_new)
        return (x0_new, sol.X, sol.U, sol.duals), out

    def init_carry(batch: int):
        """Cold batched solve of the first window from X_track[0]."""
        x0 = prob_mpc.x0.expand(batch, prob_mpc.n).contiguous()
        sol0 = solve(dataclasses.replace(prob_mpc, x0=x0), opts)
        return (x0, sol0.X, sol0.U, sol0.duals)

    return step, init_carry
