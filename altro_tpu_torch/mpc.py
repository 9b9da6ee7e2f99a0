"""Warm-started receding-horizon MPC step (PyTorch counterpart of the
batched ``shared_k`` steps of ``altro_tpu/mpc.py``).

Each step of a batch of scenarios:

    propagate x0 through the first control (+ noise)
    advance the tracking-cost window          (once for the whole batch)
    refresh the constraint window             (``constraints_fn``, if given)
    seed the controls: the shifted previous solution (states
        seam-corrected) or the tracking window's controls
    shift duals, reset penalties
    solve (warm-started, batched)

:func:`make_mpc_step_device_compacted` solves the same step with straggler
compaction: every lane runs to an iteration cap, the unconverged lanes are
gathered into a smaller batch that finishes alone (through nested levels of
caps and blocks), and the results are scattered back. A lane's iterates do
not depend on the batch it runs in, so the results are those of the plain
step; only the batch size of the late passes changes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .costs import retarget_tracking, tracking_objective
from .dynamics import LTVDynamics
from .problem import Problem
from .solver.altro import _finalize, _flat_while, _warmstart_state, solve
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
    # the knot axis is the third from the end of A and B and the second of
    # d, whether or not the stacks carry a batch axis in front
    dyn_mpc = LTVDynamics(A=dyn.A[..., :N_mpc - 1, :, :].contiguous(),
                          B=dyn.B[..., :N_mpc - 1, :, :].contiguous(),
                          d=dyn.d[..., :N_mpc - 1, :].contiguous())
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
    the repeated last control. Returns ``None`` for time-varying stacks and
    for per-lane stacks.
    """
    if not isinstance(dyn, LTVDynamics) or dyn.per_lane:
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


def _step_pieces(prob_mpc: Problem, opts: SolverOptions, X_track, U_track,
                 noise_model, constraints_fn, warm_start: str):
    """The parts of a batched MPC step that every form of it shares:
    ``prob_at(k_new, x0)``, the window's problem; ``start(carry, noise_i,
    k)``, which propagates the carry and returns (the window's problem, the
    solver's initial state, x0_new); ``finish(prob_k, state, x0_new)``,
    which returns (the next carry, MPCResults); and ``init_carry(batch)``."""
    if warm_start not in ("shift", "track"):
        raise ValueError(f"warm_start must be 'shift' or 'track', got "
                         f"{warm_start!r}")
    N = prob_mpc.N
    dyn = prob_mpc.dynamics
    xws = _xws_corrector(dyn)

    def prob_at(k_new: int, x0):
        Xw, Uw = track_window(X_track, U_track, k_new, N)
        prob_k = dataclasses.replace(
            prob_mpc, cost=retarget_tracking(prob_mpc.cost, Xw, Uw), x0=x0)
        if constraints_fn is not None:
            # time-varying constraint window, cut from full-horizon stacks
            prob_k = dataclasses.replace(prob_k,
                                         constraints=constraints_fn(k_new))
        return prob_k, Uw

    def start(carry, noise_i, k: int):
        x0, X, U, duals = carry
        x0_new = noise_model(dyn.step(x0, U[:, 0], 0), noise_i)
        prob_k, Uw = prob_at(k + 1, x0_new)
        if warm_start == "shift":
            U_ws = shift_fill(U)
            X_ws = None if xws is None else xws(X, U_ws, x0_new)
        else:
            U_ws = Uw.expand(U.shape).contiguous()
            X_ws = None
        duals_ws = tuple(d.shift() for d in duals)
        return (prob_k, _warmstart_state(prob_k, opts, U_ws, duals_ws, X_ws),
                x0_new)

    def finish(prob_k, state, x0_new):
        sol = _finalize(prob_k, state)
        out = MPCResults(X=sol.X, U=sol.U, iters=sol.stats.iterations,
                         status=sol.stats.status, viol=sol.stats.viol,
                         x0=x0_new)
        return (x0_new, sol.X, sol.U, sol.duals), out

    def init_carry(batch: int):
        """Cold batched solve of the first window from X_track[0]."""
        x0 = prob_mpc.x0.expand(batch, prob_mpc.n).contiguous()
        sol0 = solve(dataclasses.replace(prob_mpc, x0=x0), opts)
        return (x0, sol0.X, sol0.U, sol0.duals)

    return prob_at, start, finish, init_carry


def make_mpc_step(prob_mpc: Problem, opts: SolverOptions, X_track, U_track,
                  noise_model=default_noise_model, constraints_fn=None,
                  shared_k: bool = True, warm_start: str = "shift"):
    """Build the batched warm-started MPC step
    ``step(carry, noise [B, n], k) -> (carry, MPCResults)`` and
    ``init_carry(batch) -> carry`` with carry = (x0, X, U, duals), all
    batched. Every scenario sits at the same window index ``k``, so the
    tracking window, the cost retarget and the constraint window are
    computed once per step (``shared_k=True``, the only form ported).

    ``constraints_fn(k)``: the constraint blocks of the window starting at
    knot ``k`` (time-varying constraints, as grasp's rotating contact
    frames), refreshed every step; ``None`` keeps ``prob_mpc``'s blocks.

    ``warm_start``: "shift" carries the previous solution (controls shifted
    one knot, duals shifted, states seam-corrected by
    :func:`_xws_corrector`); "track" seeds every solve from the tracking
    window's controls, with no states (the solve runs its init rollout),
    while the duals still shift (``opts.reset_duals`` then zeroes them)."""
    if not shared_k:
        raise NotImplementedError("only shared_k=True is ported")
    _, start, finish, init_carry = _step_pieces(
        prob_mpc, opts, X_track, U_track, noise_model, constraints_fn,
        warm_start)

    @torch.no_grad()
    def step(carry, noise_i, k: int):
        prob_k, state, x0_new = start(carry, noise_i, k)
        return finish(prob_k, _flat_while(prob_k, opts, state), x0_new)

    return step, init_carry


def make_mpc_step_compacted(prob_mpc: Problem, opts: SolverOptions,
                            X_track, U_track,
                            noise_model=default_noise_model,
                            constraints_fn=None, it_cap: int = 24,
                            warm_start: str = "shift"):
    """The batched MPC step in three pieces, for straggler compaction:

    ``partial(carry, noise_i, k) -> (state, x0_new)``
        propagate, seed and run every lane's solve to at most ``it_cap``
        iterations;
    ``resume(state, k, it_cap=None) -> state``
        continue a state (for example a gathered block of unconverged
        lanes) to completion, or to the absolute iteration count
        ``it_cap``; resuming converged lanes is a no-op;
    ``extract(state, x0_new, k) -> (carry, MPCResults)``
        the next carry and the step's records.

    With ``init_carry(batch)`` as :func:`make_mpc_step`'s. ``prob.x0`` is
    not read on resume: the state carries the trajectory."""
    prob_at, start, finish, init_carry = _step_pieces(
        prob_mpc, opts, X_track, U_track, noise_model, constraints_fn,
        warm_start)

    @torch.no_grad()
    def partial(carry, noise_i, k: int):
        prob_k, state, x0_new = start(carry, noise_i, k)
        return _flat_while(prob_k, opts, state, it_cap), x0_new

    @torch.no_grad()
    def resume(state, k: int, it_cap=None):
        prob_k, _ = prob_at(k + 1, prob_mpc.x0)
        return _flat_while(prob_k, opts, state, it_cap)

    def extract(state, x0_new, k: int):
        prob_k, _ = prob_at(k + 1, prob_mpc.x0)
        return finish(prob_k, state, x0_new)

    return partial, resume, extract, init_carry


def _state_map(fn, *states):
    """Apply ``fn`` leafwise over matching solver states (tuples of tensors
    and DualStates, every leaf with the batch leading)."""
    a = states[0]
    if isinstance(a, torch.Tensor):
        return fn(*states)
    if dataclasses.is_dataclass(a):
        return dataclasses.replace(a, **{
            f.name: _state_map(fn, *(getattr(s, f.name) for s in states))
            for f in dataclasses.fields(a)})
    return tuple(_state_map(fn, *leaves) for leaves in zip(*states))


def make_mpc_step_device_compacted(prob_mpc: Problem, opts: SolverOptions,
                                   X_track, U_track,
                                   noise_model=default_noise_model,
                                   constraints_fn=None, it_cap: int = 24,
                                   block: int = 128, levels: tuple = (),
                                   warm_start: str = "shift"):
    """The batched MPC step with straggler compaction on the device:

    run every lane to ``it_cap`` iterations, gather the ``block``
    unconverged-first lanes (a stable argsort of the done flags), finish
    them as a batch of their own, scatter them back, then resume the whole
    batch (a catch-all, which finds no live lane unless more than ``block``
    lanes were unconverged at the cap: one evaluation of the loop
    condition). ``levels``: further ``(extra_cap, sub_block)`` stages
    inside the block: it runs ``extra_cap`` more iterations (the iteration
    count is absolute, so capped resumes compose), then its ``sub_block``
    unconverged-first lanes are gathered for the next stage; the innermost
    stage runs to completion, and every stage ends with its own catch-all.

    A lane's iterates are the plain step's whatever the schedule. Returns
    ``(step, init_carry)`` with the signatures of :func:`make_mpc_step`."""
    if prob_mpc.dynamics.per_lane:
        raise NotImplementedError("compaction gathers the solver state "
                                  "only, not per-lane dynamics stacks")
    _, start, finish, init_carry = _step_pieces(
        prob_mpc, opts, X_track, U_track, noise_model, constraints_fn,
        warm_start)
    sched = ((it_cap, block),) + tuple(levels)

    def compact(prob_k, states, lvl: int, cum: int):
        # `states` has run to the absolute iteration cap `cum`: gather this
        # level's block of stragglers, finish them (through the deeper
        # levels), scatter them back, then catch-all to completion
        done = states[10]
        blk = min(sched[lvl][1], done.shape[0])
        take = torch.argsort(done.to(torch.int32), stable=True)[:blk]
        sub = _state_map(lambda a: a[take], states)
        if lvl + 1 < len(sched):
            extra = sched[lvl + 1][0]
            sub = _flat_while(prob_k, opts, sub, cum + extra)
            sub = compact(prob_k, sub, lvl + 1, cum + extra)
        else:
            sub = _flat_while(prob_k, opts, sub)
        states = _state_map(lambda a, b: a.index_copy(0, take, b), states,
                            sub)
        return _flat_while(prob_k, opts, states)

    @torch.no_grad()
    def step(carry, noise_i, k: int):
        prob_k, state, x0_new = start(carry, noise_i, k)
        state = _flat_while(prob_k, opts, state, it_cap)
        return finish(prob_k, compact(prob_k, state, 0, it_cap), x0_new)

    return step, init_carry
