"""ALTRO-style augmented-Lagrangian iLQR solver: the batched PyTorch port of
``altro_tpu/solver/altro.py`` for LTV or nonlinear dynamics with affine
ZERO/NONPOS/SOC constraint blocks and nonlinear (quadratic norm) blocks.

Every entry point takes an explicit leading batch axis B (``prob.x0`` is
[B, n]); the constraint stacks (of an affine block), the cost's linear
terms and the dynamics stacks are shared or per scenario, and LTV stacks
may be shared per group of scenarios (``LTVDynamics.grouped``: the fused
kernels index each scenario's group, as the JAX package's kernels run once
per group under a vmap over groups). Each iteration runs

- the AL expansion and the Riccati backward pass, either
  - fused into one pass (ops/riccati_fused.py: a CUDA kernel on the card),
    where the dynamics are shared LTV stacks, every block is affine
    (:func:`ltv_affine`, the JAX package's gate), the cost is shared and
    ``SolverOptions.fused_expansion`` is on (``Problem.per_lane`` false),
    or
  - split (otherwise): the dynamics linearized about the iterate
    (per lane and knot for a nonlinear model), the expansion in PyTorch
    (a nonlinear block's Jacobians per lane, plus its exact curvature),
    then :func:`backward_pass` (ops/riccati.py: a CUDA kernel on the card),
- the whole line-search ladder of step sizes plus a trailing alpha = 0 rung
  in one closed-loop rollout, either
  - classical: the ladder rollout (ops/rollout.py: a CUDA kernel on the
    card; for a nonlinear model :func:`rollout_closed_loop` through the
    model in PyTorch), whose AL cost and constraint residuals are
    evaluated in PyTorch for every rung, or
  - fused (``SolverOptions.ls_fused``, LTV dynamics with affine blocks
    only): the ladder rollout with each rung's AL merit accumulated in the
    same pass (ops/rollout_al.py: a CUDA kernel on the card; with per-lane
    dynamics or a per-lane cost the ladder-rollout kernel followed by the
    merit in PyTorch), the residuals then evaluated once on the adopted
    trajectory,
- the AL round bookkeeping (dual update by polar-cone projection, penalty
  scaling, violation check) inline under a per-lane mask.

Loop control: one flat AL + iLQR loop. Each pass computes the per-lane
``live`` mask and applies the body under ``torch.where(live, new, old)``,
so a lane freezes as soon as its own condition is false, as under ``vmap``
of the JAX ``lax.while_loop``; passes past a lane's end change nothing, so
the loop may test whether any lane is live once every k passes. Here the
test is a host ``while`` (:func:`_flat_while`, one host sync per k
passes); ``solver/graph.py`` replays k passes as a CUDA graph. The loop may
stop at an absolute iteration cap and resume from its state
(:func:`solve_partial`, :func:`solve_resume`): a lane's iterates do not
depend on where the loop paused or on which other lanes share its batch,
which straggler compaction (``mpc.make_mpc_step_device_compacted``) relies
on.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..cones import project_polar
from ..constraints import DualState, al_terms_structured
from ..dynamics import LTVDynamics
from ..ops.blocks import PackedBlocks, pack_blocks
from ..ops.pass_tail import al_pass_tail, live_mask, pass_tail_reference
from ..ops.riccati import batched_riccati
from ..ops import riccati_fused
from ..ops.riccati_fused import fused_expand_backward
from ..ops.rollout import batched_ls_rollout
from ..ops.rollout_al import batched_ls_rollout_al
from ..problem import Problem
from .options import SolverOptions

# Loop-body passes since the last reset, whatever the batch they ran on: with
# straggler compaction a step's passes are no longer its lanes' largest
# iteration count, and the kernels of a pass launch once per body pass.
# Passes checked every k (``check_every``) include the frozen ones past the
# last lane's end.
pass_count = 0
# Entries into the host-driven loop (:func:`_flat_while`) since the last
# reset: a run on CUDA graphs (solver/graph.py) never enters it.
eager_loop_count = 0


@dataclass
class Stats:
    iterations: torch.Tensor        # [B] total inner (iLQR) iterations
    outer_iterations: torch.Tensor  # [B] AL iterations
    cost: torch.Tensor              # [B] final true (un-penalized) cost
    viol: torch.Tensor              # [B] final max constraint violation
    gradient: torch.Tensor          # [B]
    status: torch.Tensor            # [B] 1 = SOLVE_SUCCEEDED, 0 = MAX_ITERATIONS


@dataclass
class Solution:
    X: torch.Tensor                 # [B, N, n]
    U: torch.Tensor                 # [B, N-1, m]
    K: torch.Tensor                 # [B, N-1, m, n] final feedback gains
    duals: Tuple[DualState, ...]
    stats: Stats


def print_summary(sol: Solution) -> None:
    """Print a one-line summary per lane of a solve (status, iterations, AL
    rounds, cost, violation, gradient)."""
    s = sol.stats
    for i in range(int(s.status.shape[0])):
        status = ("SOLVE_SUCCEEDED" if int(s.status[i]) == 1
                  else "MAX_ITERATIONS")
        print(f"[altro_tpu_torch] {status}: {int(s.iterations[i])} iLQR "
              f"iterations in {int(s.outer_iterations[i])} AL rounds | cost "
              f"{float(s.cost[i]):.6g} | max violation {float(s.viol[i]):.3e}"
              f" | gradient {float(s.gradient[i]):.3e}")


def check_status(stats: Stats, context: str = "") -> bool:
    """Whether every lane succeeded; warns with the count of unsuccessful
    solves otherwise."""
    import warnings

    ok = bool(torch.all(stats.status == 1))
    if not ok:
        n_fail = int(torch.sum(stats.status == 0))
        warnings.warn(f"solver status: {n_fail} unsuccessful solve(s)"
                      + (f" in {context}" if context else ""))
    return ok


# ----------------------------------------------------------------------------
# AL cost and expansion
# ----------------------------------------------------------------------------

def total_al_cost(prob: Problem, duals, X, U):
    """AL cost [...] of (X, U) under ``duals`` (:func:`total_al_cost_res`
    without the residuals)."""
    return total_al_cost_res(prob, duals, X, U)[0]


def al_expansion(prob: Problem, duals, X, U):
    """Quadratic expansion of the AL objective along (X [B,N,n], U):
    :func:`_al_expansion_cd` of the problem's cost and constraints."""
    return _al_expansion_cd(prob.cost, prob.constraints, duals, X, U)


def total_al_cost_res(prob: Problem, duals, X, U):
    """AL cost [...] plus the per-block residuals c and projected duals
    ctilde = proj_polar(lam + rho c) computed along the way. X, U and the
    duals broadcast over any leading axes (the ladder evaluates [B, L])."""
    J = prob.cost.total(X, U)
    cs, cts = [], []
    for con, dual in zip(prob.constraints, duals):
        c = con.evaluate(X, U)
        z = dual.lam + dual.rho[..., None] * c
        ct = project_polar(con.cone, z)
        J = J + torch.sum(
            con.mask * (torch.sum(ct * ct, dim=-1)
                        - torch.sum(dual.lam ** 2, dim=-1))
            / (2.0 * dual.rho), dim=-1)
        cs.append(c)
        cts.append(ct)
    return J, (tuple(cs), tuple(cts))


def _al_merit_tail(blocks, lams, rho0, X, U):
    """AL penalty part of the line-search merit [...]:
    sum over blocks of mask * |proj_polar(lam + rho0 c)|^2 / (2 rho0).

    This is the AL cost minus the rung-independent -|lam|^2/(2 rho) term:
    every use of the merit is a difference or comparison between rungs, so
    dropping it changes no decision. ``rho0`` is the shared penalty
    schedule [..., N]; X, U, lams and rho0 broadcast over leading axes."""
    pen = torch.zeros((), dtype=X.dtype, device=X.device)
    for con, lam in zip(blocks, lams):
        c = con.evaluate(X, U)
        ct = project_polar(con.cone, lam + rho0[..., None] * c)
        pen = pen + torch.sum(
            con.mask * torch.sum(ct * ct, dim=-1) / (2.0 * rho0), dim=-1)
    return pen


def _al_expansion_cd(cost, constraints, duals, X, U):
    """Quadratic expansion of the AL objective along (X [B,N,n], U).

    Returns lx [B,N,n], lu [B,N,m], lxx [(B,)N,n,n], luu [(B,)N,m,m],
    lux [(B,)N,m,n]: the Hessians stay shared when no block adds per-lane
    curvature. Each block's curvature in c comes in its structured form
    (al_terms_structured) and is contracted with the block's Jacobians:
    shared stacks [N, p, .] for an affine block, where the Gauss-Newton
    curvature C' (rho J_polar) C is exact up to the projection kink, or
    per-lane stacks [B, N, p, .] at the iterate for a nonlinear block,
    which also adds its exact multiplier-weighted curvature
    (``second_order``)."""
    lx, lu, lxx, luu, lux = cost.expansion(X, U)
    for con, dual in zip(constraints, duals):
        g, (kind, H) = al_terms_structured(con, dual, X, U)
        Cx, Cu = con.jacobians(X, U)
        j = "" if Cx.dim() == 3 else "..."    # shared or per-lane Jacobians
        lx = lx + torch.einsum(f"{j}kpn,...kp->...kn", Cx, g)
        lu = lu + torch.einsum(f"{j}kpm,...kp->...km", Cu, g)
        if kind == "dense":
            # small cones: contract the [N, p, p] curvature directly
            dense = f"{j}kpi,...kpq,{j}kqj->...kij"
            lxx = lxx + torch.einsum(dense, Cx, H, Cx)
            luu = luu + torch.einsum(dense, Cu, H, Cu)
            lux = lux + torch.einsum(dense, Cu, H, Cx)
        else:
            w, ranks = (H, ()) if kind == "diag" else H
            WCx = w[..., None] * Cx
            WCu = w[..., None] * Cu
            gram = f"{j}kpi,...kpj->...kij"
            lxx = lxx + torch.einsum(gram, Cx, WCx)
            luu = luu + torch.einsum(gram, Cu, WCu)
            lux = lux + torch.einsum(gram, Cu, WCx)
            for coef, u in ranks:
                # 'diag_lr': coef (C'u)(C'u)', the SOC Jacobian's rank-1
                # terms
                ax = torch.einsum(f"{j}kpn,...kp->...kn", Cx, u)
                au = torch.einsum(f"{j}kpm,...kp->...km", Cu, u)
                c3 = coef[..., None, None]
                lxx = lxx + c3 * (ax[..., :, None] * ax[..., None, :])
                luu = luu + c3 * (au[..., :, None] * au[..., None, :])
                lux = lux + c3 * (au[..., :, None] * ax[..., None, :])
        if not con.is_affine:
            # the exact multiplier-weighted constraint curvature (full
            # Newton on the AL of a nonlinear block; affine blocks have
            # none)
            Hxx, Huu, Hux = con.second_order(X, U, g)
            lxx = lxx + Hxx
            luu = luu + Huu
            lux = lux + Hux
    return lx, lu, lxx, luu, lux


def _backward_pass(A, B, lx, lu, lxx, luu, lux, reg):
    """Riccati recursion, a Python loop over knots batched over scenarios.

    A [(B,)N-1,n,n], B [(B,)N-1,n,m] and the Hessian stacks may be shared or
    per lane; lx [B,N,n], lu [B,N,m]; reg [B]. Returns K [B,N-1,m,n],
    d [B,N-1,m], dV1, dV2 [B]: the expected cost change of a step of size
    alpha is alpha*dV1 + alpha^2*dV2 (dV1 <= 0).
    """
    Bt, N, n = lx.shape
    m = lu.shape[-1]
    eye_m = torch.eye(m, dtype=lx.dtype, device=lx.device)
    Vx = lx[:, -1]
    Vxx = lxx[..., -1, :, :].expand(Bt, n, n)
    dV1 = torch.zeros(Bt, dtype=lx.dtype, device=lx.device)
    dV2 = torch.zeros_like(dV1)
    Ks, ds = [None] * (N - 1), [None] * (N - 1)

    def mv(M, v):
        return (M @ v[..., None])[..., 0]

    for k in reversed(range(N - 1)):
        A_k, B_k = A[..., k, :, :], B[..., k, :, :]
        VA = Vxx @ A_k
        Qx = lx[:, k] + mv(A_k.mT, Vx)
        Qu = lu[:, k] + mv(B_k.mT, Vx)
        Qxx = lxx[..., k, :, :] + A_k.mT @ VA
        Quu = luu[..., k, :, :] + B_k.mT @ (Vxx @ B_k)
        Qux = lux[..., k, :, :] + B_k.mT @ VA
        Quu_reg = Quu + reg[:, None, None] * eye_m

        # Quu is SPD (R > 0 plus PSD curvature): Cholesky solve. A lane
        # whose factorization fails gets NaN gains, as in the JAX solver.
        rhs = torch.cat([Qux, Qu[..., None]], dim=-1)
        L, info = torch.linalg.cholesky_ex(Quu_reg)
        L = torch.where((info > 0)[:, None, None], math.nan, L)
        sol = torch.cholesky_solve(rhs, L)
        K_k = -sol[..., :-1]
        d_k = -sol[..., -1]

        Quu_d = mv(Quu, d_k)
        Vx = Qx + mv(K_k.mT, Quu_d) + mv(K_k.mT, Qu) + mv(Qux.mT, d_k)
        Vxx = Qxx + K_k.mT @ (Quu @ K_k) + K_k.mT @ Qux + Qux.mT @ K_k
        Vxx = 0.5 * (Vxx + Vxx.mT)
        dV1 = dV1 + torch.sum(d_k * Qu, dim=-1)
        dV2 = dV2 + 0.5 * torch.sum(d_k * Quu_d, dim=-1)
        Ks[k], ds[k] = K_k, d_k
    return torch.stack(Ks, dim=1), torch.stack(ds, dim=1), dV1, dV2


def backward_pass(A, B, lx, lu, lxx, luu, lux, reg):
    """Riccati backward pass of a batch from its expansion (shapes as
    :func:`_backward_pass`): the kernel on a CUDA device
    (ops/riccati.batched_riccati), the plain recursion on the CPU."""
    return batched_riccati(*(t.contiguous() for t in
                             (A, B, lx, lu, lxx, luu, lux, reg)))


def _expand_backward_base(cost, dynA, dynB, blocks, X, U, lams, rhos, reg):
    """AL expansion + Riccati backward pass composed from the plain pieces
    (the plain version of the fused kernel)."""
    duals = tuple(DualState(lam=l, rho=r) for l, r in zip(lams, rhos))
    lx, lu, lxx, luu, lux = _al_expansion_cd(cost, blocks, duals, X, U)
    return _backward_pass(dynA, dynB, lx, lu, lxx, luu, lux, reg)


# ----------------------------------------------------------------------------
# Forward closed-loop rollout
# ----------------------------------------------------------------------------

def rollout_closed_loop(dynamics, Xbar, Ubar, K, d, alphas,
                        alphas_dev: Optional[torch.Tensor] = None):
    """Closed-loop rollout of every rung alpha of a ladder:
    u = ubar + alpha d + K (x - xbar), x+ = f(x, u), x0 = xbar0, for the
    batch Xbar [B, N, n], Ubar and d [B, N-1, m], K [B, N-1, m, n]. Returns
    Xs [B, L, N, n], Us [B, L, N-1, m]. LTV dynamics take the ladder
    rollout (ops/rollout.py: kernel A on the card); a nonlinear model runs
    all rungs of a knot in one call of its batched step, each rung with its
    lane's params (by index, no copy per rung). A rung alpha = 0 started on
    a trajectory of this rollout reproduces it bit for bit. ``alphas_dev``:
    the ladder as a tensor on the batch's device (made from ``alphas`` when
    None: a copy from the host, which a CUDA graph capture refuses)."""
    alphas = tuple(float(a) for a in alphas)
    if isinstance(dynamics, LTVDynamics):
        return batched_ls_rollout(dynamics.A, dynamics.B, dynamics.d, Xbar,
                                  Ubar, K, d, alphas, dynamics.grouped)
    if alphas_dev is None:
        alphas_dev = torch.tensor(alphas, dtype=Xbar.dtype,
                                  device=Xbar.device)
    al = alphas_dev[None, :, None]                                # [1, L, 1]
    x = Xbar[:, None, 0, :].expand(-1, len(alphas), -1)           # [B, L, n]
    xs, us = [x], []
    for k in range(Ubar.shape[1]):
        dx = x - Xbar[:, None, k, :]
        u = (Ubar[:, None, k, :] + al * d[:, None, k, :]
             + torch.einsum("bij,blj->bli", K[:, k], dx))
        x = dynamics.step(x, u, k)
        xs.append(x)
        us.append(u)
    return torch.stack(xs, dim=2), torch.stack(us, dim=2)


# ----------------------------------------------------------------------------
# Solve
# ----------------------------------------------------------------------------

@torch.no_grad()
def solve(prob: Problem, opts: SolverOptions,
          U0: Optional[torch.Tensor] = None,
          duals: Optional[Tuple[DualState, ...]] = None,
          X0: Optional[torch.Tensor] = None) -> Solution:
    """Solve a batch of trajectory-optimization problems that share their
    cost and constraints and differ in ``prob.x0`` [B, n] and, with
    per-lane stacks [B, N-1, ...] or grouped stacks [G, N-1, ...], in their
    dynamics.

    Warm start: ``U0`` [B, N-1, m] (shifted controls) and ``duals``
    (shifted multipliers, [B, ...]) from the previous MPC solve. Without
    ``X0`` the states come from an open-loop rollout of U0 from x0; passing
    ``X0`` [B, N, n] skips that rollout and linearizes iteration 1 around
    (X0, U0), with X0[:, 0] overwritten by x0.
    """
    s0 = _warmstart_state(prob, opts, U0, duals, X0)
    return _finalize(prob, _flat_while(prob, opts, s0))


@torch.no_grad()
def solve_partial(prob: Problem, opts: SolverOptions,
                  U0: Optional[torch.Tensor] = None,
                  duals: Optional[Tuple[DualState, ...]] = None,
                  X0: Optional[torch.Tensor] = None, *, it_cap: int):
    """Run :func:`solve` for at most ``it_cap`` iterations of every lane and
    return the raw loop state (a tuple with the batch leading on every
    per-lane leaf), to be continued by :func:`solve_resume`. Each lane's
    iterates are those of the uncapped solve: a lane freezes on its own
    condition, so gathering unconverged lanes into a smaller batch and
    resuming them gives the uncapped result."""
    s0 = _warmstart_state(prob, opts, U0, duals, X0)
    return _flat_while(prob, opts, s0, it_cap)


@torch.no_grad()
def solve_compacted(prob: Problem, opts: SolverOptions,
                    U0: Optional[torch.Tensor] = None,
                    X0: Optional[torch.Tensor] = None, *, it_cap: int,
                    block: int, check_every: int = 1) -> Solution:
    """:func:`solve` with straggler compaction (the JAX package's
    ``quadruped_batched(compact_cap=)``, ``batched_families.py:308-336``):
    every lane runs to ``it_cap`` iterations, the ``block``
    unconverged-first lanes (a stable argsort of the done flags) are
    gathered with their problem data (:func:`take_lanes`) and resumed as a
    batch of their own, scattered back, and a catch-all resumes the whole
    batch. Each lane's iterates are the plain solve's."""
    s = solve_partial(prob, opts, U0, X0=X0, it_cap=it_cap)
    take = torch.argsort(s[10].to(torch.int32), stable=True)[:block]
    sub = _flat_while(take_lanes(prob, take), opts,
                      map_state(lambda a: a[take], s), None, check_every)
    s = map_state(lambda a, b: a.index_copy(0, take, b), s, sub)
    return _finalize(prob, _flat_while(prob, opts, s, None, check_every))


def map_state(fn, *states):
    """Apply ``fn`` leafwise over matching solver states (tuples of tensors
    and DualStates, every leaf with the batch leading)."""
    a = states[0]
    if isinstance(a, torch.Tensor):
        return fn(*states)
    if dataclasses.is_dataclass(a):
        return dataclasses.replace(a, **{
            f.name: map_state(fn, *(getattr(s, f.name) for s in states))
            for f in dataclasses.fields(a)})
    return tuple(map_state(fn, *leaves) for leaves in zip(*states))


def take_lanes(prob: Problem, take: torch.Tensor) -> Problem:
    """The problem of the lanes ``take`` [b] of a batch: x0 and the LTV
    stacks when per lane gathered, shared data as it is. Grouped stacks
    refuse (the gathered lanes would mix groups: gather
    ``dynamics.lanes(B)`` instead), as do a nonlinear model, a per-lane
    cost and per-lane constraint blocks, which no compacted path
    gathers."""
    dyn = prob.dynamics
    if (not isinstance(dyn, LTVDynamics) or dyn.grouped
            or prob.cost.per_lane
            or any(c.per_lane for c in prob.constraints)):
        raise ValueError("take_lanes gathers LTV stacks, shared or per lane, "
                         "under a shared cost and shared constraint blocks; "
                         "grouped stacks would mix groups: take "
                         "dynamics.lanes(B) first")
    if dyn.per_lane:
        dyn = LTVDynamics(A=dyn.A[take], B=dyn.B[take], d=dyn.d[take])
    return dataclasses.replace(prob, dynamics=dyn, x0=prob.x0[take])


@torch.no_grad()
def solve_resume(prob: Problem, opts: SolverOptions, state) -> Solution:
    """Continue a :func:`solve_partial` state to completion. Resuming a
    converged state is a no-op (one evaluation of the loop condition and no
    body pass). ``prob.x0`` is not read: the state carries the
    trajectory."""
    return _finalize(prob, _flat_while(prob, opts, state))


def _warmstart_state(prob: Problem, opts: SolverOptions,
                     U0: Optional[torch.Tensor],
                     duals: Optional[Tuple[DualState, ...]],
                     X0: Optional[torch.Tensor] = None):
    """Initial flat-loop state: warm-start rollout + dual init."""
    x0 = prob.x0
    if x0.dim() != 2:
        raise ValueError(f"solve takes a batch: x0 [B, n], got "
                         f"{tuple(x0.shape)}")
    Bt = x0.shape[0]
    N, n, m = prob.N, prob.n, prob.m
    kw = dict(dtype=x0.dtype, device=x0.device)
    if U0 is None:
        U0 = torch.zeros((Bt, N - 1, m), **kw)
    if X0 is not None:
        X0 = X0.clone()
        X0[:, 0] = x0
    elif not isinstance(prob.dynamics, LTVDynamics):
        # a nonlinear model: its own open-loop rollout
        X0 = prob.dynamics.rollout(x0, U0)
    else:
        # Open-loop rollout through the ladder-rollout kernel: with K = 0,
        # d = 0 the closed-loop ladder (L = 1, alpha = 1) reduces to
        # x+ = A x + B u0 + d.
        dyn = prob.dynamics
        Xb0 = torch.zeros((Bt, N, n), **kw)
        Xb0[:, 0] = x0
        Xts, _ = batched_ls_rollout(
            dyn.A, dyn.B, dyn.d, Xb0, U0, torch.zeros((Bt, N - 1, m, n), **kw),
            torch.zeros((Bt, N - 1, m), **kw), (1.0,), dyn.grouped)
        X0 = Xts[:, 0]

    if duals is None:
        duals = prob.init_duals(opts.penalty_initial)
    else:
        if opts.reset_duals:
            duals = tuple(DualState(lam=torch.zeros_like(d.lam), rho=d.rho)
                          for d in duals)
        if opts.reset_penalties:
            duals = tuple(
                DualState(lam=d.lam,
                          rho=torch.full_like(d.rho, opts.penalty_initial))
                for d in duals)

    K0 = torch.zeros((Bt, N - 1, m, n), **kw)
    zi = torch.zeros(Bt, dtype=torch.int32, device=x0.device)
    inf = torch.full((Bt,), math.inf, **kw)
    return (X0, U0, K0, duals, torch.full((Bt,), opts.reg_initial, **kw),
            inf, inf.clone(), zi, zi.clone(), zi.clone(),
            torch.zeros(Bt, dtype=torch.bool, device=x0.device))


def _flat_while(prob: Problem, opts: SolverOptions, s,
                it_cap: Optional[int] = None, check_every: int = 1):
    """The flat AL + iLQR loop from state ``s``, driven from the host until
    no lane is live (or every live lane has reached the absolute iteration
    count ``it_cap``), with ``check_every`` body passes between two tests of
    the live mask (the passes past the last lane's end are frozen
    no-ops)."""
    global eager_loop_count
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    eager_loop_count += 1
    ctx, cond, body = loop_fns(prob, opts, s, it_cap)
    if ctx.pass_tail:
        # the pass-tail kernel writes the state in place: not the caller's
        s = map_state(lambda a: a.clone(memory_format=torch.contiguous_format),
                      s)
    while bool(cond(s).any()):
        for _ in range(check_every):
            s = body(s)
    return s


def ltv_affine(prob: Problem) -> bool:
    """Whether the problem has LTV dynamics and only affine blocks: the
    fused kernels (the expansion, B; the ladder + merit, C) take nothing
    else, whatever the options say (the JAX package's gate)."""
    return (isinstance(prob.dynamics, LTVDynamics)
            and all(c.is_affine for c in prob.constraints))


def _runs_b(prob: Problem, opts: SolverOptions) -> bool:
    """Whether a pass runs kernel B, the fused expansion: on shared LTV
    data with affine blocks and ``fused_expansion`` on; the rest takes the
    split route (the expansion in PyTorch, then kernel D)."""
    return (not prob.per_lane and opts.fused_expansion
            and ltv_affine(prob))


def b_body(prob: Problem, opts: SolverOptions,
           device_type: str) -> Optional[str]:
    """The body kernel B takes in this problem's passes on a device of
    ``device_type`` (:func:`ops.riccati_fused.body`), or None where the
    passes take the split route."""
    if not _runs_b(prob, opts):
        return None
    return riccati_fused.body(prob.n, prob.m,
                              sum(c.p for c in prob.constraints),
                              device_type)


def _uses_fused_ladder(opts: SolverOptions, prob: Problem, X) -> bool:
    """Whether the line search takes the fused ladder + merit pass on the
    device of ``X``: never unless :func:`ltv_affine`; then ``ls_fused`` "on"
    always, "off" never, "auto" on a CUDA device for multi-block constraint
    sets (the classical ladder stays the CPU default, as in the JAX
    package)."""
    return _fused_ladder_on(opts, prob, X.device.type)


def _fused_ladder_on(opts: SolverOptions, prob: Problem,
                     device_type: str) -> bool:
    if opts.ls_fused == "off" or not ltv_affine(prob):
        return False
    return opts.ls_fused == "on" or (device_type == "cuda"
                                     and len(prob.constraints) > 1)


def uses_pass_tail(opts: SolverOptions, prob: Problem,
                   device_type: str) -> bool:
    """Whether a pass ends in the pass-tail kernel (ops/pass_tail.py) on a
    device of ``device_type``: on a CUDA device, where kernels B and C both
    run on shared data (the fused expansion and the fused ladder, shared
    affine blocks; grouped dynamics too: the tail reads no dynamics). The
    classical ladder, per-lane data, the split route, nonlinear dynamics and
    the CPU keep the plain tail."""
    return (device_type == "cuda" and not prob.per_lane
            and opts.fused_expansion
            and _fused_ladder_on(opts, prob, device_type))


@dataclass
class LoopContext:
    """What the loop body reads besides the problem and the state, built
    once per loop entry: the lane index [B], the line-search ladder (as
    floats, which the kernels take by value, and as a tensor), where a
    kernel that reads them runs (the fused expansion, the fused ladder on
    shared data), the constraint stacks packed for it, and whether a pass
    ends in the pass-tail kernel (:func:`uses_pass_tail`), which writes the
    state in place."""

    lanes: torch.Tensor
    alphas_t: Tuple[float, ...]
    alphas: torch.Tensor
    packed: Optional[PackedBlocks]
    pass_tail: bool


def loop_context(prob: Problem, opts: SolverOptions,
                 X_0: torch.Tensor) -> LoopContext:
    """The loop's per-entry host work for a batch shaped as ``X_0``
    [B, N, n]: the lane index, the alpha ladder plus the trailing alpha = 0
    rung (whose rollout reproduces the current trajectory: Jts[:, -1] is the
    current AL cost) and the fused kernels' row-concatenated constraint
    stacks, where either fused kernel runs (per-lane data, nonlinear
    dynamics and nonlinear blocks take neither)."""
    alphas_t = tuple(opts.ls_decrease ** i
                     for i in range(opts.iterations_linesearch)) + (0.0,)
    fused = (not prob.per_lane and ltv_affine(prob)
             and (opts.fused_expansion
                  or _uses_fused_ladder(opts, prob, X_0)))
    packed = (pack_blocks(prob.constraints, prob.N, prob.n, prob.m, X_0)
              if X_0.device.type == "cuda" and fused else None)
    return LoopContext(
        lanes=torch.arange(X_0.shape[0], device=X_0.device),
        alphas_t=alphas_t,
        alphas=torch.tensor(alphas_t, dtype=X_0.dtype, device=X_0.device),
        packed=packed,
        pass_tail=uses_pass_tail(opts, prob, X_0.device.type))


def loop_fns(prob: Problem, opts: SolverOptions, s0, it_cap=None,
             ctx: Optional[LoopContext] = None):
    """(ctx, cond, body) of the flat AL + iLQR loop for the batch of state
    ``s0``: ``ctx`` is the loop's :class:`LoopContext` (built from ``s0``
    unless given), ``cond(s)`` the per-lane live mask [B] and ``body(s)``
    one pass, which freezes every lane whose own ``cond`` is false, so
    passes beyond a lane's end change nothing (``body(s, live)`` takes
    ``cond(s)`` computed by the caller). Where ``ctx.pass_tail``, the body
    writes the new state into the tensors of ``s`` in place and returns
    ``s``, and ``body(s, counts=(c, first, last))`` adds the lanes live on
    entry (``first``) and after the pass (``last``) to the int32 pair c
    (:func:`ops.pass_tail.al_pass_tail`); otherwise it returns a new
    state. ``it_cap``: lanes stop being live at that absolute iteration
    count (an int, or a 0-d int32 tensor on the batch's device, read at
    every pass). ``body`` reads nothing but the tensors of ``prob``,
    ``ctx``, ``it_cap`` and its state and makes no host sync, so it can be
    captured in a CUDA graph (solver/graph.py); a gathered block of lanes
    runs the kernels at its own batch size. The body is
    ``tail(s, head(s), live, counts)`` of :func:`pass_fns`."""
    ctx, cond, head, tail = pass_fns(prob, opts, s0, it_cap, ctx)

    def body(s, live=None, counts=None):
        return tail(s, head(s), live, counts)

    return ctx, cond, body


def pass_fns(prob: Problem, opts: SolverOptions, s0, it_cap=None,
             ctx: Optional[LoopContext] = None):
    """(ctx, cond, head, tail) of :func:`loop_fns`'s pass, split where the
    pass tail begins: ``head(s)`` runs kernel B's and the line search's
    part of a pass and returns the tail's inputs (K, d, dV1, dV2, the
    ladder's Xs, Us and merits J, and every rung's residuals and projected
    duals on the classical ladder, else None); ``tail(s, ins, live=None,
    counts=None)`` ends the pass (:func:`ops.pass_tail.al_pass_tail` where
    ``ctx.pass_tail``, else :func:`ops.pass_tail.pass_tail_reference`)."""
    X_0 = s0[0]
    if ctx is None:
        ctx = loop_context(prob, opts, X_0)
    lanes, alphas_t, alphas = ctx.lanes, ctx.alphas_t, ctx.alphas
    packed = ctx.packed
    dyn = prob.dynamics
    fused_ladder = _uses_fused_ladder(opts, prob, X_0)
    # the fused kernels read shared LTV data (or LTV stacks with a group
    # axis) and shared affine blocks only. Per-lane data (dynamics, cost or
    # constraint blocks), nonlinear dynamics and nonlinear blocks take the
    # split route (the linearization and the expansion in PyTorch, then the
    # Riccati pass; grouped stacks come per lane from the linearization),
    # as does any problem with opts.fused_expansion off; on per-lane LTV
    # data the line search's fused branch runs the ladder rollout and the
    # merit in PyTorch
    per_lane = prob.per_lane
    split = not _runs_b(prob, opts)
    grouped = isinstance(dyn, LTVDynamics) and dyn.grouped

    def cond(s):
        return live_mask(s, opts, it_cap)

    def head(s):
        global pass_count
        pass_count += 1
        X, U, duals, reg = s[0], s[1], s[3], s[4]
        lams = tuple(d.lam for d in duals)
        rhos = tuple(d.rho for d in duals)
        if split:
            # relinearize about the iterate (the LTV stacks as they are)
            A, B, _ = dyn.linearize(X, U)
            lx, lu, lxx, luu, lux = _al_expansion_cd(prob.cost,
                                                     prob.constraints,
                                                     duals, X, U)
            Knew, dff, dV1, dV2 = backward_pass(A, B, lx, lu, lxx, luu, lux,
                                                reg)
        else:
            Knew, dff, dV1, dV2 = fused_expand_backward(
                prob.cost, dyn.A, dyn.B, prob.constraints, X, U, lams, rhos,
                reg, packed=packed, grouped=grouped)
        if (not split or fused_ladder) and len(rhos) > 1:
            # the fused expansion and the fused ladder read one shared
            # penalty schedule (rhos[0]): poison the feedforward of lanes
            # whose blocks diverge, so the wrongness is loud instead of
            # silent (the classical split route reads every block's own)
            rho_dev = sum(torch.amax(torch.abs(r - rhos[0]), dim=-1)
                          for r in rhos[1:])
            dff = torch.where((rho_dev > 0)[:, None, None], math.nan, dff)

        # parallel line search over the whole ladder
        rho0 = rhos[0] if rhos else torch.zeros_like(X[..., 0])
        rungs = None
        if fused_ladder and per_lane:
            # the fused branch's arithmetic with per-lane dynamics: the
            # ladder rollout, then each rung's cost and AL merit tail
            Xts, Uts = batched_ls_rollout(dyn.A, dyn.B, dyn.d, X, U, Knew,
                                          dff, alphas_t, grouped)
            Jts = prob.cost.total(Xts, Uts) + _al_merit_tail(
                prob.constraints, tuple(lam[:, None] for lam in lams),
                rho0[:, None], Xts, Uts)
        elif fused_ladder:
            Xts, Uts, Jts = batched_ls_rollout_al(
                prob.cost, dyn.A, dyn.B, dyn.d, prob.constraints, X, U, Knew,
                dff, lams, rho0, alphas_t, packed=packed, grouped=grouped)
        else:
            Xts, Uts = rollout_closed_loop(dyn, X, U, Knew, dff, alphas_t,
                                           alphas)
            duals_l = tuple(DualState(lam=d.lam[:, None], rho=d.rho[:, None])
                            for d in duals)
            Jts, rungs = total_al_cost_res(prob, duals_l, Xts, Uts)
        return Knew, dff, dV1, dV2, Xts, Uts, Jts, rungs

    def tail(s, ins, live=None, counts=None):
        """The rung choice, the adopted trajectory's residuals, the AL
        round update, the stop tests and the freeze."""
        Knew, dff, dV1, dV2, Xts, Uts, Jts, rungs = ins
        if ctx.pass_tail:
            return al_pass_tail(prob.constraints, opts, s, Knew, dff, dV1,
                                dV2, Xts, Uts, Jts, alphas_t, packed=packed,
                                it_cap=it_cap, live=live, counts=counts)
        return pass_tail_reference(
            prob.constraints, opts, s, cond(s) if live is None else live,
            Knew, dff, dV1, dV2, Xts, Uts, Jts, alphas, lanes, rungs=rungs)

    return ctx, cond, head, tail


def _finalize(prob: Problem, s) -> Solution:
    X, U, K, duals, reg, grad, viol, it_rd, it, rounds, done = s
    if len(prob.constraints) == 0:
        # unconstrained: zero violation, unconditional success
        viol = torch.zeros_like(viol)
    stats = Stats(iterations=it, outer_iterations=rounds,
                  cost=prob.cost.total(X, U), viol=viol, gradient=grad,
                  status=done.to(torch.int32))
    return Solution(X=X, U=U, K=K, duals=duals, stats=stats)
