"""Warm-started receding-horizon MPC step (PyTorch counterpart of the
batched steps of ``altro_tpu/mpc.py``).

Each step of a batch of scenarios:

    propagate x0 through the first control (+ noise)
    advance the tracking-cost window          (once for the whole batch, or
                                               per lane with ``shared_k``
                                               off)
    refresh the constraint window             (``constraints_fn``, if given)
    refresh the dynamics window               (``dynamics_fn``, if given)
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
:func:`run_compacted_step` drives the same schedule from the host, from the
pieces of :func:`make_mpc_step_compacted`.

:func:`make_regulator_step` is the step of a regulator MPC (the flexible
satellite's), plain or compacted: the window never moves, so every step
re-solves one problem from the propagated x0, warm-started from the carried
controls, duals and exactly re-based states.

:func:`make_relinearized_step` is the warm solve of a controller whose
dynamics change at every call (the quadruped's closed loop): the new
dynamics and x0 come in with the carry, the controls and duals shift.

Every step factory runs on CUDA graphs on a CUDA device (``graphed``;
``solver/graph.py``): per batch size a start graph (propagation, noise,
retarget, constraint window, shift, seam corrector, warm-start state), a
loop graph per level batch and a finish graph, replayed with one host sync
per k loop passes; ``graphed=False`` keeps the host-driven loop.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from .constraints import DualState
from .costs import retarget_tracking, tracking_objective
from .dynamics import LTVDynamics, lane_mv
from .problem import Problem
from .solver import graph
from .solver.altro import _finalize, _flat_while, _warmstart_state
from .solver.altro import map_state as _state_map
from .solver.graph import LoopGraph, Replayable, clone_tree, copy_into
from .solver.options import SolverOptions
from .utils import profiling


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
                          d=dyn.d[..., :N_mpc - 1, :].contiguous(),
                          grouped=dyn.grouped)
    cons = []
    for c in prob.constraints:
        if c.name == "goal":
            continue
        mask = c.mask[:N_mpc].clone()
        mask[N_mpc - 1] = 0.0
        # the knot axis leads the block's stacks, after a lane axis if any
        cons.append(dataclasses.replace(
            c, Cx=c.Cx[..., :N_mpc, :, :].contiguous(),
            Cu=c.Cu[..., :N_mpc, :, :].contiguous(),
            b=c.b[..., :N_mpc, :].contiguous(), mask=mask))
    return Problem(dynamics=dyn_mpc, cost=cost, constraints=tuple(cons),
                   x0=X_track[0])


def shift_fill(arr):
    """Shift one knot forward along axis -2, repeating the last entry."""
    return torch.cat([arr[..., 1:, :], arr[..., -1:, :]], dim=-2)


def track_window(X_track, U_track, k0, N: int):
    """The [k0, k0+N) tracking window, clamped at the tail like
    ``lax.dynamic_slice``. ``k0`` an int: (X [N, n], U [N-1, m]); an
    integer tensor [B] of per-lane indices: every lane's window
    (X [B, N, n], U [B, N-1, m]) gathered on the device, with no host sync
    (capturable in a CUDA graph)."""
    if isinstance(k0, torch.Tensor):
        ar = torch.arange(N, device=k0.device)
        kx = torch.clamp(k0, 0, X_track.shape[0] - N)
        ku = torch.clamp(k0, 0, U_track.shape[0] - (N - 1))
        return X_track[kx[:, None] + ar], U_track[ku[:, None] + ar[:-1]]
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
    for per-lane or grouped stacks (the solve then runs its init rollout).
    """
    if not isinstance(dyn, LTVDynamics) or dyn.per_lane or dyn.grouped:
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
        """X [B, N, n], U_ws [B, N-1, m], x0_new [B, n] -> [B, N, n]; each
        lane's products its own (a lane's bits do not depend on the
        batch)."""
        x_ext = lane_mv(A_l, X[:, -1]) + lane_mv(B_l, U_ws[:, -1]) + d_l
        Xs = torch.cat([X[:, 1:], x_ext[:, None]], dim=1)
        e0 = x0_new - Xs[:, 0]
        return Xs + lane_mv(Phis, e0[:, None, :])

    return correct


def knot0(dyn: LTVDynamics) -> LTVDynamics:
    """The first knot of LTV stacks (a one-knot view, grouped or not): the
    dynamics a window's first control is applied with."""
    return LTVDynamics(A=dyn.A[..., :1, :, :], B=dyn.B[..., :1, :, :],
                       d=dyn.d[..., :1, :], grouped=dyn.grouped)


class _Pieces:
    """What the step pieces share: ``start(carry, noise_i, k)`` runs the
    host part for step ``k`` and then the tensor part; ``finish(prob_k,
    state, x0_new)`` returns (the next carry, MPCResults). ``dyn_inputs``
    trailing entries of the host part are the dynamics window (copied
    under their own span), and ``groups`` > 0 (a grouped dynamics window)
    adds each group's lane-max iterations to the finish graph's results."""

    dyn_inputs = 0
    groups = 0

    def start(self, carry, noise_i, k: int):
        return self.start_from(carry, noise_i, *self.window(k + 1))

    def finish(self, prob_k, state, x0_new):
        sol = _finalize(prob_k, state)
        out = MPCResults(X=sol.X, U=sol.U, iters=sol.stats.iterations,
                         status=sol.stats.status, viol=sol.stats.viol,
                         x0=x0_new)
        return (x0_new, sol.X, sol.U, sol.duals), out


class _StepPieces(_Pieces):
    """The parts of a batched MPC step that every form of it shares.

    ``window(k_new)`` is the host's part, which depends on the Python step
    index: the tracking window (Xw, Uw), the constraint window (None:
    ``prob_mpc``'s blocks) and, with ``dynamics_fn``, the dynamics window
    ``dynamics_fn(k_new)`` and the first knot of ``dynamics_fn(k_new - 1)``
    (the plant). The rest is a function of tensors alone:
    ``start_from(carry, noise_i, Xw, Uw, cons[, dyn, plant])`` propagates
    the carry and returns (the window's problem, the solver's initial
    state, x0_new); ``finish(prob_k, state, x0_new)`` returns (the next
    carry, MPCResults)."""

    def __init__(self, prob_mpc: Problem, opts: SolverOptions, X_track,
                 U_track, noise_model, constraints_fn, warm_start: str,
                 dynamics_fn=None):
        if warm_start not in ("shift", "track"):
            raise ValueError(f"warm_start must be 'shift' or 'track', got "
                             f"{warm_start!r}")
        self.prob_mpc, self.opts = prob_mpc, opts
        self.X_track, self.U_track = X_track, U_track
        self.noise_model, self.constraints_fn = noise_model, constraints_fn
        self.warm_start = warm_start
        self.dynamics_fn = dynamics_fn
        if dynamics_fn is None:
            self.xws = _xws_corrector(prob_mpc.dynamics)
        else:
            # the windows move: no exact seam, the solve's init rollout
            self.xws = None
            self.dyn_inputs = 2
            self.groups = dynamics_fn(0).groups

    def window(self, k_new: int):
        Xw, Uw = track_window(self.X_track, self.U_track, k_new,
                              self.prob_mpc.N)
        # time-varying constraint window, cut from full-horizon stacks
        cons = (None if self.constraints_fn is None
                else tuple(self.constraints_fn(k_new)))
        if self.dynamics_fn is None:
            return Xw, Uw, cons
        return (Xw, Uw, cons, self.dynamics_fn(k_new),
                knot0(self.dynamics_fn(k_new - 1)))

    def prob_from(self, Xw, Uw, cons, x0, dyn=None) -> Problem:
        pm = self.prob_mpc
        more = {} if dyn is None else {"dynamics": dyn}
        return dataclasses.replace(
            pm, cost=retarget_tracking(pm.cost, Xw, Uw), x0=x0,
            constraints=pm.constraints if cons is None else cons, **more)

    def prob_at(self, k_new: int, x0):
        Xw, Uw, cons, *dyn = self.window(k_new)
        return self.prob_from(Xw, Uw, cons, x0, *dyn[:1]), Uw

    def start_from(self, carry, noise_i, Xw, Uw, cons, dyn=None,
                   plant=None):
        x0, X, U, duals = carry
        plant = self.prob_mpc.dynamics if plant is None else plant
        x0_new = self.noise_model(plant.step(x0, U[:, 0], 0), noise_i)
        prob_k = self.prob_from(Xw, Uw, cons, x0_new, dyn)
        if self.warm_start == "shift":
            U_ws = shift_fill(U)
            X_ws = None if self.xws is None else self.xws(X, U_ws, x0_new)
        else:
            U_ws = Uw.expand(U.shape).contiguous()
            X_ws = None
        duals_ws = tuple(d.shift() for d in duals)
        return (prob_k,
                _warmstart_state(prob_k, self.opts, U_ws, duals_ws, X_ws),
                x0_new)

    def init_carry(self, batch: int, graphed: bool, check_every: int):
        """Cold batched solve of the first window from X_track[0] (with
        ``dynamics_fn``, on the dynamics ``dynamics_fn(0)``)."""
        pm = self.prob_mpc
        if self.dynamics_fn is not None:
            pm = dataclasses.replace(pm, dynamics=self.dynamics_fn(0))
        x0 = pm.x0.expand(batch, pm.n).contiguous()
        sol0 = graph.solve(dataclasses.replace(pm, x0=x0), self.opts,
                           graphed=graphed, check_every=check_every)
        return (x0, sol0.X, sol0.U, sol0.duals)


class _LanePieces(_StepPieces):
    """The step of :class:`_StepPieces` with the window index in the carry,
    one per lane (``make_mpc_step(shared_k=False)``): carry = (x0, X, U,
    duals, k) with k an int64 tensor [B]. The host part is empty; the
    tensor part advances k, gathers every lane's tracking window, retargets
    the cost per lane and (with ``constraints_fn``) builds every lane's
    constraint blocks at its own window (``constraints_fn(k_new)`` with the
    [B] tensor: per-lane blocks), all on the device, so the solve runs on
    per-lane data (the solver's split route). ``finish`` returns the next
    carry with the advanced k."""

    def window(self, k_new: int):
        return ()

    def start_from(self, carry, noise_i):
        *rest, k = carry
        k_new = k + 1
        Xw, Uw = track_window(self.X_track, self.U_track, k_new,
                              self.prob_mpc.N)
        cons = (None if self.constraints_fn is None
                else tuple(self.constraints_fn(k_new)))
        prob_k, s0, x0_new = super().start_from(tuple(rest), noise_i, Xw,
                                                Uw, cons)
        return prob_k, s0, (x0_new, k_new)

    def finish(self, prob_k, state, out):
        x0_new, k_new = out
        carry, res = super().finish(prob_k, state, x0_new)
        return carry + (k_new,), res

    def init_carry(self, batch: int, graphed: bool, check_every: int,
                   start_k=0):
        carry = super().init_carry(batch, graphed, check_every)
        k = torch.as_tensor(start_k, dtype=torch.int64,
                            device=carry[0].device)
        return carry + (k.expand(batch).clone(),)


# the regulator's process noise per step, times a standard normal draw
# (the flexible satellite's, flexible_sat_mpc.jl:261-276)
REGULATOR_NOISE = 2e-4


class _RegulatorPieces(_Pieces):
    """The step of a regulator MPC (the flexible satellite's), in the form
    of :class:`_StepPieces`: the window never moves, so the host part
    (``window``) is empty and every step solves the one problem ``prob``
    from a new x0. ``start_from(carry, noise_i)`` propagates x0 through the
    first control plus REGULATOR_NOISE times the noise row and seeds the
    solve with the carried controls, the carried duals (unshifted) and the
    carried states re-based exactly onto the new x0: with LTI dynamics the
    rollout of U from x0_new is X + A^k (x0_new - X[0]), so the solve
    linearizes its first iteration there without an init rollout."""

    def __init__(self, prob: Problem, opts: SolverOptions):
        dyn = prob.dynamics
        if not isinstance(dyn, LTVDynamics) or dyn.per_lane or dyn.grouped:
            raise ValueError("the regulator step takes shared LTI dynamics: "
                             "its exact re-basing X + A^k e0 reads one A "
                             "for every lane, not per-lane or grouped "
                             "stacks")
        self.prob_mpc, self.opts = prob, opts
        # Phi[k] = A^k, built in float64 from the problem's own A and cast
        A0 = dyn.A[0].double().cpu().numpy()
        Ph = np.empty((prob.N,) + A0.shape)
        Ph[0] = np.eye(A0.shape[0])
        for k in range(1, prob.N):
            Ph[k] = A0 @ Ph[k - 1]
        self.Phis = torch.as_tensor(Ph, dtype=dyn.A.dtype,
                                    device=dyn.A.device)

    def window(self, k_new: int):
        return ()

    def prob_at(self, k_new: int, x0):
        return dataclasses.replace(self.prob_mpc, x0=x0), None

    def start_from(self, carry, noise_i):
        x0, X, U, duals = carry
        x0_new = (self.prob_mpc.dynamics.step(x0, U[:, 0], 0)
                  + REGULATOR_NOISE * noise_i)
        X0 = X + lane_mv(self.Phis, (x0_new - X[:, 0])[:, None, :])
        prob_k = dataclasses.replace(self.prob_mpc, x0=x0_new)
        return (prob_k, _warmstart_state(prob_k, self.opts, U, duals, X0),
                x0_new)

    def init_carry(self, batch: int, graphed: bool, check_every: int,
                   sol0=None):
        """``sol0`` (a solution of ``prob`` from its x0 as one scenario)
        copied to ``batch`` lanes; None: the cold solve of ``prob`` as one
        scenario."""
        pm = self.prob_mpc
        if sol0 is None:
            sol0 = graph.solve(dataclasses.replace(pm, x0=pm.x0[None]),
                               self.opts, graphed=graphed,
                               check_every=check_every)

        def lanes(a):
            return a.repeat((batch,) + (1,) * (a.dim() - 1))
        return (lanes(pm.x0[None]), lanes(sol0.X), lanes(sol0.U),
                tuple(DualState(lam=lanes(d.lam), rho=lanes(d.rho))
                      for d in sol0.duals))


class _RelinearizedPieces(_Pieces):
    """The warm solve of a problem whose dynamics change at every call (a
    controller that relinearizes about its contact schedule, as the
    quadruped's), in the form of :class:`_StepPieces` with an empty host
    part. ``start_from(carry, dyn)``, carry = (x0 [B, n], U [B, N-1, m],
    duals), solves ``prob`` with the dynamics ``dyn`` from x0, seeded with
    the controls shifted one knot (``shift_fill``) and the shifted duals and
    without states, so the solve starts with its init rollout;
    ``finish`` returns (the next carry (x0, U, duals), MPCResults)."""

    def __init__(self, prob: Problem, opts: SolverOptions):
        self.prob_mpc, self.opts = prob, opts

    def window(self, k_new: int):
        return ()

    def start_from(self, carry, dyn):
        x0, U, duals = carry
        prob_k = dataclasses.replace(self.prob_mpc, dynamics=dyn, x0=x0)
        return (prob_k,
                _warmstart_state(prob_k, self.opts, shift_fill(U),
                                 tuple(d.shift() for d in duals)),
                x0)

    def finish(self, prob_k, state, x0_new):
        (x0, _, U, duals), out = super().finish(prob_k, state, x0_new)
        return (x0, U, duals), out


class _GraphedStep:
    """An MPC step factory's graphs, one set per batch size, sharing one
    CUDA graph memory pool: the start graph, one loop graph per level batch
    of the compaction schedule ``sched`` (``((it_cap, block), (extra_cap,
    sub_block), ...)``; empty for the plain step) with a gather and a
    scatter graph between two levels, and the finish graph. The host copies
    each step's carry, step input (a noise row; the relinearized step's
    dynamics), tracking window, (with ``constraints_fn``) constraint window
    and (with ``dynamics_fn``) dynamics window into the start graph's input
    buffers, replays start, each loop graph until no lane is live (one host
    sync per k passes, every catch-all one replay and one sync), and
    finish, and returns clones of the finish graph's results. On a grouped
    dynamics window the finish graph also takes each group's lane-max
    iterations (one [G] amax), cloned with the results while tracing is on
    (the ``step.out`` span's ``group_iters``).

    Called as ``step(carry, noise_i, k)``. ``loop_replays`` counts the loop
    graphs' replays and ``capture_s`` the host seconds spent capturing.
    While tracing is on (``utils.profiling``) a call is a ``step`` request
    with the spans that module lists."""

    def __init__(self, pieces: _StepPieces, opts: SolverOptions, sched,
                 check_every: int):
        self.pieces, self.opts = pieces, opts
        self.sched, self.check_every = tuple(sched), check_every
        self.sets, self.resumes = {}, {}
        self.pool = None
        self.loop_replays = 0
        self.capture_s = 0.0

    def _pool(self, device):
        if device.type == "cuda" and self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        return self.pool

    def _graphs(self, inputs):
        batch = inputs[0][0].shape[0]
        if batch not in self.sets:
            self.sets[batch] = self._build(inputs)
        return self.sets[batch]

    def _build(self, inputs):
        with profiling.span("build", lanes=int(inputs[0][0].shape[0])):
            return self._capture(inputs)

    @torch.no_grad()
    @graph.capturing()
    def _capture(self, inputs):
        t0 = time.perf_counter()
        dev = inputs[0][0].device
        pool = self._pool(dev)
        ins = clone_tree(inputs)
        with graph.uncounted():
            prob_k, s0, _ = self.pieces.start_from(*ins)
        # the loop graphs' buffers first; then every graph captured in the
        # order of its first replay (start, level 0's loop, gather, level
        # 1's loop, ..., the scatters from the innermost out, finish), so
        # that a result one graph hands to another (x0_new, the gathered
        # lane index) lives where no graph captured before it computes
        loops = [LoopGraph(prob_k, self.opts, s0,
                           check_every=self.check_every, pool=pool,
                           capture=False)]
        for _, block in self.sched:
            blk = min(block, loops[-1].state[0].shape[0])
            loops.append(LoopGraph(
                None, self.opts,
                _state_map(lambda a: a[:blk], loops[-1].state),
                check_every=self.check_every, pool=pool, share=loops[-1],
                capture=False))
        for lvl, loop in enumerate(loops):
            loop.name, loop.level = f"loop.L{lvl}", lvl

        def start_fn():
            p, s, x0_new = self.pieces.start_from(*ins)
            loops[0].load(p, s)
            return x0_new

        start = Replayable(start_fn, dev, pool, "graph.start")
        loops[0].capture()
        gathers = []
        for lvl, (parent, child) in enumerate(zip(loops, loops[1:])):
            gathers.append(Replayable(
                graph.gather_fn(parent, child, child.state[0].shape[0]), dev,
                pool, f"graph.gather.L{lvl}"))
            child.capture()
        scatters = [None] * len(gathers)
        for lvl in reversed(range(len(gathers))):
            scatters[lvl] = Replayable(graph.scatter_fn(
                loops[lvl], loops[lvl + 1], gathers[lvl]), dev, pool,
                f"graph.scatter.L{lvl}")
        G = self.pieces.groups

        def finish_fn():
            res = self.pieces.finish(loops[0].prob, loops[0].state, start.out)
            if G:
                res += (res[1].iters.reshape(G, -1).amax(dim=1),)
            return res

        finish = Replayable(finish_fn, dev, pool, "graph.finish")
        dyn_bytes = sum(t.numel() * t.element_size() for t in graph.tensors(
            ins[len(ins) - self.pieces.dyn_inputs:]))
        self.capture_s += time.perf_counter() - t0
        return SimpleNamespace(inputs=ins, start=start, loops=loops,
                               gathers=gathers, scatters=scatters,
                               finish=finish, dyn_bytes=dyn_bytes)

    def _run(self, loop: LoopGraph, it_cap, rest: bool = False) -> None:
        loop.set_cap(it_cap)
        self.loop_replays += loop.run(rest)

    def _compact(self, g, lvl: int, cum: int) -> None:
        # the level's batch has run to the absolute cap `cum`: gather its
        # block of stragglers, finish them (through the deeper levels),
        # scatter them back, then catch-all to completion
        g.gathers[lvl].replay()
        if lvl + 1 < len(self.sched):
            extra = self.sched[lvl + 1][0]
            self._run(g.loops[lvl + 1], cum + extra)
            self._compact(g, lvl + 1, cum + extra)
        else:
            self._run(g.loops[lvl + 1], None)
        g.scatters[lvl].replay()
        self._run(g.loops[lvl], None, rest=True)

    def _start(self, carry, noise_i, k: int, tr=None):
        sp = None if tr is None else tr.open("step.inputs")
        inputs = (carry, noise_i) + self.pieces.window(k + 1)
        g = self._graphs(inputs)
        rest = len(inputs) - self.pieces.dyn_inputs
        copy_into(g.inputs[:rest], inputs[:rest], "step inputs")
        if self.pieces.dyn_inputs:
            sd = (None if tr is None
                  else tr.open("step.dynamics", bytes=g.dyn_bytes))
            copy_into(g.inputs[rest:], inputs[rest:], "step dynamics")
            if sd is not None:
                tr.close(sd)
        if sp is not None:
            tr.close(sp)
        g.start.replay()
        return g

    @torch.no_grad()
    def __call__(self, carry, noise_i, k: int):
        tr = profiling.tracer
        if tr is None:
            return self._step(carry, noise_i, k, None)
        with tr.request("step"):
            return self._step(carry, noise_i, k, tr)

    def _step(self, carry, noise_i, k: int, tr):
        g = self._start(carry, noise_i, k, tr)
        if self.sched:
            self._run(g.loops[0], self.sched[0][0])
            self._compact(g, 0, self.sched[0][0])
        else:
            self._run(g.loops[0], None)
        g.finish.replay()
        if tr is None:
            return clone_tree(g.finish.out[:2])
        with tr.span("step.out") as sp:
            res = clone_tree(g.finish.out)
            if self.pieces.groups:
                sp.args.update(groups=self.pieces.groups,
                               group_iters=res[2])
            return res[:2]

    @torch.no_grad()
    def partial(self, carry, noise_i, k: int, it_cap: int):
        g = self._start(carry, noise_i, k)
        self._run(g.loops[0], it_cap)
        return clone_tree(g.loops[0].state), clone_tree(g.start.out)

    @torch.no_grad()
    def resume(self, state, k: int, it_cap=None):
        prob_k, _ = self.pieces.prob_at(k + 1, self.pieces.prob_mpc.x0)
        batch = state[0].shape[0]
        if batch not in self.resumes:
            t0 = time.perf_counter()
            with profiling.span("build", lanes=batch):
                self.resumes[batch] = LoopGraph(
                    prob_k, self.opts, state, check_every=self.check_every,
                    pool=self._pool(state[0].device))
            self.resumes[batch].name = "loop.resume"
            self.capture_s += time.perf_counter() - t0
        loop = self.resumes[batch]
        loop.load(prob_k, state)
        self._run(loop, it_cap)
        return clone_tree(loop.state)


class _LaneStep(_GraphedStep):
    """The graphed step of per-lane window indices (:class:`_LanePieces`),
    called as ``step(carry, noise_i)``."""

    def __call__(self, carry, noise_i):
        return super().__call__(carry, noise_i, 0)


def make_mpc_step(prob_mpc: Problem, opts: SolverOptions, X_track, U_track,
                  noise_model=default_noise_model, constraints_fn=None,
                  shared_k: bool = True, warm_start: str = "shift",
                  graphed: Optional[bool] = None, check_every: int = 1,
                  dynamics_fn=None):
    """Build the batched warm-started MPC step
    ``step(carry, noise [B, n], k) -> (carry, MPCResults)`` and
    ``init_carry(batch) -> carry`` with carry = (x0, X, U, duals), all
    batched. Every scenario sits at the same window index ``k``, so the
    tracking window, the cost retarget and the constraint window are
    computed once per step and the solve runs on a shared cost
    (``shared_k=True``, the default here).

    ``shared_k=False`` (the JAX package's default, which steps one
    scenario and is vmapped): each lane carries its own window index,
    ``step(carry, noise [B, n]) -> (carry, MPCResults)`` with carry =
    (x0, X, U, duals, k), k an int64 tensor [B] that every step advances
    by one, and ``init_carry(batch, start_k=0)`` with ``start_k`` an int or
    a [B] tensor of start indices (the carry's solution is the cold solve
    of ``prob_mpc``'s own window, as in the JAX package). Every lane gets
    its own tracking window and cost (gathered on the device), so the solve
    takes the split route: the AL expansion in PyTorch, then the Riccati
    pass (kernel D on the card), and the classical ladder (or, with
    ``opts.ls_fused`` on, the ladder rollout and the merit in PyTorch).

    ``constraints_fn(k)``: the constraint blocks of the window starting at
    knot ``k`` (time-varying constraints, as grasp's rotating contact
    frames), refreshed every step; ``None`` keeps ``prob_mpc``'s blocks.
    With ``shared_k=False`` it is called with the int64 tensor [B] of the
    lanes' window indices and returns per-lane blocks (stacks [B, N, ...],
    as ``models.grasp.grasp_constraints`` builds them), built on the
    device with no host sync (the graphed step captures the call).

    ``dynamics_fn(k)``: the dynamics of the window starting at step ``k``
    (an ``LTVDynamics`` of ``prob_mpc``'s shapes, shared, per lane or
    grouped [G, N-1, ...]; a controller that relinearizes about a moving
    contact schedule), refreshed every step, the counterpart of
    ``constraints_fn``; ``init_carry`` solves on ``dynamics_fn(0)``. Step
    ``k`` solves on ``dynamics_fn(k + 1)`` and propagates each lane from
    step ``k - 1`` with the first knot of ``dynamics_fn(k)`` (each lane's
    group's, on grouped stacks): the dynamics its applied control was
    planned with. The windows move, so the shift warm start has no exact
    seam corrector: every solve starts with its init rollout. ``None``
    keeps ``prob_mpc.dynamics`` (time-invariant across steps); only the
    shared-k step takes it.

    ``warm_start``: "shift" carries the previous solution (controls shifted
    one knot, duals shifted, states seam-corrected by
    :func:`_xws_corrector`); "track" seeds every solve from the tracking
    window's controls, with no states (the solve runs its init rollout),
    while the duals still shift (``opts.reset_duals`` then zeroes them).

    ``graphed`` (None: on a CUDA device): the step runs as CUDA graphs,
    captured at its first call for each batch size (start, loop, finish;
    ``solver/graph.py``; on the CPU the same route over fixed buffers,
    without capture), and ``init_carry``'s cold solve as a
    ``graph.GraphedSolve``; else the host-driven loop. ``check_every``:
    body passes between two tests of the live mask."""
    graphed = graph.use_graphs(graphed, prob_mpc.x0.device)
    if shared_k:
        pieces = _StepPieces(prob_mpc, opts, X_track, U_track, noise_model,
                             constraints_fn, warm_start, dynamics_fn)
        return _make_step(pieces, opts, (), graphed, check_every)
    if dynamics_fn is not None:
        raise NotImplementedError("dynamics_fn takes the shared-k step: "
                                  "per-lane window indices would gather "
                                  "every lane's dynamics window")
    lanes = _LanePieces(prob_mpc, opts, X_track, U_track, noise_model,
                        constraints_fn, warm_start)

    def init_carry(batch: int, start_k=0):
        return lanes.init_carry(batch, graphed, check_every, start_k)

    if graphed:
        return _LaneStep(lanes, opts, (), check_every), init_carry
    eager, _ = _make_step(lanes, opts, (), False, check_every)
    return (lambda carry, noise_i: eager(carry, noise_i, 0)), init_carry


def make_mpc_step_compacted(prob_mpc: Problem, opts: SolverOptions,
                            X_track, U_track,
                            noise_model=default_noise_model,
                            constraints_fn=None, it_cap: int = 24,
                            warm_start: str = "shift",
                            graphed: Optional[bool] = None,
                            check_every: int = 1):
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
    not read on resume: the state carries the trajectory. ``graphed`` and
    ``check_every`` as in :func:`make_mpc_step`: graphed, ``partial`` is
    the start and loop graphs of the state's batch and ``resume`` a loop
    graph per batch size, into which it copies the window's problem and
    the state."""
    pieces = _StepPieces(prob_mpc, opts, X_track, U_track, noise_model,
                         constraints_fn, warm_start)
    graphed = graph.use_graphs(graphed, prob_mpc.x0.device)
    runner = _GraphedStep(pieces, opts, (), check_every) if graphed else None

    @torch.no_grad()
    def partial(carry, noise_i, k: int):
        if runner is not None:
            return runner.partial(carry, noise_i, k, it_cap)
        prob_k, state, x0_new = pieces.start(carry, noise_i, k)
        return _flat_while(prob_k, opts, state, it_cap,
                           check_every), x0_new

    @torch.no_grad()
    def resume(state, k: int, it_cap=None):
        if runner is not None:
            return runner.resume(state, k, it_cap)
        prob_k, _ = pieces.prob_at(k + 1, prob_mpc.x0)
        return _flat_while(prob_k, opts, state, it_cap, check_every)

    def extract(state, x0_new, k: int):
        prob_k, _ = pieces.prob_at(k + 1, prob_mpc.x0)
        return pieces.finish(prob_k, state, x0_new)

    def init_carry(batch: int):
        return pieces.init_carry(batch, graphed, check_every)

    return partial, resume, extract, init_carry


def run_compacted_step(partial, resume, extract, carry, noise_t, k: int,
                       block: int = 128):
    """One compacted MPC step driven from the host, from the pieces of
    :func:`make_mpc_step_compacted`: the capped full-batch pass
    (``partial``), then the indices of the lanes not done, read on the
    host, resumed to completion ``block`` at a time (each gather padded by
    cycling its lanes, which is safe: a lane resumed twice scatters the
    same converged state) and scattered back, then ``extract``. Returns
    ``(carry, MPCResults)``, the plain step's results. The card's form is
    :func:`make_mpc_step_device_compacted`: the same schedule with no host
    read."""
    state, x0_new = partial(carry, noise_t, k)
    idx = torch.nonzero(~state[10])[:, 0]
    for lo in range(0, idx.numel(), block):
        chunk = idx[lo:lo + block]
        take = chunk.repeat(-(-block // chunk.numel()))[:block]
        sub = resume(_state_map(lambda a: a[take], state), k)
        state = _state_map(lambda a, b: a.index_copy(0, take, b), state, sub)
    return extract(state, x0_new, k)


def make_mpc_step_device_compacted(prob_mpc: Problem, opts: SolverOptions,
                                   X_track, U_track,
                                   noise_model=default_noise_model,
                                   constraints_fn=None, it_cap: int = 24,
                                   block: int = 128, levels: tuple = (),
                                   warm_start: str = "shift",
                                   graphed: Optional[bool] = None,
                                   check_every: int = 1):
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
    ``(step, init_carry)`` with the signatures of :func:`make_mpc_step`;
    ``graphed`` and ``check_every`` as there (graphed, each level's batch
    has a loop graph of its own, and the gathers and scatters between
    levels are graphs too). The level batches share the window's problem,
    so its data must be shared by the lanes: per-lane or grouped dynamics
    and per-lane constraint blocks raise."""
    if prob_mpc.per_lane or getattr(prob_mpc.dynamics, "grouped", False):
        raise NotImplementedError("compaction gathers the solver state "
                                  "only, not per-lane or grouped dynamics "
                                  "stacks or per-lane constraint blocks")
    pieces = _StepPieces(prob_mpc, opts, X_track, U_track, noise_model,
                         constraints_fn, warm_start)
    return _make_step(pieces, opts, ((it_cap, block),) + tuple(levels),
                      graph.use_graphs(graphed, prob_mpc.x0.device),
                      check_every)


def _make_step(pieces: _Pieces, opts: SolverOptions, sched, graphed: bool,
               check_every: int):
    """``(step, init_carry)`` of the step that ``pieces`` describe, in the
    compaction schedule ``sched`` (``((it_cap, block), (extra_cap,
    sub_block), ...)``; empty for the plain step): a :class:`_GraphedStep`
    when ``graphed``, else the host-driven loop."""
    def init_carry(batch: int):
        return pieces.init_carry(batch, graphed, check_every)

    if graphed:
        return _GraphedStep(pieces, opts, sched, check_every), init_carry

    def flat_while(prob_k, state, cap=None):
        return _flat_while(prob_k, opts, state, cap, check_every)

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
            sub = flat_while(prob_k, sub, cum + extra)
            sub = compact(prob_k, sub, lvl + 1, cum + extra)
        else:
            sub = flat_while(prob_k, sub)
        states = _state_map(lambda a, b: a.index_copy(0, take, b), states,
                            sub)
        return flat_while(prob_k, states)

    @torch.no_grad()
    def step(carry, noise_i, k: int):
        prob_k, state, x0_new = pieces.start(carry, noise_i, k)
        if sched:
            state = flat_while(prob_k, state, sched[0][0])
            state = compact(prob_k, state, 0, sched[0][0])
        else:
            state = flat_while(prob_k, state)
        return pieces.finish(prob_k, state, x0_new)

    return step, init_carry


def make_regulator_step(prob: Problem, opts: SolverOptions,
                        it_cap: int = 0, block: int = 128,
                        levels: tuple = (), graphed: Optional[bool] = None,
                        check_every: int = 1):
    """The batched regulator MPC step (the flexible satellite's benchmark
    step): ``step(carry, noise [B, n], k) -> (carry, MPCResults)`` with
    carry = (x0, X, U, duals), every step solving ``prob`` from x0_new =
    A x0 + B U[:, 0] + d + REGULATOR_NOISE * noise, seeded with the carried
    controls, the carried duals and the carried states re-based exactly
    onto x0_new (:class:`_RegulatorPieces`; ``k`` is not read). With
    ``it_cap`` > 0 the step runs with straggler compaction in the schedule
    (``it_cap``, ``block``, ``levels``) of
    :func:`make_mpc_step_device_compacted` (``prob.x0`` is not read on
    resume: the level batches share the one problem); 0: the plain step.
    ``init_carry(batch, sol0=None)``: ``sol0``, a solution of ``prob``
    from its x0 as one scenario, or (None) a cold solve of ``prob`` as one
    scenario, copied to ``batch`` lanes. ``graphed`` and
    ``check_every`` as in :func:`make_mpc_step`."""
    pieces = _RegulatorPieces(prob, opts)
    sched = ((it_cap, block),) + tuple(levels) if it_cap else ()
    graphed = graph.use_graphs(graphed, prob.x0.device)
    step, _ = _make_step(pieces, opts, sched, graphed, check_every)

    def init_carry(batch: int, sol0=None):
        return pieces.init_carry(batch, graphed, check_every, sol0)

    return step, init_carry


def make_relinearized_step(prob: Problem, opts: SolverOptions,
                           graphed: Optional[bool] = None):
    """The warm-started solve of a controller that relinearizes its
    dynamics at every call: ``step(carry, dyn, k) -> (carry, MPCResults)``
    with carry = (x0 [B, n], U [B, N-1, m], duals), solving ``prob`` with
    the dynamics ``dyn`` (an LTVDynamics of ``prob``'s shapes) from x0,
    seeded with the shifted controls and duals (:class:`_RelinearizedPieces`;
    ``k`` is not read). The next carry holds the solution's controls and
    duals, unshifted. ``graphed`` as in :func:`make_mpc_step` (one body
    pass per replay): graphed, the start graph copies the dynamics, x0,
    the shifted controls and duals into the loop's buffers and runs the
    init rollout."""
    step, _ = _make_step(_RelinearizedPieces(prob, opts), opts, (),
                         graph.use_graphs(graphed, prob.x0.device), 1)
    return step


def stack_results(outs) -> MPCResults:
    """Per-step MPCResults stacked on a leading step axis."""
    return MPCResults(**{f.name: torch.stack([getattr(o, f.name)
                                              for o in outs])
                         for f in dataclasses.fields(MPCResults)})


def run_mpc(prob_mpc: Problem, opts: SolverOptions, X_track, U_track, noise,
            start_k: int = 0, noise_model=default_noise_model,
            constraints_fn=None) -> MPCResults:
    """Closed-loop MPC of a batch tracking (X_track, U_track): the cold
    batched solve of ``prob_mpc`` from its x0, then one
    :func:`make_mpc_step` step (``shared_k=True``; on CUDA graphs on a CUDA
    device) per row of ``noise`` [T, B, n], the t-th at window
    ``start_k + t + 1``. Returns the per-step MPCResults stacked
    ([T, B, ...])."""
    step, init_carry = make_mpc_step(prob_mpc, opts, X_track, U_track,
                                     noise_model, constraints_fn)
    carry, outs = init_carry(noise.shape[1]), []
    for t in range(noise.shape[0]):
        carry, out = step(carry, noise[t], start_k + t)
        outs.append(out)
    return stack_results(outs)


# ----------------------------------------------------------------------------
# Lockstep ALTRO-vs-ADMM oracle loops (the reference's run_MPC comparison)
# ----------------------------------------------------------------------------

@dataclass
class LockstepResults:
    err_X: torch.Tensor   # [T] inf-norm state-trajectory difference
    err_U: torch.Tensor   # [T] inf-norm control difference
    err_x0: torch.Tensor  # [T, 2] distance of each solution's x0 to true x0
    iters: torch.Tensor   # [T, 2] (altro, baseline)
    status: torch.Tensor  # [T, 2]
    viol: torch.Tensor    # [T]


def _qp_shift_warmstart(x, y, n: int, m: int, N: int, ps):
    """Shift QP primal and dual warm starts x [B, NN], y [B, M] one knot
    (the circshift warm start of random_linear_problem.jl:150-157). Rows:
    dynamics (N-1) n, x0 n, then the constraint blocks, each N p contiguous
    knot-major rows; each block shifts by its own p, its tail filled by
    repeating its last knot."""
    Bt = x.shape[0]
    x_s = torch.roll(x, -(n + m), dims=1)
    x_s = torch.cat([x_s[:, :-n], x[:, -n:]], dim=1)
    segs = [torch.roll(y[:, :(N - 1) * n], -n, dims=1),
            y[:, (N - 1) * n:N * n]]
    off = N * n
    for p in ps:
        seg = y[:, off:off + N * p].reshape(Bt, N, p)
        segs.append(torch.cat([seg[:, 1:], seg[:, -1:]], dim=1)
                    .reshape(Bt, -1))
        off += N * p
    return x_s, torch.cat(segs, dim=1)


def one_scenario(prob: Problem) -> Problem:
    """``prob`` as a batch of one (x0 [1, n]) unless x0 is batched."""
    return (prob if prob.x0.dim() == 2
            else dataclasses.replace(prob, x0=prob.x0[None]))


def lockstep_steps(pm: Problem, opts: SolverOptions, X_track, U_track,
                   noise, noise_model, constraints_fn, baseline,
                   warmup: bool = False):
    """Drive the ALTRO step (``make_mpc_step``, shared_k) of the one
    scenario ``pm`` and ``baseline(prob_k) -> (X, U, iterations, status,
    ...)`` on the same instances, one row of ``noise`` [T, n] per step.
    Yields per step (prob_k, ALTRO's MPCResults, the baseline's tuple,
    ALTRO ms, baseline ms); each time ends in a device synchronise. The
    baseline's closure owns its warm start. ``warmup``: run the step and
    the baseline once before the loop (graph capture and warm-up)."""
    sync = (torch.cuda.synchronize if pm.x0.device.type == "cuda"
            else (lambda: None))
    step, init_carry = make_mpc_step(pm, opts, X_track, U_track,
                                     noise_model, constraints_fn)
    pieces = _StepPieces(pm, opts, X_track, U_track, noise_model,
                         constraints_fn, "shift")
    carry = init_carry(1)
    if warmup:
        step(carry, noise[0][None], 0)
        baseline(pieces.prob_at(1, carry[0])[0])
    for t in range(noise.shape[0]):
        t0 = time.perf_counter()
        carry, out = step(carry, noise[t][None], t)
        sync()
        altro_ms = (time.perf_counter() - t0) * 1e3
        prob_k, _ = pieces.prob_at(t + 1, out.x0)
        t0 = time.perf_counter()
        base = baseline(prob_k)
        sync()
        yield (prob_k, out, base, altro_ms,
               (time.perf_counter() - t0) * 1e3)


def _lockstep(pm: Problem, opts: SolverOptions, X_track, U_track,
              noise, noise_model, constraints_fn, baseline):
    """Stack the per-step agreement of ``lockstep_steps``."""
    rows = []
    for _, out, (Xq, Uq, q_it, q_st), _, _ in lockstep_steps(
            pm, opts, X_track, U_track, noise, noise_model, constraints_fn,
            baseline):
        x0 = out.x0[0]
        rows.append((torch.amax(torch.abs(out.X[0] - Xq[0])),
                     torch.amax(torch.abs(out.U[0] - Uq[0])),
                     torch.stack([torch.linalg.norm(out.X[0, 0] - x0),
                                  torch.linalg.norm(Xq[0, 0] - x0)]),
                     torch.stack([out.iters[0], q_it[0]]),
                     torch.stack([out.status[0], q_st[0]]), out.viol[0]))
    return LockstepResults(*(torch.stack(list(c)) for c in zip(*rows)))


def run_mpc_lockstep(prob_mpc: Problem, opts: SolverOptions, X_track,
                     U_track, noise, qp_eps: Optional[float] = None,
                     qp_max_iter: int = 4000,
                     noise_model=default_noise_model,
                     constraints_fn=None) -> LockstepResults:
    """ALTRO and the in-framework ADMM QP in lockstep on the same MPC
    instances, one scenario, one row of ``noise`` [T, n] per step (the
    reference's run_MPC, random_linear_problem.jl:85-189). The QP side
    refreshes q and the x0 rows and warm-starts from its shifted previous
    solution; with fixed constraints the one-time KKT factor stays valid,
    time-varying ones set up anew. On a CUDA device both sides run on CUDA
    graphs."""
    from .solver import admm_qp
    from .transcribe import extract_traj, to_batch_qp

    N, n, m = prob_mpc.N, prob_mpc.n, prob_mpc.m
    qp_eps = float(opts.cost_tolerance) if qp_eps is None else qp_eps
    ps = tuple(c.p for c in prob_mpc.constraints)
    pm = one_scenario(prob_mpc)
    work0 = admm_qp.setup(to_batch_qp(pm))
    q0 = admm_qp.solve(work0, eps_abs=qp_eps, max_iter=qp_max_iter)
    warm = [q0.x, q0.y]

    def baseline(prob_k):
        qp_k = to_batch_qp(prob_k)
        work = (dataclasses.replace(work0, qp=qp_k) if constraints_fn is None
                else admm_qp.setup(qp_k, graphs=work0.graphs))
        xw, yw = _qp_shift_warmstart(warm[0], warm[1], n, m, N, ps)
        sol = admm_qp.solve(work, x0=xw, y0=yw, eps_abs=qp_eps,
                            max_iter=qp_max_iter)
        warm[:] = [sol.x, sol.y]
        return extract_traj(qp_k, sol.x) + (sol.iterations, sol.status)

    return _lockstep(pm, opts, X_track, U_track, noise, noise_model,
                     constraints_fn, baseline)


def run_mpc_lockstep_conic(prob_mpc: Problem, opts: SolverOptions, X_track,
                           U_track, noise, conic_eps: Optional[float] = None,
                           conic_max_iter: int = 20000,
                           noise_model=default_noise_model,
                           constraints_fn=None) -> LockstepResults:
    """ALTRO against the in-framework conic ADMM on SOC-constrained MPC
    problems (the ECOS/COSMO lockstep of the rocket and grasp loops,
    simple_rocket.jl:106, grasp_mpc.jl:7): the conic side starts each step
    from its previous solution, unshifted, with the factored KKT matrix
    reused (set up anew per step under time-varying constraints)."""
    from .solver import admm_conic
    from .transcribe import extract_traj, to_batch_conic

    conic_eps = (float(opts.cost_tolerance) if conic_eps is None
                 else conic_eps)
    pm = one_scenario(prob_mpc)
    work0 = admm_conic.setup(to_batch_conic(pm))
    warm = [None, None]

    def baseline(prob_k):
        cp = to_batch_conic(prob_k)
        work = (dataclasses.replace(work0, prob=cp) if constraints_fn is None
                else admm_conic.setup(cp, graphs=work0.graphs))
        sol = admm_conic.solve(work, x0=warm[0], y0=warm[1],
                               eps_abs=conic_eps, max_iter=conic_max_iter)
        warm[:] = [sol.x, sol.y]
        return extract_traj(cp, sol.x) + (sol.iterations, sol.status)

    return _lockstep(pm, opts, X_track, U_track, noise, noise_model,
                     constraints_fn, baseline)
