"""Quadruped trot MPC and its closed loop on the single-rigid-body plant
(PyTorch counterpart of ``altro_tpu/models/quadruped/controller.py`` with
the ALTRO backend).

The MPC problem: the LQR tracking objective around the desired stance, one
friction block per foot (the NONPOS pyramid or the SOC cone) and the
vertical-force bounds, relinearized per contact schedule
(:func:`build_mpc_problem`, :func:`_linearized_problem`, one solve:
:func:`mpc_solve_forces`).

Backends: "altro", and the JAX package's in-framework ADMM baselines
"admm_qp" (the OSQP role) and "admm_conic" (the ECOS role): with a
workspace from :func:`make_baseline_state` both run the knot-structured
ADMM, set up once on an all-stance linearization and refactored for every
solve (the reference's setup-once + update! pattern), zero-started with
the workspace's rho; without one, the dense oracles solve cold.

The closed loop (:func:`simulate`, :func:`simulate_host`): every MPC period
(``cfg.update_dt``, 30 ms) computes the horizon's contact schedule and foot
locations, relinearizes about it, solves warm-started from the shifted
controls and duals, then runs the period's 1 kHz control ticks
(:func:`control_tick`: the swing legs' state machine, branchless as in the
JAX package, and an RK4 step of the plant, whose stance feet stay pinned and
whose swing feet follow their splines). A :class:`PlantParams` gives the
plant another mass, inertia and foot positions than the controller's model,
and a one-shot velocity kick.

:class:`ClosedLoop` holds the loop's state in fixed buffers. On a CUDA
device (``graphed``) each period is three pieces of CUDA graphs: the
schedule and relinearization, the solve (``mpc.make_relinearized_step``:
start, loop and finish graphs) and the period's ticks, one graph replayed
with the period's start time in a device buffer; ``graphed=False`` runs the
same functions eagerly, with the host-driven solver loop. Every function of
the tick path reads its constants from device buffers built once and its
phases through ``index_select``, so nothing in it reads to or copies from
the host. Entry points run on the card unless the caller passes
``device="cpu"``.

The JAX package's C++ entrants (``native=True``: the native knot ADMM and
the native AL-iLQR) are not ported: they come with the C++-oracle slice,
and asking for them raises.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ...constraints import (DualState, bound_constraint, friction_cone,
                            linearized_friction)
from ...costs import lqr_objective
from ...dynamics import LTVDynamics
from ...mpc import MPCResults, make_relinearized_step, shift_fill
from ...problem import Problem
from ...solver import admm_conic, admm_qp, altro, graph, knot_admm
from ...solver.graph import Replayable, clone_tree, copy_into
from ...solver.options import SolverOptions
from ...transcribe import extract_traj, to_batch_conic, to_batch_qp
from ...utils.profiling import timed
from . import kinematics, planner, swing
from .config import MPCConfig, woofer as _w
from .gait import GAITS, Gait, take
from .srb import linearize_horizon, mrp_rotation, rk4_plant

SPRUNG_MASS = _w.inertial.sprung_mass
DT_SIM = 0.001


def build_mpc_problem(cfg: MPCConfig, dtype=torch.float64, device=None):
    """The MPC problem's static parts: the LQR objective tracking x_des,
    the per-foot friction blocks and the vertical-force bound block; the
    dynamics stacks are placeholders, relinearized for every solve.
    Returns (problem, x_des [12])."""
    N, n, m = cfg.N, 12, 12
    kw = dict(dtype=dtype, device=device)
    Q = torch.diag(torch.tensor(cfg.q, **kw))
    R = torch.diag(torch.tensor(cfg.r, **kw))
    x_des = torch.tensor(
        [0.0, 0.0, cfg.stance_height, 0.0, 0.0, cfg.yaw_angle,
         cfg.xy_vel[0], cfg.xy_vel[1], 0.0, 0.0, 0.0, cfg.omega_z], **kw)
    cost = lqr_objective(Q, R, Q, x_des, N, dt=cfg.dynamics_discretization)

    friction = linearized_friction if cfg.linearized_friction else \
        friction_cone
    cons = [friction(N, n, m, cfg.mu, (3 * leg, 3 * leg + 1, 3 * leg + 2),
                     **kw) for leg in range(4)]
    u_min = np.full(m, -np.inf)
    u_min[2::3] = cfg.min_vert_force
    u_max = np.full(m, np.inf)
    u_max[2::3] = cfg.max_vert_force
    cons.append(bound_constraint(N, n, m, u_min=u_min, u_max=u_max, **kw))

    dyn = LTVDynamics(A=torch.eye(n, **kw).expand(N - 1, n, n).contiguous(),
                      B=torch.zeros((N - 1, n, m), **kw),
                      d=torch.zeros((N - 1, n), **kw))
    return Problem(dynamics=dyn, cost=cost, constraints=tuple(cons),
                   x0=x_des), x_des


def _linearized_problem(prob: Problem, x_curr, x_ref, contacts, foot_locs,
                        dt_mpc) -> Problem:
    """The problem instance of one contact schedule: dynamics linearized
    about x_ref and the gravity-distributing stance forces (m g / stance
    feet, vertical, per stance foot), x0 = x_curr."""
    nst = torch.clamp(torch.sum(contacts, dim=1, keepdim=True), min=1.0)
    fz_ref = SPRUNG_MASS * 9.81 / nst * contacts                 # [N, 4]
    u_ref = torch.zeros((prob.N, 12), dtype=x_curr.dtype,
                        device=x_curr.device)
    u_ref[:, 2::3] = fz_ref
    dyn = linearize_horizon(x_ref, u_ref, foot_locs, contacts, dt_mpc)
    return dataclasses.replace(prob, dynamics=dyn, x0=x_curr)


BACKENDS = ("altro", "admm_qp", "admm_conic")
NATIVE_SLICE = ("the native C++ entrants come with the port's C++-oracle "
                "slice, which is not ported yet")


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")


def mpc_solve_forces(backend: str, prob: Problem, opts: SolverOptions,
                     x_curr, x_ref, contacts, foot_locs, dt_mpc, U_prev,
                     duals, baseline=None):
    """One MPC solve, batched at B=1: relinearize about the horizon's
    contact schedule (contacts [N, 4], foot_locs [N, 4, 3], x_ref [N, 12]),
    solve from x_curr [1, 12] and return (forces [1, 12], U [1, N-1, 12],
    duals, iterations [1], status [1], baseline).

    "altro" warm-starts from the shifted U_prev [1, N-1, 12] and shifted
    duals ([1, ...]). The ADMM backends return the duals as given: with
    ``baseline`` (a ``knot_admm.KnotADMMWork`` from
    :func:`make_baseline_state`) they refactor it for this instance and
    solve from zero; without it they set up and solve the dense oracle
    (``admm_qp`` or ``admm_conic``) cold. (A shifted primal and dual warm
    start measured worse here in the JAX package: each MPC period rolls a
    stance transition through the horizon, flipping equality rows at
    rho * 1e3, and the adaptive-rho transient that causes costs more than
    the zero start.)"""
    _check_backend(backend)
    prob_k = _linearized_problem(prob, x_curr, x_ref, contacts, foot_locs,
                                 dt_mpc)
    if backend == "altro":
        sol = altro.solve(prob_k, opts, U0=shift_fill(U_prev),
                          duals=tuple(d.shift() for d in duals))
        return (sol.U[:, 0], sol.U, sol.duals, sol.stats.iterations,
                sol.stats.status, baseline)
    eps = float(opts.cost_tolerance)
    if baseline is not None:
        ksol = knot_admm.solve(knot_admm.refactor(
            baseline, knot_admm.to_knot_qp(prob_k)), eps_abs=eps)
        return (ksol.U[:, 0], ksol.U, duals, ksol.iterations, ksol.status,
                baseline)
    if backend == "admm_qp":
        prog = to_batch_qp(prob_k)
        sol = admm_qp.solve(admm_qp.setup(prog), eps_abs=eps)
    else:
        prog = to_batch_conic(prob_k)
        sol = admm_conic.solve(admm_conic.setup(prog), eps_abs=eps)
    _, U = extract_traj(prog, sol.x)
    return U[:, 0], U, duals, sol.iterations, sol.status, None


def make_baseline_state(backend: str, prob: Problem, cfg: MPCConfig, x_des,
                        dtype=torch.float64, native: bool = False):
    """The ADMM backends' setup-once knot-ADMM workspace (rho = 0.1), from
    the all-stance linearization at x_des on the nominal feet (the
    reference's OSQP setup phase, OSQPParams.jl:60-125; the scalings are a
    preconditioner, so reusing them across relinearizations is safe); None
    for "altro". ``native=True`` asks for the JAX package's C++ knot ADMM,
    which is not ported: it raises NotImplementedError."""
    _check_backend(backend)
    if backend == "altro":
        return None
    if native:
        raise NotImplementedError(NATIVE_SLICE)
    N = cfg.N
    kw = dict(dtype=dtype, device=x_des.device)
    feet = x_des[0:3][None, :] + planner.nominal_foot_locations(**kw)
    feet[:, 2] = _w.geometry.foot_radius
    u_ref = torch.zeros((N, 12), **kw)
    u_ref[:, 2::3] = SPRUNG_MASS * 9.81 / 4.0
    dyn0 = linearize_horizon(x_des.expand(N, 12), u_ref,
                             feet.expand(N, 4, 3), torch.ones((N, 4), **kw),
                             cfg.dynamics_discretization)
    prob0 = dataclasses.replace(prob, dynamics=dyn0, x0=x_des[None])
    return knot_admm.setup(knot_admm.to_knot_qp(prob0), rho=0.1)


@dataclass
class PlantParams:
    """The plant's parameters where they differ from the controller's
    model (the controller always linearizes the nominal model): scales of
    the mass and the inertia (0-d), an offset [3] of the world foot
    positions the plant's force model sees, and a one-shot body velocity
    impulse [3] applied on the tick that contains ``kick_t`` seconds."""

    mass_scale: torch.Tensor
    inertia_scale: torch.Tensor
    foot_offset: torch.Tensor
    kick_impulse: torch.Tensor
    kick_t: torch.Tensor

    @staticmethod
    def nominal(dtype=torch.float64, device="cuda") -> "PlantParams":
        kw = dict(dtype=dtype, device=device)
        return PlantParams(mass_scale=torch.ones((), **kw),
                           inertia_scale=torch.ones((), **kw),
                           foot_offset=torch.zeros(3, **kw),
                           kick_impulse=torch.zeros(3, **kw),
                           kick_t=torch.full((), -1.0, **kw))


@dataclass
class SimState:
    x: torch.Tensor                 # [12] SRB state
    feet_w: torch.Tensor            # [4, 3] world foot positions
    prev_feet_b: torch.Tensor       # [4, 3] body-frame feet (velocity)
    swing_coeffs: torch.Tensor      # [4, 12] spline coefficients
    planner_foot_loc: torch.Tensor  # [4, 3]
    next_foot_loc: torch.Tensor     # [4, 3]
    swing_tf: torch.Tensor          # [4] spline end times
    last_replan_t: torch.Tensor     # 0-d
    prev_phase: torch.Tensor        # 0-d int64
    forces: torch.Tensor            # [12] current MPC forces
    U_prev: torch.Tensor            # [N-1, 12]
    duals: Tuple[DualState, ...]    # unbatched, [N, p] and [N]


def initial_state(prob: Problem, x_des, opts: SolverOptions,
                  dtype=torch.float64) -> SimState:
    """Standing at x_des on the nominal feet with the stance forces
    m g / 4 on every foot, fresh duals; on x_des's device."""
    kw = dict(dtype=dtype, device=x_des.device)
    feet_w = x_des[0:3][None, :] + planner.nominal_foot_locations(**kw)
    feet_w[:, 2] = _w.geometry.foot_radius
    feet_b = feet_w - x_des[0:3][None, :]
    u0 = torch.zeros(12, **kw)
    u0[2::3] = SPRUNG_MASS * 9.81 / 4
    return SimState(
        x=x_des.clone(), feet_w=feet_w, prev_feet_b=feet_b,
        swing_coeffs=torch.zeros((4, 12), **kw),
        planner_foot_loc=feet_w.clone(), next_foot_loc=feet_w.clone(),
        swing_tf=torch.zeros(4, **kw),
        last_replan_t=torch.zeros((), **kw),
        prev_phase=torch.zeros((), dtype=torch.int64, device=x_des.device),
        forces=u0, U_prev=u0.expand(prob.N - 1, 12).clone(),
        duals=prob.init_duals(opts.penalty_initial))


def _advance(state: SimState, t, gait: Gait, cfg: MPCConfig,
             plant: Optional[PlantParams]):
    """One tick's new state, and what its torques need: (state, (rot,
    coeffs, feet_b, feet_vel_b, active)). Branchless: every switch of the
    state machine is a ``torch.where``."""
    x = state.x
    rot = mrp_rotation(x[3:6])
    feet_b = (state.feet_w - x[0:3]) @ rot
    feet_vel_b = (feet_b - state.prev_feet_b) / DT_SIM

    cur_phase = gait.phase_at(t)
    cur_phase_time = gait.phase_time(t, cur_phase)
    active = gait.contacts(cur_phase)
    prev_active = gait.contacts(state.prev_phase)

    # stance -> swing transition: plan the footstep and the whole spline;
    # a swing foot replans its placement (not its height) every
    # footstep_replan seconds
    released = (prev_active == 1) & (active == 0)
    do_replan = (t - state.last_replan_t) > cfg.footstep_replan
    replanning = (active == 0) & do_replan

    planned = planner.footstep_locations(x, rot, cur_phase, gait)
    upd = released | replanning
    next_fl = torch.where(upd[:, None], planned, state.next_foot_loc)
    planner_fl = torch.where(upd[:, None], planned, state.planner_foot_loc)

    phase_len = take(gait.phase_times, cur_phase)
    tf_release = t + phase_len
    tf_replan = (t - cur_phase_time) + phase_len
    swing_tf = torch.where(released, tf_release,
                           torch.where(replanning, tf_replan,
                                       state.swing_tf))

    full = swing.foot_trajectory_coeffs(x, rot, feet_b, feet_vel_b, next_fl,
                                        t, swing_tf, cfg.step_height)
    xy = torch.cat([full[:, :8], state.swing_coeffs[:, 8:12]], -1)
    coeffs = torch.where(released[:, None], full,
                         torch.where(replanning[:, None], xy,
                                     state.swing_coeffs))

    # plant step: stance feet pinned, swing feet on their splines
    if plant is None:
        x_new = rk4_plant(x, state.forces, state.feet_w, active, DT_SIM)
    else:
        x_new = rk4_plant(x, state.forces, state.feet_w + plant.foot_offset,
                          active, DT_SIM, plant.mass_scale,
                          plant.inertia_scale)
        kicked = (t <= plant.kick_t) & (plant.kick_t < t + DT_SIM)
        x_new = torch.cat([x_new[:6], x_new[6:9] + torch.where(
            kicked, plant.kick_impulse, 0.0), x_new[9:]])
    spline_pos, _ = swing.swing_foot_target(coeffs, t + DT_SIM)
    feet_w_new = torch.where(active[:, None] == 1, state.feet_w, spline_pos)

    new = dataclasses.replace(
        state, x=x_new, feet_w=feet_w_new, prev_feet_b=feet_b,
        swing_coeffs=coeffs, planner_foot_loc=planner_fl,
        next_foot_loc=next_fl, swing_tf=swing_tf,
        last_replan_t=torch.where(upd.any(), t, state.last_replan_t),
        prev_phase=cur_phase)
    return new, (rot, coeffs, feet_b, feet_vel_b, active)


def control_tick(state: SimState, t, gait: Gait, cfg: MPCConfig, x_des,
                 plant: Optional[PlantParams] = None):
    """One 1 kHz tick at time t (0-d tensor): the swing state machine and
    the plant's step. Returns (the new state, joint torques [12]): J^T of
    the negated MPC force on stance legs and of the swing PD force on swing
    legs (recorded, not applied: the plant's legs are massless)."""
    del x_des
    new, (rot, coeffs, feet_b, feet_vel_b, active) = _advance(
        state, t, gait, cfg, plant)
    pd = swing.swing_pd_force(state.x, rot, coeffs, feet_b, feet_vel_b, t,
                              omega=cfg.swing_omega, zeta=cfg.swing_zeta)
    alpha = kinematics.inverse_kinematics_all(feet_b.reshape(-1))
    tau_mpc = kinematics.force_to_torque(-state.forces, alpha)
    tau_swing = kinematics.force_to_torque(pd.reshape(-1), alpha)
    a12 = active[:, None].expand(4, 3).reshape(12)
    return new, a12 * tau_mpc + (1 - a12) * tau_swing


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the closed loop was asked to run on a CUDA "
                           "device, and none is available")
    return dev


class ClosedLoop:
    """The closed loop's state and its three pieces per MPC period, over
    fixed buffers: :meth:`prep` (the horizon's schedule and the
    relinearized dynamics at the period's start time), :meth:`solve` (the
    warm-started MPC solve), :meth:`adopt` (the solution into the state) and
    :meth:`ticks` (the period's control ticks). ``graphed`` (None: on a
    CUDA device): prep and ticks are replayed CUDA graphs, the solve a
    ``mpc.make_relinearized_step`` on graphs (an ADMM backend's: the knot
    refactor, then the knot ADMM's chunks on graphs); on the CPU the same
    functions run over the same buffers without capture. Else everything
    runs eagerly and the solve takes the host-driven loop.

    The ticks read the TRUE plant ``plant`` (None: the nominal model);
    the MPC always linearizes the nominal model."""

    def __init__(self, cfg: MPCConfig, opts: SolverOptions,
                 dtype=torch.float64, device="cuda",
                 plant: Optional[PlantParams] = None,
                 graphed: Optional[bool] = None, backend: str = "altro"):
        _check_backend(backend)
        dev = _device(device)
        self.cfg, self.opts, self.plant, self.device = cfg, opts, plant, dev
        self.gait = GAITS[cfg.gait_type](cfg.stance_time,
                                         cfg.swing_time).to(dev)
        self.prob, self.x_des = build_mpc_problem(cfg, dtype, dev)
        self.x_ref = self.x_des.expand(cfg.N, 12)
        self.ticks_per_mpc = int(round(cfg.update_dt / DT_SIM))
        self.state = initial_state(self.prob, self.x_des, opts, dtype)
        self.t = torch.zeros((), dtype=dtype, device=dev)
        self.graphed = graph.use_graphs(graphed, dev)
        self.baseline = make_baseline_state(backend, self.prob, cfg,
                                            self.x_des, dtype)
        self.step = None if self.baseline is not None else \
            make_relinearized_step(
                dataclasses.replace(self.prob, x0=self.x_des[None]), opts,
                graphed=self.graphed)
        self.admm_chunks = 0
        self.capture_s = 0.0
        self._prep_g = self._ticks_g = None
        if self.graphed:
            t0 = time.perf_counter()
            saved = clone_tree(self.state)
            self._prep_g = Replayable(self._prep, dev)
            self._ticks_g = Replayable(self._ticks, dev)
            copy_into(self.state, saved, "closed-loop state")
            self.capture_s = time.perf_counter() - t0

    def _prep(self):
        s, cfg = self.state, self.cfg
        contacts, foot_locs, planner_fl = planner.foot_history(
            self.t, self.x_ref, s.feet_w, s.planner_foot_loc, self.gait,
            self.x_des, cfg.N, cfg.dynamics_discretization)
        prob_k = _linearized_problem(self.prob, s.x, self.x_ref, contacts,
                                     foot_locs, cfg.dynamics_discretization)
        return prob_k.dynamics, planner_fl

    def _ticks(self):
        s = self.state
        for j in range(self.ticks_per_mpc):
            s, _ = _advance(s, self.t + float(j) * DT_SIM, self.gait,
                            self.cfg, self.plant)
        copy_into(self.state, s, "closed-loop state")

    def set_time(self, k: int) -> None:
        """The start time of period k into the time buffer."""
        self.t.fill_(k * self.cfg.update_dt)

    def prep(self):
        """(relinearized dynamics, the planner's foot locations) of the
        current state at the buffer's time (graph outputs when graphed:
        the next prep overwrites them)."""
        if self._prep_g is None:
            return self._prep()
        self._prep_g.replay()
        return self._prep_g.out

    def solve(self, dyn):
        """The period's solve from the state: (U [1, N-1, 12], duals
        [1, ...], MPCResults). An ADMM backend's duals are the state's,
        and its MPCResults carry no violation (NaN)."""
        s = self.state
        duals = tuple(DualState(lam=d.lam[None], rho=d.rho[None])
                      for d in s.duals)
        if self.baseline is None:
            (_, U, duals), out = self.step((s.x[None], s.U_prev[None],
                                            duals), dyn, 0)
            return U, duals, out
        prob_k = dataclasses.replace(self.prob, dynamics=dyn, x0=s.x[None])
        ksol = knot_admm.solve(
            knot_admm.refactor(self.baseline, knot_admm.to_knot_qp(prob_k)),
            eps_abs=float(self.opts.cost_tolerance), graphed=self.graphed)
        self.admm_chunks += ksol.chunks
        out = MPCResults(X=ksol.X, U=ksol.U, iters=ksol.iterations,
                         status=ksol.status,
                         viol=torch.full(ksol.status.shape, torch.nan,
                                         dtype=ksol.X.dtype,
                                         device=ksol.X.device),
                         x0=s.x[None])
        return ksol.U, duals, out

    def adopt(self, U, duals=None, planner_fl=None) -> None:
        """The solution into the state: forces U[0, 0], U_prev, and (when
        given) the duals and the planner's foot locations."""
        s = self.state
        s.forces.copy_(U[0, 0])
        s.U_prev.copy_(U[0])
        if duals is not None:
            for dst, src in zip(s.duals, duals):
                dst.lam.copy_(src.lam[0])
                dst.rho.copy_(src.rho[0])
        if planner_fl is not None:
            s.planner_foot_loc.copy_(planner_fl)

    def ticks(self) -> None:
        """The period's control ticks, from the buffer's time."""
        if self._ticks_g is None:
            self._ticks()
        else:
            self._ticks_g.replay()

    def period(self, k: int):
        """One whole period k: returns (forces [12], MPCResults)."""
        self.set_time(k)
        dyn, planner_fl = self.prep()
        U, duals, out = self.solve(dyn)
        self.adopt(U, duals, planner_fl)
        forces = self.state.forces.clone()
        self.ticks()
        return forces, out


def _records(xs, forces, outs) -> dict:
    return dict(x=torch.stack(xs), forces=torch.stack(forces),
                iters=torch.cat([o.iters for o in outs]),
                status=torch.cat([o.status for o in outs]))


def simulate(cfg: MPCConfig, opts: SolverOptions, tf: float = 2.0,
             backend: str = "altro", dtype=torch.float64,
             plant: Optional[PlantParams] = None, device="cuda",
             graphed: Optional[bool] = None) -> dict:
    """The closed-loop trot for ``tf`` seconds (round(tf / update_dt)
    periods): returns per-period records, x [P, 12] after the period's
    ticks, forces [P, 12] applied during them, the solves' iterations [P]
    and status [P]. ``plant``: the true plant's parameters (the MPC keeps
    the nominal model). ``backend`` and ``graphed`` as in
    :class:`ClosedLoop`."""
    loop = ClosedLoop(cfg, opts, dtype, device, plant, graphed, backend)
    xs, forces, outs = [], [], []
    for k in range(int(round(tf / cfg.update_dt))):
        f, out = loop.period(k)
        xs.append(loop.state.x.clone())
        forces.append(f)
        outs.append(out)
    return _records(xs, forces, outs)


def simulate_host(cfg: MPCConfig, opts: SolverOptions, tf: float = 2.0,
                  backend: str = "altro", dtype=torch.float64,
                  plant: Optional[PlantParams] = None, probe=None,
                  device="cuda", graphed: Optional[bool] = None,
                  native: bool = False) -> dict:
    """The closed loop of :func:`simulate`, timed per period in three
    sections, each fenced by a device synchronise: ``prep_ms`` (the
    horizon's schedule and the relinearization), ``mpc_ms`` (the solve
    alone: the reference's table records only the solver's own time) and
    ``tick_ms`` (the period's control ticks). The build, the graphs'
    capture (``capture_s``) and one warm-up period at t = 0 run before the
    timed loop; as in the JAX package, the loop then starts from the
    initial state with the warm-up solve's duals. ``probe(k, prob_k, U)``,
    if given, runs after each solve outside the timed sections, with the
    period's linearized problem and the solution's controls [1, N-1, 12].
    Returns :func:`simulate`'s records plus the three lists of ms, the
    seconds of the set-up before the timed loop (``setup_s``), of which
    capturing graphs (``capture_s``), the ALTRO solver-loop graph's
    replays (``loop_replays``, the warm-up's included; 0 eager or with an
    ADMM backend) and an ADMM backend's chunks (``admm_chunks``, the
    warm-up's included: graph replays, or eager chunks). ``native=True``
    asks for the JAX package's C++ entrants, which are not ported: it
    raises NotImplementedError."""
    _check_backend(backend)
    if native:
        raise NotImplementedError(NATIVE_SLICE)
    dev = _device(device)
    sec = {}
    with timed("setup", sec, dev):
        loop = ClosedLoop(cfg, opts, dtype, dev, plant, graphed, backend)
        saved = clone_tree(loop.state)
        loop.set_time(0)
        U, duals, _ = loop.solve(loop.prep()[0])
        loop.ticks()
        copy_into(loop.state, saved, "closed-loop state")
        loop.adopt(saved.U_prev[None], duals)

    xs, forces, outs = [], [], []
    mpc_ms, prep_ms, tick_ms = [], [], []
    for k in range(int(round(tf / cfg.update_dt))):
        loop.set_time(k)
        with timed("prep", sec, dev):
            dyn, planner_fl = loop.prep()
        with timed("solve", sec, dev):
            U, duals, out = loop.solve(dyn)
        loop.adopt(U, duals, planner_fl)
        if probe is not None:
            probe(k, dataclasses.replace(
                loop.prob, dynamics=clone_tree(dyn),
                x0=loop.state.x[None].clone()), U)
        forces.append(loop.state.forces.clone())
        with timed("ticks", sec, dev):
            loop.ticks()
        prep_ms.append(sec["prep"] * 1e3)
        mpc_ms.append(sec["solve"] * 1e3)
        tick_ms.append(sec["ticks"] * 1e3)
        xs.append(loop.state.x.clone())
        outs.append(out)
    rec = _records(xs, forces, outs)
    admm_capture_s = sum(g.capture_s for g in loop.baseline.graphs.values()
                         ) if loop.baseline is not None else 0.0
    rec.update(mpc_ms=mpc_ms, prep_ms=prep_ms, tick_ms=tick_ms,
               setup_s=sec["setup"],
               loop_replays=getattr(loop.step, "loop_replays", 0),
               admm_chunks=loop.admm_chunks,
               capture_s=(loop.capture_s + admm_capture_s
                          + getattr(loop.step, "capture_s", 0.0)))
    return rec
