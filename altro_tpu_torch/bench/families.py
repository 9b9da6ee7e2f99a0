"""Batched benchmarks of the port's remaining families (the counterpart of
``altro_tpu/bench/batched_families.py``): the quadruped trot MPC in its flat
per-lane layout (``quadruped_setup``, ``quadruped_batched``) and the
flexible-satellite regulator MPC (``flexsat_setup``, ``flexsat_batched``).

Flexsat: the N=80 regulator (n=12, m=3, one NONPOS block of 6 control-bound
rows; ``models/flexible_satellite.py``), one cold solve from its x0 copied
to B scenarios, then T regulator steps (``mpc.make_regulator_step``: x0
propagated through the first control plus 2e-4 process noise, the same
problem re-solved from the carried controls, duals and exactly re-based
states), in float32 with the benchmark's options (cost and constraint
tolerance 1e-4, penalty 1e3 x 100, the exact-step stop at 1e-3, an L=5
ladder plus the alpha=0 rung, the fused ladder + merit) and the straggler
compaction schedule the JAX package ships (cap 8, block 256, one level
(8, 128)). On a CUDA device every solver iteration runs the fused expansion
+ Riccati kernel (ops/riccati_fused.py) and the fused ladder + AL-merit
kernel (ops/rollout_al.py); the cold solve runs the ladder-rollout kernel
once for its init rollout, and the warm solves none.

Quadruped: the Woofer trot MPC at N=15 (n = m = 12; four friction blocks
and one vertical-force bound block), linearized about 8 contact schedules
sampled across one trot cycle, B/8 lanes each, every lane with its own
dynamics stack and an initial state x_des + noise (2 cm / 0.05 rad scale).
Every round solves the whole batch cold from the gravity-distributing stance
forces, with a fresh x0 draw. On a CUDA device every solver iteration runs
the AL expansion in PyTorch, the Riccati kernel (ops/riccati.py) and the
ladder-rollout kernel (ops/rollout.py) with the line-search merit in
PyTorch; every solve runs the ladder-rollout kernel once more for its init
rollout. With ``nonlinear`` (modes ``qp_nl`` and ``socp_nl``) the same
instances keep the RK4 SRB model itself (``srb.nonlinear_dynamics`` over
each lane's contact schedule) in place of its Euler linearization: every
iteration relinearizes it per lane and knot (``torch.func.jacfwd``), runs
the Riccati kernel on the per-lane stacks and rolls out the ladder through
the model in PyTorch; no other kernel runs.

Run as a script on a CUDA machine (B=1024, f32):

    python -m altro_tpu_torch.bench.families [qp] [socp] [qp_nl] [socp_nl]
        [flexsat] [--flexsat-compact-cap C] [--eager] [--check-every K]

It prints one JSON line per mode (default: qp and socp) with the JAX
package's row keys: for the quadruped label, batch, rounds, solves_per_s,
success_rate, max_viol, mean_iters, iters_max, iters_p99, wall_s plus the
device, per-round ms, solver-loop passes, graph replays, capture seconds
and kernel launches; for flexsat label, batch, steps, solves_per_s,
success_rate, max_viol, mean_iters, iters_p99, wall_s plus step ms p50 and
p99, the steps' mean lane-max iterations, loop passes and graph replays per
step, the cold solve, capture seconds and kernel launches. Every quadruped
round replays one ``solver.graph.GraphedSolve`` and every flexsat step its
graphs (K body passes per loop replay, 1 by default, the fastest of 1, 2, 4
and 8 on the card); ``--eager`` runs the host-driven loop instead.
``--flexsat-compact-cap``: -1 (default) the shipped schedule, 0 the plain
step, C > 0 cap C, block 128 and no level (as the JAX benchmark reads it).
Knobs: BENCH_BATCH (1024), BENCH_ROUNDS (10), BENCH_STEPS (45, flexsat).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..convert import tree_to
from ..dynamics import LTVDynamics
from ..models import flexible_satellite as fs
from ..models.quadruped import config, controller, planner, srb
from ..models.quadruped.gait import GAITS
from ..mpc import make_regulator_step
from ..ops import riccati, riccati_fused, rollout, rollout_al
from ..problem import Problem
from ..solver import altro, graph
from ..solver.options import SolverOptions
from .flagship import power_limit

N_SCHED = 8
OPTS = dict(cost_tolerance=1e-4, constraint_tolerance=1e-4,
            penalty_initial=10.0, penalty_scaling=100.0)
X0_SCALE = (.02, .02, .02, .05, .05, .05, .02, .02, .02, .05, .05, .05)


@dataclass
class QuadrupedSetup:
    prob: Problem            # per-lane dynamics [B, N-1, ...]; x0 = x_des
    U0: torch.Tensor         # [B, N-1, 12] stance forces m g / 4
    opts: SolverOptions
    x_des: torch.Tensor      # [12]
    draw_x0: Callable        # () -> float64 [B, 12] on the CPU
    # the states to start from, [B, N, 12], or None: the init rollout of U0
    X0: Optional[torch.Tensor] = None


def quadruped_setup(B: int, linearized_friction: bool = True,
                    dtype=torch.float32, device="cuda",
                    nonlinear: bool = False) -> QuadrupedSetup:
    """The flat batched quadruped instance: 8 contact schedules at
    t = i * cycle / 8 (i < 8), each linearized about x_des and repeated to
    B/8 lanes, the stance-force warm start, the benchmark's options and the
    seeded x0 sampler (``numpy.random.default_rng(3)``; each call draws the
    next batch). ``nonlinear``: the lanes keep the RK4 SRB model over their
    schedule (per-lane params foot_locs [B, N, 4, 3], contacts [B, N, 4])
    in place of its linearization, and start from the states about which
    the linearized instance is built (``X0``: x_des at every knot; the
    solver puts x0 at knot 0). The model's own open-loop rollout of the
    stance forces is no start: from an x0 off x_des their torques spin the
    body within the 0.42 s horizon, and on some lanes the attitude's MRP
    overflows to NaN before the last knot (the JAX package's solve fails
    those lanes alike).

    Everything is built once in float64 on the CPU and then cast: t lands
    exactly on gait phase boundaries, where float32 and float64 round to
    different contact schedules, so a float32 run and a float64 run solve
    the same instances only when they share one float64 build.
    """
    if B % N_SCHED:
        raise ValueError(f"B must be a multiple of {N_SCHED}, got {B}")
    f64 = torch.float64
    cfg = config.MPCConfig(linearized_friction=linearized_friction)
    gait = GAITS[cfg.gait_type](cfg.stance_time, cfg.swing_time)
    prob, x_des = controller.build_mpc_problem(cfg, f64)
    N, dt = cfg.N, cfg.dynamics_discretization

    cycle = cfg.stance_time + cfg.swing_time
    feet0 = x_des[0:3][None, :] + planner.nominal_foot_locations()
    feet0[:, 2] = config.woofer.geometry.foot_radius
    x_ref = x_des.expand(N, 12)
    dyns, scheds = [], []
    for i in range(N_SCHED):
        t = torch.tensor(i * cycle / N_SCHED, dtype=f64)
        contacts, foot_locs, _ = planner.foot_history(
            t, x_ref, feet0, feet0, gait, x_des, N, dt)
        scheds.append((foot_locs, contacts))
        if not nonlinear:
            dyns.append(controller._linearized_problem(
                prob, x_des, x_ref, contacts, foot_locs, dt).dynamics)
    reps = B // N_SCHED
    if nonlinear:
        dyn = srb.nonlinear_dynamics(
            *(torch.stack(leaf).repeat_interleave(reps, dim=0)
              for leaf in zip(*scheds)), dt)
    else:
        dyn = LTVDynamics(**{k: torch.stack([getattr(d, k) for d in dyns])
                             .repeat_interleave(reps, dim=0)
                             for k in ("A", "B", "d")})
    prob_b = dataclasses.replace(prob, dynamics=dyn,
                                 x0=x_des.expand(B, 12).contiguous())

    U0 = torch.zeros((B, N - 1, 12), dtype=f64)
    U0[:, :, 2::3] = controller.SPRUNG_MASS * 9.81 / 4.0

    rng = np.random.default_rng(3)
    scale = torch.tensor(X0_SCALE, dtype=f64)

    def draw_x0():
        return x_des[None, :] + torch.as_tensor(
            rng.standard_normal((B, 12))) * scale

    su = QuadrupedSetup(prob=prob_b, U0=U0, opts=SolverOptions(**OPTS),
                        x_des=x_des, draw_x0=draw_x0,
                        X0=(x_des.expand(B, N, 12).contiguous() if nonlinear
                            else None))
    return tree_to(su, device, dtype)


def _launches() -> dict:
    return {"batched_ls_rollout": rollout.launch_count,
            "fused_expand_backward": riccati_fused.launch_count,
            "batched_ls_rollout_al": rollout_al.launch_count,
            "batched_riccati": riccati.launch_count}


def quadruped_batched(B: int = 1024, rounds: int = 10,
                      linearized_friction: bool = True, device="cuda",
                      graphed: Optional[bool] = None,
                      check_every: int = 1, nonlinear: bool = False,
                      dtype=torch.float32) -> dict:
    """Per-solve throughput of the flat batched quadruped MPC in float32
    (the JAX benchmark's precision): one warm-up solve (which captures the
    solve's graphs: ``capture_s``), then ``rounds`` timed batch solves, each
    cold from the stance forces with a fresh x0 draw, each synchronised and
    timed (``round_ms_p50``/``p99``). ``graphed`` (None: on a CUDA device):
    every solve replays one ``solver.graph.GraphedSolve`` with
    ``check_every`` body passes per loop replay; else the host-driven loop.
    ``loop_iterations`` counts the solver-loop body passes of every solve
    that ran, the warm-up included (``solver.altro.pass_count``, the frozen
    passes of a replay included), ``lane_max_iters`` the sum of each
    solve's largest lane iteration count and ``graph_replays`` the loop
    graph's replays; ``solves`` counts the solves; ``launches`` are the
    kernel launches of this call. ``nonlinear``: the RK4 SRB model in place
    of its linearization (:func:`quadruped_setup`); ``dtype``: float64 for
    the f64 rows."""
    dev = torch.device(device)
    graphed = graph.use_graphs(graphed, dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    su = quadruped_setup(B, linearized_friction, dtype, dev, nonlinear)
    before, passes0 = _launches(), altro.pass_count
    gs = (graph.GraphedSolve(su.prob, su.opts, check_every=check_every,
                             states=su.X0 is not None)
          if graphed else None)

    def solve_batch():
        x0 = su.draw_x0().to(device=dev, dtype=dtype)
        if gs is not None:
            return gs(x0, su.U0, su.X0).stats
        sol = altro.solve(dataclasses.replace(su.prob, x0=x0), su.opts,
                          U0=su.U0, X0=su.X0)
        return sol.stats

    st = solve_batch()                                     # warm-up
    lane_max = [int(st.iterations.max())]
    stats, round_ms = [], []
    sync()
    t0 = time.perf_counter()
    for _ in range(rounds):
        ts = time.perf_counter()
        stats.append(solve_batch())
        sync()
        round_ms.append((time.perf_counter() - ts) * 1e3)
    wall = time.perf_counter() - t0
    status = torch.cat([s.status for s in stats]).cpu().numpy()
    viol = torch.cat([s.viol for s in stats]).double().cpu().numpy()
    iters = torch.stack([s.iterations for s in stats]).cpu().numpy()
    lane_max += [int(i.max()) for i in iters]
    mode = (("qp" if linearized_friction else "socp")
            + ("_nonlinear" if nonlinear else ""))
    after = _launches()
    p50, p99 = np.percentile(round_ms, [50, 99])
    return dict(label=f"quadruped_trot_mpc_N15_{mode}", batch=B,
                rounds=rounds, solves_per_s=B * rounds / wall,
                success_rate=float(status.mean()),
                max_viol=float(np.nanmax(viol)),
                mean_iters=float(iters.mean()), iters_max=int(iters.max()),
                iters_p99=float(np.percentile(iters, 99)), wall_s=wall,
                round_ms_p50=float(p50), round_ms_p99=float(p99),
                device=str(dev), graphed=graphed, check_every=check_every,
                capture_s=gs.capture_s if gs is not None else 0.0,
                loop_iterations=altro.pass_count - passes0,
                lane_max_iters=sum(lane_max),
                graph_replays=gs.replays if gs is not None else 0,
                solves=len(lane_max),
                launches={k: after[k] - before[k] for k in after})


# the flexible satellite's warm solves (batched_families.py:69-72): the
# flagship's penalty schedule, the exact-step stop, an L=5 ladder plus the
# alpha=0 rung, and the fused ladder + merit on its single block
FLEXSAT_OPTS = dict(cost_tolerance=1e-4, constraint_tolerance=1e-4,
                    penalty_initial=1e3, penalty_scaling=100.0,
                    early_exact_tol=1e-3, iterations_linesearch=5,
                    ls_fused="on")
# the compaction schedule the JAX package ships: (it_cap, block, levels)
FLEXSAT_SCHEDULE = (8, 256, ((8, 128),))
FLEXSAT_NOISE_SEED = 0


@dataclass
class FlexsatSetup:
    prob: Problem            # the N=80 regulator, x0 [12]
    opts: SolverOptions
    noise: torch.Tensor      # [T, B, 12] standard normal


def flexsat_setup(B: int, T: int, dtype=torch.float32,
                  device="cuda") -> FlexsatSetup:
    """The flexsat regulator (built in float64 and cast), the benchmark's
    options and the process noise of T steps for B scenarios
    (``numpy.random.default_rng(0)``, drawn as one [T, B, 12] array)."""
    noise = np.random.default_rng(FLEXSAT_NOISE_SEED).standard_normal(
        (T, B, 12))
    return FlexsatSetup(
        prob=fs.flexsat_problem(dtype=dtype, device=device),
        opts=SolverOptions(**FLEXSAT_OPTS),
        noise=torch.as_tensor(noise, dtype=dtype, device=device))


def flexsat_step(su: FlexsatSetup, compact_cap: int = FLEXSAT_SCHEDULE[0],
                 compact_block: int = FLEXSAT_SCHEDULE[1],
                 compact_levels: tuple = FLEXSAT_SCHEDULE[2],
                 graphed: Optional[bool] = None, check_every: int = 1):
    """(step, init_carry) of the regulator step, in the schedule
    (``compact_cap``, ``compact_block``, ``compact_levels``; cap 0: the
    plain step)."""
    return make_regulator_step(su.prob, su.opts,
                               it_cap=compact_cap, block=compact_block,
                               levels=compact_levels, graphed=graphed,
                               check_every=check_every)


def flexsat_batched(B: int = 1024, T: int = 45, device="cuda",
                    compact_cap: int = FLEXSAT_SCHEDULE[0],
                    compact_block: int = FLEXSAT_SCHEDULE[1],
                    compact_levels: tuple = FLEXSAT_SCHEDULE[2],
                    graphed: Optional[bool] = None,
                    check_every: int = 1) -> dict:
    """Throughput and latency of the flexsat regulator MPC in float32,
    measured as the JAX package's benchmark does: one cold solve of the
    problem (B=1, on CUDA graphs when ``graphed``, None: on a CUDA device)
    copied to B lanes, one warm-up step (which captures the step's graphs:
    ``capture_s``, outside every timed window), a throughput pass of T
    steps timed whole, and a latency pass timing min(T, 10) single steps
    from the same carry. ``compact_cap`` 0 runs the plain step.

    ``loop_iterations`` counts the solver-loop body passes of every solve
    that ran (``solver.altro.pass_count``, the cold solve's and the frozen
    passes of a replay included); ``passes_per_step``,
    ``iters_max_per_step_mean`` (the steps' mean largest lane iteration
    count) and ``graph_replays_per_step`` are the throughput pass's;
    ``launches`` are the kernel launches of this call."""
    dev = torch.device(device)
    graphed = graph.use_graphs(graphed, dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    su = flexsat_setup(B, T, torch.float32, dev)
    before, passes0 = _launches(), altro.pass_count
    step, init_carry = flexsat_step(su, compact_cap, compact_block,
                                    compact_levels, graphed=graphed,
                                    check_every=check_every)

    t0 = time.perf_counter()
    sol0 = graph.solve(dataclasses.replace(su.prob, x0=su.prob.x0[None]),
                       su.opts, graphed=graphed, check_every=check_every)
    cold_passes = altro.pass_count - passes0
    carry0 = init_carry(B, sol0)
    sync()
    init_s = time.perf_counter() - t0

    step(carry0, su.noise[0], 0)                          # warm-up, capture
    replays = getattr(step, "loop_replays", 0)
    carry, outs = carry0, []
    sync()
    p0 = altro.pass_count
    ts = time.perf_counter()
    for t in range(T):
        carry, out = step(carry, su.noise[t], t)
        outs.append(out)
    sync()
    wall = time.perf_counter() - ts
    passes_T = altro.pass_count - p0
    replays_T = getattr(step, "loop_replays", 0) - replays

    step_ms = []
    carry = carry0
    for t in range(min(T, 10)):
        ts = time.perf_counter()
        carry, _ = step(carry, su.noise[t], t)
        sync()
        step_ms.append((time.perf_counter() - ts) * 1e3)

    status = torch.stack([o.status for o in outs]).cpu().numpy()
    viol = torch.stack([o.viol for o in outs]).double().cpu().numpy()
    iters = torch.stack([o.iters for o in outs]).cpu().numpy()
    after = _launches()
    p50, p99 = np.percentile(step_ms, [50, 99])
    return dict(
        label="flexsat_regulator_N80", batch=B, steps=T,
        solves_per_s=B * T / wall, success_rate=float(status.mean()),
        max_viol=float(np.nanmax(viol)), mean_iters=float(iters.mean()),
        iters_p99=float(np.percentile(iters, 99)), wall_s=wall,
        step_ms_p50=float(p50), step_ms_p99=float(p99),
        iters_max=int(iters.max()),
        iters_max_per_step_mean=float(iters.max(axis=1).mean()),
        passes_per_step=passes_T / T,
        graph_replays_per_step=replays_T / T,
        compaction=([compact_cap, compact_block,
                     [list(lv) for lv in compact_levels]]
                    if compact_cap else None),
        device=str(dev), graphed=graphed, check_every=check_every,
        init_s=init_s, capture_s=getattr(step, "capture_s", 0.0),
        cold_status=int(sol0.stats.status[0]),
        cold_iters=int(sol0.stats.iterations[0]), cold_passes=cold_passes,
        cold_viol=float(sol0.stats.viol[0]),
        loop_iterations=altro.pass_count - passes0,
        solves=2 + T + min(T, 10), cold_solves=1,
        launches={k: after[k] - before[k] for k in after})


MODES = ("qp", "socp", "qp_nl", "socp_nl", "flexsat")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("modes", nargs="*",
                    help=f"of {list(MODES)} (default: qp and socp)")
    ap.add_argument("--flexsat-compact-cap", type=int, default=-1,
                    help="flexsat: -1 the shipped schedule, 0 the plain "
                    "step, C > 0 cap C, block 128, no level")
    ap.add_argument("--eager", action="store_true",
                    help="the host-driven loop instead of CUDA graphs")
    ap.add_argument("--check-every", type=int, default=1,
                    help="body passes per replay of the loop graph")
    args = ap.parse_args()
    if set(args.modes) - set(MODES):
        ap.error(f"unknown mode in {args.modes}; choose from {MODES}")
    if not torch.cuda.is_available():
        raise SystemExit("the families benchmark measures a CUDA device; "
                         "none is available")
    B = int(os.environ.get("BENCH_BATCH", 1024))
    rounds = int(os.environ.get("BENCH_ROUNDS", 10))
    card = power_limit()
    for mode in args.modes or ["qp", "socp"]:
        if mode == "flexsat":
            cap = args.flexsat_compact_cap
            sched = (FLEXSAT_SCHEDULE if cap == -1
                     else (cap, 128, ()))
            res = flexsat_batched(
                B=B, T=int(os.environ.get("BENCH_STEPS", 45)),
                compact_cap=sched[0], compact_block=sched[1],
                compact_levels=sched[2], graphed=not args.eager,
                check_every=args.check_every)
        else:
            res = quadruped_batched(B=B, rounds=rounds,
                                    linearized_friction=mode.startswith(
                                        "qp"),
                                    graphed=not args.eager,
                                    check_every=args.check_every,
                                    nonlinear=mode.endswith("_nl"))
        res["device"] = f"{torch.cuda.get_device_name(0)} [{card}]"
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
