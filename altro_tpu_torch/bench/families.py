"""Batched quadruped trot-MPC benchmark of the port (the counterpart of
``quadruped_setup`` and the flat per-lane layout of ``quadruped_batched`` in
``altro_tpu/bench/batched_families.py``).

The instances: the Woofer trot MPC at N=15 (n = m = 12; four friction blocks
and one vertical-force bound block), linearized about 8 contact schedules
sampled across one trot cycle, B/8 lanes each, every lane with its own
dynamics stack and an initial state x_des + noise (2 cm / 0.05 rad scale).
Every round solves the whole batch cold from the gravity-distributing stance
forces, with a fresh x0 draw. On a CUDA device every solver iteration runs
the AL expansion in PyTorch, the Riccati kernel (ops/riccati.py) and the
ladder-rollout kernel (ops/rollout.py) with the line-search merit in
PyTorch; every solve runs the ladder-rollout kernel once more for its init
rollout.

Run as a script on a CUDA machine (both friction modes, B=1024, f32):

    python -m altro_tpu_torch.bench.families [qp] [socp] [--eager]
                                             [--check-every K]

It prints one JSON line per mode with the JAX package's row keys (label,
batch, rounds, solves_per_s, success_rate, max_viol, mean_iters, iters_max,
iters_p99, wall_s) plus the device, per-round ms, solver-loop passes,
graph replays, capture seconds and kernel launches. Every round replays
one ``solver.graph.GraphedSolve`` (K body passes per loop replay, 1 by
default, the fastest of 1, 2, 4 and 8 on the card); ``--eager`` runs the
host-driven loop instead. Knobs: BENCH_BATCH (1024), BENCH_ROUNDS (10).
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
from ..models.quadruped import config, controller, planner
from ..models.quadruped.gait import GAITS
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


def quadruped_setup(B: int, linearized_friction: bool = True,
                    dtype=torch.float32, device="cuda") -> QuadrupedSetup:
    """The flat batched quadruped instance: 8 contact schedules at
    t = i * cycle / 8 (i < 8), each linearized about x_des and repeated to
    B/8 lanes, the stance-force warm start, the benchmark's options and the
    seeded x0 sampler (``numpy.random.default_rng(3)``; each call draws the
    next batch).

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
    dyns = []
    for i in range(N_SCHED):
        t = torch.tensor(i * cycle / N_SCHED, dtype=f64)
        contacts, foot_locs, _ = planner.foot_history(
            t, x_ref, feet0, feet0, gait, x_des, N, dt)
        dyns.append(controller._linearized_problem(
            prob, x_des, x_ref, contacts, foot_locs, dt).dynamics)
    reps = B // N_SCHED
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
                        x_des=x_des, draw_x0=draw_x0)
    return tree_to(su, device, dtype)


def _launches() -> dict:
    return {"batched_ls_rollout": rollout.launch_count,
            "fused_expand_backward": riccati_fused.launch_count,
            "batched_ls_rollout_al": rollout_al.launch_count,
            "batched_riccati": riccati.launch_count}


def quadruped_batched(B: int = 1024, rounds: int = 10,
                      linearized_friction: bool = True, device="cuda",
                      graphed: Optional[bool] = None,
                      check_every: int = 1) -> dict:
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
    kernel launches of this call."""
    dev, dtype = torch.device(device), torch.float32
    graphed = graph.use_graphs(graphed, dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    su = quadruped_setup(B, linearized_friction, dtype, dev)
    before, passes0 = _launches(), altro.pass_count
    gs = (graph.GraphedSolve(su.prob, su.opts, check_every=check_every)
          if graphed else None)

    def solve_batch():
        x0 = su.draw_x0().to(device=dev, dtype=dtype)
        if gs is not None:
            return gs(x0, su.U0).stats
        sol = altro.solve(dataclasses.replace(su.prob, x0=x0), su.opts,
                          U0=su.U0)
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
    mode = "qp" if linearized_friction else "socp"
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("modes", nargs="*",
                    help="friction modes of ['qp', 'socp'] (default: both)")
    ap.add_argument("--eager", action="store_true",
                    help="the host-driven loop instead of CUDA graphs")
    ap.add_argument("--check-every", type=int, default=1,
                    help="body passes per replay of the loop graph")
    args = ap.parse_args()
    if set(args.modes) - {"qp", "socp"}:
        ap.error(f"unknown mode in {args.modes}; choose from qp, socp")
    if not torch.cuda.is_available():
        raise SystemExit("the quadruped benchmark measures a CUDA device; "
                         "none is available")
    B = int(os.environ.get("BENCH_BATCH", 1024))
    rounds = int(os.environ.get("BENCH_ROUNDS", 10))
    card = power_limit()
    for mode in args.modes or ["qp", "socp"]:
        res = quadruped_batched(B=B, rounds=rounds,
                                linearized_friction=mode == "qp",
                                graphed=not args.eager,
                                check_every=args.check_every)
        res["device"] = f"{torch.cuda.get_device_name(0)} [{card}]"
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
