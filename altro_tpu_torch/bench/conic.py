"""Conic (SOC) MPC benchmarks of the port: the rocket soft landing and the
grasp with rotating friction cones (the counterpart of
``altro_tpu/bench/batched_conic.py``), in the straggler-compacted step that
the JAX package's benchmark ships, or in the plain step.

- rocket: ``rocket_problem(N=301, tf=15)`` (n=6, m=3; goal ZERO block plus
  max-thrust, thrust-angle and glideslope SOC blocks), one cold solve from
  the hover controls, then the N_mpc=21 tracking MPC of that trajectory
  (three SOC blocks, 15 rows) stepping B scenarios that differ in process
  noise, seeded every step from the tracking window's controls with fresh
  duals (``warm_start="track"``); compaction cap 16, block 256, one level
  (16, 128).
- the naive rocket (``naive_rocket_setup``): the rocket's cold N=301
  problem in its quadratic norm form (``conic=False``: the goal ZERO block
  and three ``QuadNormConstraint`` blocks, the paper's SOC-against-
  Inequality comparison), solved cold from the hover controls under the
  cold options, at the default x0 (one lane) or as a Monte-Carlo of B
  landings. Its blocks are not affine, so every iteration takes the split
  route: the expansion in PyTorch with per-lane Jacobians and the blocks'
  exact curvature, the Riccati kernel (ops/riccati.py) with shared A/B and
  per-lane Hessians, the ladder-rollout kernel at L=11 and the merit in
  PyTorch.
- grasp: ``grasp_problem(N=61, tf=6)`` (n = m = 6; goal ZERO block, torque
  balance ZERO p=3, max force NONPOS p=2, two SOC friction cones p=4), one
  cold solve from the hover controls, then the N_mpc=21 tracking MPC whose
  four blocks (13 rows) are cut anew every step from the rotating contact
  frames (``constraints_fn``), seeded from the shifted previous solution
  with seam-corrected states (``warm_start="shift"``); compaction cap 8,
  block 256, one level (8, 128).

On a CUDA device every solver iteration runs the fused expansion + Riccati
kernel (its SOC branch) and the fused ladder + AL-merit kernel; a solve
without states to start from runs the ladder-rollout kernel once for its
init rollout.

Run as a script on a CUDA machine:

    python -m altro_tpu_torch.bench.conic [rocket] [grasp] [--plain]
                                          [--eager]

It prints ONE JSON line {"metric", "value", "unit", "vs_baseline"} per
family on stdout and a diagnostics line per family on stderr (the power
limit, then the whole result as JSON). ``--plain`` runs the plain step.
The steps and the cold solves run as CUDA graphs (``solver/graph.py``);
``--eager`` runs the host-driven loop instead. Knobs: BENCH_BATCH (1024),
BENCH_STEPS (30 rocket, 15 grasp).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..convert import tree_to
from ..models import grasp, rocket
from ..mpc import (default_noise_model, gen_tracking_mpc, make_mpc_step,
                   make_mpc_step_device_compacted)
from ..problem import Problem
from ..solver import altro, graph
from ..solver.options import SolverOptions
from .flagship import power_limit

N_COLD, DT = 301, 0.05
# the rocket's cold solve of the N=301 problem from the hover controls
COLD_OPTS = dict(cost_tolerance=1e-5, gradient_tolerance=1e-6,
                 constraint_tolerance=1e-4, penalty_initial=1e-2,
                 penalty_scaling=500.0, iterations_outer=40,
                 iterations_inner=100)
# the rocket's warm MPC solves: tracking-seeded, fresh duals, penalties
# reset at 1e2, an L=5 ladder plus the alpha=0 rung
WARM_OPTS = dict(cost_tolerance=1e-6, gradient_tolerance=1e-6,
                 constraint_tolerance=1e-4, penalty_initial=1e2,
                 penalty_scaling=10.0, reset_duals=True,
                 reset_penalties=True, iterations_outer=15,
                 iterations_inner=50, reg_min=1e-8, early_exact_tol=0.0,
                 iterations_linesearch=5)
GRASP_N, GRASP_TF = 61, 6.0
GRASP_COLD_OPTS = dict(cost_tolerance=1e-5, gradient_tolerance=1e-6,
                       constraint_tolerance=1e-5, penalty_initial=10.0,
                       penalty_scaling=10.0, iterations_outer=30,
                       iterations_inner=50)
# grasp's warm MPC solves: shifted warm start keeping the duals, penalties
# 1e3 x10, an L=2 ladder plus the alpha=0 rung and the exact-step stop
GRASP_WARM_OPTS = dict(cost_tolerance=1e-4, constraint_tolerance=1e-4,
                       penalty_initial=1e3, penalty_scaling=10.0,
                       reset_duals=False, iterations_inner=8, reg_min=1.0,
                       early_exact_tol=1e-3, iterations_linesearch=2)
# the naive rocket's Monte-Carlo of landings: x0 = the default + this
# spread times N(0, 1) per component, numpy default_rng(NAIVE_SEED)
NAIVE_X0_SPREAD, NAIVE_SEED = 0.5, 0
# the compaction schedules the JAX package's conic benchmark ships:
# (it_cap, block, levels)
SCHEDULES = {"rocket": (16, 256, ((16, 128),)),
             "grasp": (8, 256, ((8, 128),))}


@dataclass
class ConicSetup:
    """One family's MPC problem, warm options and tracking reference, and
    how its benchmark steps it."""

    family: str
    prob_mpc: Problem
    opts: SolverOptions
    X_track: torch.Tensor
    U_track: torch.Tensor
    noise_model: Callable
    constraints_fn: Optional[Callable]  # the window's blocks at knot k
    warm_start: str
    noise_seed: int
    cold_N: int                    # knots of the long (cold) problem
    cold_status: Optional[int]     # None when the track was given
    cold_viol: Optional[float]
    cold_iters: int                # solver-loop passes of the cold solve
    cold_s: Optional[float]


@dataclass
class NaiveRocketSetup:
    """The rocket's cold solve of a batch of landings."""

    prob: Problem        # N=301, x0 [B, 6]
    U0: torch.Tensor     # [B, N-1, 3] the hover controls
    opts: SolverOptions  # COLD_OPTS


def naive_rocket_setup(B: int, dtype=torch.float32, device="cuda",
                       conic: bool = False) -> NaiveRocketSetup:
    """The rocket's N=301 problem in its naive form (``conic``: the SOC
    form, for the comparison) with the hover controls and the cold options:
    at B=1 the default x0, else B landings from x0 = the default +
    NAIVE_X0_SPREAD N(0, 1) per component (numpy
    ``default_rng(NAIVE_SEED)``, drawn [B, 6]). Built in float64 on the
    CPU and then cast, so that a float32 and a float64 run solve the same
    lanes."""
    prob = rocket.rocket_problem(N=N_COLD, tf=(N_COLD - 1) * DT,
                                 conic=conic)
    x0 = prob.x0[None]
    if B > 1:
        x0 = x0 + torch.as_tensor(
            NAIVE_X0_SPREAD * np.random.default_rng(NAIVE_SEED)
            .standard_normal((B, 6)))
    U0 = rocket.hover_controls(prob)[None].expand(B, -1, -1).contiguous()
    return tree_to(NaiveRocketSetup(prob=dataclasses.replace(prob, x0=x0),
                                    U0=U0, opts=SolverOptions(**COLD_OPTS)),
                   device, dtype)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _cold_solve(prob: Problem, opts: SolverOptions, U0, device, graphed):
    """One cold B=1 solve of the long-horizon problem (on CUDA graphs when
    ``graphed``, None: on a CUDA device): (X, U) and the cold fields of
    :class:`ConicSetup`."""
    t0 = time.perf_counter()
    passes = altro.pass_count
    sol = graph.solve(dataclasses.replace(prob, x0=prob.x0[None]), opts,
                      U0=U0[None], graphed=graphed)
    _sync(device)
    return (sol.X[0], sol.U[0]), dict(
        cold_status=int(sol.stats.status[0]),
        cold_viol=float(sol.stats.viol[0]),
        cold_iters=altro.pass_count - passes,
        cold_s=time.perf_counter() - t0)


NO_COLD = dict(cold_status=None, cold_viol=None, cold_iters=0, cold_s=None)


def rocket_setup(dtype=torch.float32, N_mpc: int = 21, track=None,
                 device="cuda", graphed: Optional[bool] = None) -> ConicSetup:
    """The rocket MPC problem, warm options and tracking reference.
    ``track=(X, U)`` skips the cold solve and tracks the given trajectory
    (so two runs in different precisions can solve the same windows)."""
    prob = rocket.rocket_problem(N=N_COLD, tf=(N_COLD - 1) * DT, dtype=dtype,
                                 device=device)
    cold = NO_COLD
    if track is None:
        track, cold = _cold_solve(prob, SolverOptions(**COLD_OPTS),
                                  rocket.hover_controls(prob), device,
                                  graphed)
    X_track, U_track = track
    prob_mpc = gen_tracking_mpc(prob, X_track, U_track, N_mpc, dt=DT)
    return ConicSetup(family="rocket", prob_mpc=prob_mpc,
                      opts=SolverOptions(**WARM_OPTS), X_track=X_track,
                      U_track=U_track,
                      noise_model=rocket.rocket_noise_model(),
                      constraints_fn=None, warm_start="track", noise_seed=1,
                      cold_N=N_COLD, **cold)


def grasp_setup(dtype=torch.float32, N_mpc: int = 21, track=None,
                device="cuda", graphed: Optional[bool] = None) -> ConicSetup:
    """The grasp MPC problem, warm options, tracking reference and
    constraint windows; ``track`` as in :func:`rocket_setup`."""
    o = grasp.make_grasp_object(GRASP_N, GRASP_TF, dtype=dtype,
                                device=device)
    prob = grasp.grasp_problem(o, GRASP_N, GRASP_TF)
    cold = NO_COLD
    if track is None:
        track, cold = _cold_solve(prob, SolverOptions(**GRASP_COLD_OPTS),
                                  grasp.hover_controls(o, GRASP_N), device,
                                  graphed)
    X_track, U_track = track
    pm = gen_tracking_mpc(prob, X_track, U_track, N_mpc, Qk=1e3, Rk=1.0,
                          Qfk=10.0, dt=GRASP_TF / (GRASP_N - 1))
    pm = dataclasses.replace(pm, constraints=grasp.grasp_constraints(
        o, N_mpc, 0))
    return ConicSetup(family="grasp", prob_mpc=pm,
                      opts=SolverOptions(**GRASP_WARM_OPTS), X_track=X_track,
                      U_track=U_track, noise_model=default_noise_model,
                      constraints_fn=lambda k: grasp.grasp_constraints(
                          o, N_mpc, k),
                      warm_start="shift", noise_seed=0, cold_N=GRASP_N,
                      **cold)


SETUPS = {"rocket": rocket_setup, "grasp": grasp_setup}


def make_step(setup: ConicSetup, compact_cap: int = 0,
              compact_block: int = 256, compact_levels: tuple = (),
              opts: Optional[SolverOptions] = None,
              graphed: Optional[bool] = None):
    """(step, init_carry) of the family's MPC step: compacted with the
    schedule (``compact_cap``, ``compact_block``, ``compact_levels``), or
    the plain step when ``compact_cap`` is 0. ``opts`` replaces the setup's
    warm options; ``graphed`` as in ``mpc.make_mpc_step``."""
    kw = dict(noise_model=setup.noise_model,
              constraints_fn=setup.constraints_fn,
              warm_start=setup.warm_start, graphed=graphed)
    args = (setup.prob_mpc, setup.opts if opts is None else opts,
            setup.X_track, setup.U_track)
    if compact_cap:
        return make_mpc_step_device_compacted(
            *args, it_cap=compact_cap, block=compact_block,
            levels=compact_levels, **kw)
    return make_mpc_step(*args, shared_k=True, **kw)


def _baseline_ms(family_row: str, col: int, path: str = None) -> float:
    if path is None:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            os.pardir, os.pardir, "BASELINE.md")
    with open(path) as f:
        row = next((line for line in f
                    if all(w in line for w in family_row.split("..."))),
                   None)
    if row is None:
        raise RuntimeError(f"BASELINE.md at {path} has no '{family_row}' "
                           "table row")
    cells = [c.strip() for c in row.split("|")]
    return float(cells[3].split("/")[col])


def rocket_baseline_solves_per_s(path: str = None) -> float:
    """Reference-ALTRO rocket MPC throughput at tolerance 1e-4 (the warm
    solves' constraint tolerance): 1000 / the last mean-ms entry of the
    'Rocket landing (SOC), N_mpc=21, tol sweep' row of BASELINE.md."""
    return 1000.0 / _baseline_ms("Rocket landing (SOC)...tol sweep", -1, path)


def grasp_baseline_solves_per_s(path: str = None) -> float:
    """Reference-ALTRO grasp MPC throughput at N=21: 1000 / the N=21 entry
    (the second) of the 'Grasp ... horizon sweep' row of BASELINE.md."""
    return 1000.0 / _baseline_ms("Grasp...horizon sweep", 1, path)


def conic_batched(setup: ConicSetup, B: int = 1024, T: int = 30,
                  device="cuda", compact_cap: int = 0,
                  compact_block: int = 256, compact_levels: tuple = (),
                  graphed: Optional[bool] = None) -> dict:
    """Throughput and latency of a family's MPC loop on ``device``, measured
    as the JAX package's conic benchmark does: one cold batched solve builds
    the initial carry, one warm-up step runs (it captures the step's graphs:
    ``capture_s``, outside every timed window), a throughput pass of T
    steps is timed whole, and a latency pass times min(T, 10) single steps.
    ``graphed`` (None: on a CUDA device) as in ``mpc.make_mpc_step``.

    ``loop_iterations`` counts the solver-loop body passes of every solve
    that ran (``solver.altro.pass_count``, the frozen passes of a replay
    included), the cold solve of the setup included when it ran; ``solves``
    counts those solves and ``cold_solves`` those among them that had no
    states to start from (the setup's cold solve and the batched initial
    solve). ``passes_per_step`` is the throughput pass's passes per step,
    ``iters_max_per_step_mean`` its steps' mean largest lane iteration
    count and ``graph_replays_per_step`` its loop-graph replays per
    step."""
    dev = torch.device(device)
    graphed = graph.use_graphs(graphed, dev)
    noise = torch.as_tensor(np.random.default_rng(setup.noise_seed)
                            .standard_normal((T, B, 6)),
                            dtype=setup.prob_mpc.x0.dtype, device=dev)
    step, init_carry = make_step(setup, compact_cap, compact_block,
                                 compact_levels, graphed=graphed)
    ran_cold = setup.cold_status is not None
    passes0 = altro.pass_count - setup.cold_iters

    t0 = time.perf_counter()
    carry0 = init_carry(B)
    _sync(dev)
    init_s = time.perf_counter() - t0

    step(carry0, noise[0], 0)                           # warm-up, capture
    replays = getattr(step, "loop_replays", 0)

    carry, outs = carry0, []
    _sync(dev)
    p0 = altro.pass_count
    ts = time.perf_counter()
    for t in range(T):
        carry, out = step(carry, noise[t], t)
        outs.append(out)
    _sync(dev)
    wall = time.perf_counter() - ts
    passes_T = altro.pass_count - p0
    replays_T = getattr(step, "loop_replays", 0) - replays

    step_ms = []
    carry = carry0
    for t in range(min(T, 10)):
        ts = time.perf_counter()
        carry, out = step(carry, noise[t], t)
        _sync(dev)
        step_ms.append((time.perf_counter() - ts) * 1e3)

    status = torch.stack([o.status for o in outs]).cpu()
    viol = torch.stack([o.viol for o in outs]).double().cpu()
    iters = torch.stack([o.iters for o in outs]).cpu().numpy()
    ok = status == 1
    p50, p99 = np.percentile(step_ms, [50, 99])
    return {
        "family": setup.family, "B": B, "T": T, "device": str(dev),
        "graphed": graphed,
        "compaction": ([compact_cap, compact_block,
                        [list(lv) for lv in compact_levels]]
                       if compact_cap else None),
        "solves_per_s": B * T / wall, "wall_s": wall, "init_s": init_s,
        "capture_s": getattr(step, "capture_s", 0.0),
        "cold_N": setup.cold_N,
        "cold_status": setup.cold_status, "cold_viol": setup.cold_viol,
        "cold_iters": setup.cold_iters, "cold_s": setup.cold_s,
        "step_ms_p50": float(p50), "step_ms_p99": float(p99),
        "success_rate": float(ok.double().mean()),
        "max_viol": float(viol.max()),
        "max_viol_succeeded": float(viol[ok].max()) if ok.any() else None,
        "mean_iters": float(iters.mean()),
        "iters_max": int(iters.max()),
        "iters_max_per_step_mean": float(iters.max(axis=1).mean()),
        "iters_p50": float(np.percentile(iters, 50)),
        "iters_p99": float(np.percentile(iters, 99)),
        "passes_per_step": passes_T / T,
        "graph_replays_per_step": replays_T / T,
        "loop_iterations": altro.pass_count - passes0,
        "solves": int(ran_cold) + 2 + T + min(T, 10),
        "cold_solves": int(ran_cold) + 1,
    }


def rocket_batched(B: int = 1024, T: int = 30, N_mpc: int = 21,
                   device="cuda", setup: Optional[ConicSetup] = None,
                   compact_cap: int = 0, compact_block: int = 256,
                   compact_levels: tuple = (),
                   graphed: Optional[bool] = None) -> dict:
    """:func:`conic_batched` of the rocket in float32; ``setup`` (a float32
    :func:`rocket_setup` on ``device``) is built here when not given."""
    if setup is None:
        setup = rocket_setup(torch.float32, N_mpc, device=device,
                             graphed=graphed)
    return conic_batched(setup, B, T, device, compact_cap, compact_block,
                         compact_levels, graphed)


def grasp_batched(B: int = 1024, T: int = 15, N_mpc: int = 21,
                  device="cuda", setup: Optional[ConicSetup] = None,
                  compact_cap: int = 0, compact_block: int = 256,
                  compact_levels: tuple = (),
                  graphed: Optional[bool] = None) -> dict:
    """:func:`conic_batched` of grasp in float32; ``setup`` (a float32
    :func:`grasp_setup` on ``device``) is built here when not given."""
    if setup is None:
        setup = grasp_setup(torch.float32, N_mpc, device=device,
                            graphed=graphed)
    return conic_batched(setup, B, T, device, compact_cap, compact_block,
                         compact_levels, graphed)


FAMILIES = {"rocket": (rocket_batched, 30, "rocket_mpc_solves_per_s_chip_N21",
                       rocket_baseline_solves_per_s),
            "grasp": (grasp_batched, 15, "grasp_mpc_solves_per_s_chip_N21",
                      grasp_baseline_solves_per_s)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("families", nargs="*",
                    help=f"of {list(FAMILIES)} (default: all)")
    ap.add_argument("--plain", action="store_true",
                    help="the plain step instead of the shipped compaction")
    ap.add_argument("--eager", action="store_true",
                    help="the host-driven loop instead of CUDA graphs")
    args = ap.parse_args()
    unknown = [f for f in args.families if f not in FAMILIES]
    if unknown:
        ap.error(f"unknown family {unknown}; choose from {list(FAMILIES)}")
    if not torch.cuda.is_available():
        raise SystemExit("the conic benchmark measures a CUDA device; none "
                         "is available")
    B = int(os.environ.get("BENCH_BATCH", 1024))
    card = power_limit()
    for family in args.families or list(FAMILIES):
        run, T, metric, baseline = FAMILIES[family]
        T = int(os.environ.get("BENCH_STEPS", T))
        cap, block, levels = (0, 256, ()) if args.plain else SCHEDULES[family]
        res = run(B=B, T=T, device="cuda", compact_cap=cap,
                  compact_block=block, compact_levels=levels,
                  graphed=not args.eager)
        print(json.dumps({
            "metric": metric, "value": round(res["solves_per_s"], 1),
            "unit": "solves/s",
            "vs_baseline": round(res["solves_per_s"] / baseline(), 2)}),
            flush=True)
        print(f"# {card} {json.dumps(res)}", file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
