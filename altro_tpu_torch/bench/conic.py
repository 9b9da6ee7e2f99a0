"""Rocket soft-landing SOC MPC benchmark of the port (the counterpart of the
rocket part of ``altro_tpu/bench/batched_conic.py``, its plain step).

The problem: ``rocket_problem(N=301, tf=15)`` (n=6, m=3; goal ZERO block
plus max-thrust, thrust-angle and glideslope SOC blocks), one cold solve
from the hover controls, then the N_mpc=21 tracking MPC of that trajectory
(three SOC blocks, 15 rows) stepping B scenarios that differ in process
noise, seeded every step from the tracking window's controls with fresh
duals (``warm_start="track"``). On a CUDA device every solver iteration runs
the fused expansion + Riccati kernel (SOC branch) and the fused ladder +
AL-merit kernel; every solve runs the ladder-rollout kernel once for its
init rollout.

Run as a script on a CUDA machine:

    python -m altro_tpu_torch.bench.conic

It prints ONE JSON line {"metric", "value", "unit", "vs_baseline"} on
stdout and a diagnostics line (device, power limit, cold solve, latency,
success, iterations) on stderr. Knobs: BENCH_BATCH (1024), BENCH_STEPS (30).
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..models import rocket
from ..mpc import gen_tracking_mpc, make_mpc_step
from ..problem import Problem
from ..solver.altro import solve
from ..solver.options import SolverOptions
from .flagship import power_limit

N_COLD, DT = 301, 0.05
# the cold solve of the N=301 problem from the hover controls
COLD_OPTS = dict(cost_tolerance=1e-5, gradient_tolerance=1e-6,
                 constraint_tolerance=1e-4, penalty_initial=1e-2,
                 penalty_scaling=500.0, iterations_outer=40,
                 iterations_inner=100)
# the warm MPC solves: tracking-seeded, fresh duals, penalties reset at 1e2,
# an L=5 ladder plus the alpha=0 rung
WARM_OPTS = dict(cost_tolerance=1e-6, gradient_tolerance=1e-6,
                 constraint_tolerance=1e-4, penalty_initial=1e2,
                 penalty_scaling=10.0, reset_duals=True,
                 reset_penalties=True, iterations_outer=15,
                 iterations_inner=50, reg_min=1e-8, early_exact_tol=0.0,
                 iterations_linesearch=5)


@dataclass
class RocketSetup:
    prob_mpc: Problem
    opts: SolverOptions
    X_track: torch.Tensor          # [N_COLD, 6]
    U_track: torch.Tensor          # [N_COLD-1, 3]
    noise_model: Callable
    cold_status: Optional[int]     # None when the track was given
    cold_viol: Optional[float]
    cold_iters: int                # solver-loop passes of the cold solve
    cold_s: Optional[float]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def rocket_setup(dtype=torch.float32, N_mpc: int = 21, track=None,
                 device="cuda") -> RocketSetup:
    """The rocket MPC problem, warm options and tracking reference.
    ``track=(X, U)`` skips the cold solve and tracks the given trajectory
    (so two runs in different precisions can solve the same windows)."""
    prob = rocket.rocket_problem(N=N_COLD, tf=(N_COLD - 1) * DT, dtype=dtype,
                                 device=device)
    cold = dict(cold_status=None, cold_viol=None, cold_iters=0, cold_s=None)
    if track is None:
        t0 = time.perf_counter()
        sol = solve(dataclasses.replace(prob, x0=prob.x0[None]),
                    SolverOptions(**COLD_OPTS),
                    U0=rocket.hover_controls(prob)[None])
        _sync(device)
        cold = dict(cold_status=int(sol.stats.status[0]),
                    cold_viol=float(sol.stats.viol[0]),
                    cold_iters=int(sol.stats.iterations.max()),
                    cold_s=time.perf_counter() - t0)
        track = (sol.X[0], sol.U[0])
    X_track, U_track = track
    prob_mpc = gen_tracking_mpc(prob, X_track, U_track, N_mpc, dt=DT)
    return RocketSetup(prob_mpc=prob_mpc, opts=SolverOptions(**WARM_OPTS),
                       X_track=X_track, U_track=U_track,
                       noise_model=rocket.rocket_noise_model(), **cold)


def rocket_baseline_solves_per_s(path: str = None) -> float:
    """Reference-ALTRO rocket MPC throughput at tolerance 1e-4 (the warm
    solves' constraint tolerance): 1000 / the last mean-ms entry of the
    'Rocket landing (SOC), N_mpc=21, tol sweep' row of BASELINE.md."""
    if path is None:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            os.pardir, os.pardir, "BASELINE.md")
    with open(path) as f:
        row = next((line for line in f
                    if "Rocket landing (SOC)" in line and "tol sweep" in line),
                   None)
    if row is None:
        raise RuntimeError(f"BASELINE.md at {path} has no 'Rocket landing "
                           "(SOC) ... tol sweep' table row")
    cells = [c.strip() for c in row.split("|")]
    return 1000.0 / float(cells[3].split("/")[-1])


def rocket_batched(B: int = 1024, T: int = 30, N_mpc: int = 21,
                   device="cuda", setup: Optional[RocketSetup] = None) -> dict:
    """Throughput and latency of the rocket MPC loop in float32 on
    ``device``, measured as the JAX package's conic benchmark does: one
    cold batched solve builds the initial carry, one warm-up step runs, a
    throughput pass of T steps is timed whole, and a latency pass times
    min(T, 10) single steps. ``setup`` (a float32 :func:`rocket_setup` on
    ``device``) is built here when not given.

    ``loop_iterations`` counts the solver-loop passes of every solve that
    ran, the cold solve of the setup included when it ran here or was
    passed in (a batch solve's passes are its lanes' maximum iteration
    count); ``solves`` counts those solves."""
    dev = torch.device(device)
    if setup is None:
        setup = rocket_setup(torch.float32, N_mpc, device=dev)
    noise = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (T, B, 6)), dtype=torch.float32, device=dev)
    step, _ = make_mpc_step(setup.prob_mpc, setup.opts, setup.X_track,
                            setup.U_track, noise_model=setup.noise_model,
                            shared_k=True, warm_start="track")
    passes = [setup.cold_iters] if setup.cold_status is not None else []

    t0 = time.perf_counter()
    x0 = setup.prob_mpc.x0.expand(B, 6).contiguous()
    sol0 = solve(dataclasses.replace(setup.prob_mpc, x0=x0), setup.opts)
    carry0 = (x0, sol0.X, sol0.U, sol0.duals)
    passes.append(int(sol0.stats.iterations.max()))
    _sync(dev)
    init_s = time.perf_counter() - t0

    _, out = step(carry0, noise[0], 0)                   # warm-up
    passes.append(int(out.iters.max()))

    carry, outs = carry0, []
    _sync(dev)
    ts = time.perf_counter()
    for t in range(T):
        carry, out = step(carry, noise[t], t)
        outs.append(out)
    _sync(dev)
    wall = time.perf_counter() - ts

    step_ms = []
    carry = carry0
    for t in range(min(T, 10)):
        ts = time.perf_counter()
        carry, out = step(carry, noise[t], t)
        _sync(dev)
        step_ms.append((time.perf_counter() - ts) * 1e3)
        passes.append(int(out.iters.max()))

    status = torch.stack([o.status for o in outs]).cpu()
    viol = torch.stack([o.viol for o in outs]).double().cpu()
    iters = torch.stack([o.iters for o in outs]).cpu().numpy()
    passes += [int(i.max()) for i in iters]
    ok = status == 1
    p50, p99 = np.percentile(step_ms, [50, 99])
    return {
        "B": B, "T": T, "device": str(dev),
        "solves_per_s": B * T / wall, "wall_s": wall, "init_s": init_s,
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
        "loop_iterations": sum(passes),
        "solves": len(passes),
    }


def main():
    if not torch.cuda.is_available():
        raise SystemExit("the rocket benchmark measures a CUDA device; none "
                         "is available")
    B = int(os.environ.get("BENCH_BATCH", 1024))
    T = int(os.environ.get("BENCH_STEPS", 30))
    res = rocket_batched(B=B, T=T, device="cuda")
    print(json.dumps({
        "metric": "rocket_mpc_solves_per_s_chip_N21",
        "value": round(res["solves_per_s"], 1),
        "unit": "solves/s",
        "vs_baseline": round(res["solves_per_s"]
                             / rocket_baseline_solves_per_s(), 2),
    }))
    print(f"# {power_limit()} B={B} T={T} cold_status={res['cold_status']} "
          f"cold_iters={res['cold_iters']} cold_s={res['cold_s']:.2f} "
          f"success_rate={res['success_rate']:.4f} max_viol="
          f"{res['max_viol']:.2e} mean_iters={res['mean_iters']:.2f} "
          f"lane_max_iters={res['iters_max_per_step_mean']:.1f} "
          f"step_ms_p50={res['step_ms_p50']:.2f} "
          f"p99={res['step_ms_p99']:.2f}", file=sys.stderr)


if __name__ == "__main__":
    main()
