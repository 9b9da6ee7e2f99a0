"""Flagship benchmark of the port: warm-started MPC solves/s at horizon N=30
(the counterpart of the JAX package's ``bench.py``).

The random-linear tracking MPC (n=12, m=6, N_mpc=30, one NONPOS +-3 control
bound block) runs as a batch of B scenarios stepping a warm-started
receding-horizon loop on one device, and reports throughput.

Run as a script on a CUDA machine:

    python -m altro_tpu_torch.bench.flagship

It prints ONE JSON line {"metric", "value", "unit", "vs_baseline"} on
stdout and a diagnostics line (device, power limit, latency, success,
iterations) on stderr. Knobs: BENCH_BATCH (1024), BENCH_STEPS (100),
BENCH_LS (2, the ladder length before the alpha=0 rung).
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..models import random_linear as rl
from ..mpc import make_mpc_step
from ..problem import Problem
from ..solver.altro import solve
from ..solver.options import SolverOptions

N_MPC, N_STATE, N_CONTROL = 30, 12, 6


def baseline_solves_per_s(n_mpc: int = 30, path: str = None) -> float:
    """Reference-ALTRO throughput at horizon ``n_mpc``, linearly
    interpolated from the random-linear horizon-sweep row of BASELINE.md
    (the same derivation as bench.py)."""
    if path is None:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            os.pardir, os.pardir, "BASELINE.md")
    with open(path) as f:
        text = f.read()
    row = next((line for line in text.splitlines()
                if "horizon sweep" in line and "Random linear" in line), None)
    if row is None:
        raise RuntimeError(
            f"BASELINE.md at {path} has no 'Random linear ... horizon sweep' "
            "table row")
    cells = [c.strip() for c in row.split("|")]
    ns = [int(x) for x in re.search(r"N=([\d/]+)", cells[2]).group(1).split("/")]
    times = [float(x) for x in cells[3].split("/")]
    if len(ns) != len(times) or ns != sorted(ns):
        raise RuntimeError(f"malformed horizon row in {path}: {row}")
    return 1000.0 / float(np.interp(n_mpc, ns, times))


@dataclass
class FlagshipSetup:
    prob_mpc: Problem
    opts: SolverOptions
    X_track: torch.Tensor   # [N_track, n]
    U_track: torch.Tensor   # [N_track-1, m]
    noise: torch.Tensor     # [T, B, n] standard normal


def flagship_setup(B: int, T: int, *, dtype=torch.float32, device="cuda",
                   ls: int = 2) -> FlagshipSetup:
    """The flagship problem, options and noise from bench.py's numpy seed,
    in the order bench.py draws them."""
    rng = np.random.default_rng(1)
    N_track = N_MPC + T + 2
    prob = rl.gen_random_linear(rng, N_STATE, N_CONTROL, N_track,
                                dtype=dtype, device=device)
    X_track, U_track = rl.gen_trajectory(rng, prob, N_track)
    prob_mpc = rl.gen_tracking_mpc(prob, X_track, U_track, N_MPC)
    # bench.py's tunings: an L=2 ladder (alpha 1, 0.5 + the alpha=0 rung)
    # and the exact-step early stop
    opts = SolverOptions(
        cost_tolerance=1e-4, gradient_tolerance=1e-4,
        constraint_tolerance=1e-4, penalty_initial=1e3,
        penalty_scaling=100.0, reset_duals=False,
        iterations_linesearch=ls, early_exact_tol=1e-3)
    noise = torch.as_tensor(rng.standard_normal((T, B, N_STATE)),
                            dtype=dtype, device=device)
    return FlagshipSetup(prob_mpc, opts, X_track, U_track, noise)


def run_steps(setup: FlagshipSetup, B: int, T: int):
    """Cold ``init_carry`` then T warm steps; returns the per-step
    MPCResults."""
    step, init_carry = make_mpc_step(setup.prob_mpc, setup.opts,
                                     setup.X_track, setup.U_track)
    carry = init_carry(B)
    outs = []
    for t in range(T):
        carry, out = step(carry, setup.noise[t], t)
        outs.append(out)
    return outs


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip()


def run_flagship(B: int = 1024, T: int = 100, device="cuda",
                 ls: int = 2) -> dict:
    """Throughput and latency of the flagship MPC loop, in float32 on
    ``device``.

    One cold batched solve builds the initial carry; one warm-up step runs;
    three throughput passes of T steps each start from the same carry and
    are timed whole (median reported); a latency pass times min(T, 10)
    single steps. ``loop_iterations`` counts the solver-loop
    passes over every solve that ran (the batch loop runs while any lane is
    live, so a solve's passes are its lanes' maximum iteration count);
    ``cold_solves`` counts solves that began with an open-loop rollout.
    """
    dev = torch.device(device)
    sync = (torch.cuda.synchronize if dev.type == "cuda" else (lambda: None))
    setup = flagship_setup(B, T, dtype=torch.float32, device=dev, ls=ls)
    step, _ = make_mpc_step(setup.prob_mpc, setup.opts, setup.X_track,
                            setup.U_track)
    iters_all = []

    t0 = time.perf_counter()
    # the cold batched solve of init_carry, kept whole to read its stats
    x0 = setup.prob_mpc.x0.expand(B, N_STATE).contiguous()
    sol0 = solve(dataclasses.replace(setup.prob_mpc, x0=x0), setup.opts)
    carry0 = (x0, sol0.X, sol0.U, sol0.duals)
    iters_all.append(sol0.stats.iterations)
    sync()
    init_s = time.perf_counter() - t0

    _, out = step(carry0, setup.noise[0], 0)            # warm-up
    iters_all.append(out.iters)
    sync()

    walls = []
    for _ in range(3):
        carry = carry0
        outs = []
        sync()
        ts = time.perf_counter()
        for t in range(T):
            carry, out = step(carry, setup.noise[t], t)
            outs.append(out)
        sync()
        walls.append(time.perf_counter() - ts)
        iters_all += [o.iters for o in outs]

    step_ms = []
    carry = carry0
    for t in range(min(T, 10)):
        ts = time.perf_counter()
        carry, out = step(carry, setup.noise[t], t)
        sync()
        step_ms.append((time.perf_counter() - ts) * 1e3)
        iters_all.append(out.iters)

    status = torch.stack([o.status for o in outs]).float()
    viol = torch.stack([o.viol for o in outs])
    iters = torch.stack([o.iters for o in outs]).float()
    wall = float(np.median(walls))
    p50, p99 = np.percentile(step_ms, [50, 99])
    return {
        "B": B, "T": T, "device": str(dev),
        "solves_per_s": B * T / wall,
        "wall_s": walls,
        "init_s": init_s,
        "step_ms_p50": float(p50), "step_ms_p99": float(p99),
        "success_rate": float(status.mean()),
        "max_viol": float(viol.max()),
        "mean_iters": float(iters.mean()),
        "loop_iterations": int(sum(int(i.max()) for i in iters_all)),
        "cold_solves": 1,
    }


def main():
    if not torch.cuda.is_available():
        raise SystemExit("the flagship benchmark measures a CUDA device; "
                         "none is available")
    B = int(os.environ.get("BENCH_BATCH", 1024))
    T = int(os.environ.get("BENCH_STEPS", 100))
    ls = int(os.environ.get("BENCH_LS", 2))
    res = run_flagship(B=B, T=T, device="cuda", ls=ls)
    print(json.dumps({
        "metric": "mpc_solves_per_s_chip_N30",
        "value": round(res["solves_per_s"], 1),
        "unit": "solves/s",
        "vs_baseline": round(res["solves_per_s"] / baseline_solves_per_s(), 2),
    }))
    print(f"# {power_limit()} B={B} T={T} success_rate="
          f"{res['success_rate']:.4f} max_viol={res['max_viol']:.2e} "
          f"mean_iters={res['mean_iters']:.2f} step_ms_p50="
          f"{res['step_ms_p50']:.2f} p99={res['step_ms_p99']:.2f}",
          file=sys.stderr)


if __name__ == "__main__":
    main()
