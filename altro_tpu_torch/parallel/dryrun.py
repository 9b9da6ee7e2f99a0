"""The multi-card dry run (the port's counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``): the full sharded MPC programs over
an n-rank scenario mesh, with the JAX dry run's shapes, options and checks.

1. the flagship (n=12, m=6, N_mpc=30, the random-linear tracking MPC of
   ``bench.py``), B = 2 n scenarios sharded, 1% process noise, 3
   warm-started steps: every scenario solves, max violation <= 2e-4, the
   fleet's iteration count >= B;
2. the rocket's SOC window (max-thrust, thrust-angle and glideslope cones;
   cold N=41 solve, an N=13 window) through :func:`sharded_solve`: max
   violation <= 2e-4;
3. the device-compacted step on the same window (cap 1, block 2), each
   rank gathering its stragglers within its own slice: every status 1.

Run: ``python -m altro_tpu_torch.parallel.dryrun [n] [--device cpu]``
(n ranks, one card each; ``--device cpu``: gloo ranks on the CPU).
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..models import random_linear as rl
from ..models import rocket
from ..mpc import gen_tracking_mpc
from ..ops import riccati, riccati_fused, rollout, rollout_al
from ..solver import altro, graph
from ..solver.options import SolverOptions
from .sharding import (ScenarioMesh, _fleet, launch, run_compacted_steps,
                       run_sharded_mpc, sharded_solve)

T_STEPS = 3
DTYPE = torch.float32
FLAG_OPTS = dict(cost_tolerance=1e-4, gradient_tolerance=1e-4,
                 constraint_tolerance=1e-4, penalty_initial=1e3,
                 penalty_scaling=100.0, reset_duals=False)
ROCKET_N, ROCKET_WINDOW, ROCKET_DT = 41, 13, 0.05
ROCKET_COLD_OPTS = dict(cost_tolerance=1e-5, gradient_tolerance=1e-6,
                        constraint_tolerance=1e-4, penalty_initial=1e-2,
                        penalty_scaling=500.0, iterations_outer=40,
                        iterations_inner=100)
ROCKET_OPTS = dict(cost_tolerance=1e-5, gradient_tolerance=1e-6,
                   constraint_tolerance=1e-4, penalty_initial=1e2,
                   penalty_scaling=10.0, reset_duals=False,
                   iterations_outer=15, iterations_inner=8, reg_min=1.0,
                   early_exact_tol=1e-3)
COUNTERS = ((rollout, "batched_ls_rollout"),
            (riccati_fused, "fused_expand_backward"),
            (rollout_al, "batched_ls_rollout_al"),
            (riccati, "batched_riccati"))


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def _flagship(device, n=12, m=6, N_track=64, N_mpc=30, seed=0):
    rng = np.random.default_rng(seed)
    prob = rl.gen_random_linear(rng, n, m, N_track, dtype=DTYPE,
                                device=device)
    X_track, U_track = rl.gen_trajectory(rng, prob, N_track)
    prob_mpc = rl.gen_tracking_mpc(prob, X_track, U_track, N_mpc)
    return prob_mpc, X_track, U_track


def dryrun_rank(*, mesh: ScenarioMesh) -> dict:
    """This rank's part of the dry run's three programs (module
    docstring); raises if a check fails. Returns the fleet's metrics, this
    rank's kernel launches and solver-loop passes over the three
    programs."""
    dev = mesh.device
    launches0 = {name: getattr(mod, "launch_count") for mod, name in COUNTERS}
    passes0 = altro.pass_count
    dtype = DTYPE
    prob_mpc, X_track, U_track = _flagship(dev)
    n = prob_mpc.n
    B = 2 * mesh.size
    rng = np.random.default_rng(0)
    x0s = (prob_mpc.x0[None]
           + 0.01 * torch.as_tensor(rng.standard_normal((B, n)), dtype=dtype,
                                    device=dev))
    noise = torch.as_tensor(rng.standard_normal((T_STEPS, B, n)),
                            dtype=dtype)
    run = run_sharded_mpc(prob_mpc, SolverOptions(**FLAG_OPTS), X_track,
                          U_track, x0s, noise, mesh=mesh)
    total_iters, max_viol, n_success = run["metrics"][-1]
    _check(int(n_success) == B, f"only {int(n_success)}/{B} scenarios solved")
    _check(float(max_viol) <= 2e-4, f"max_viol {float(max_viol):.2e} > 2e-4")
    _check(int(total_iters) >= B, "the fleet's iteration count is "
           "implausibly small")
    out = {"flagship": {"B": B, "total_iters": int(total_iters),
                        "max_viol": float(max_viol),
                        "n_success": int(n_success)}}
    if mesh.rank == 0:
        print(f"dryrun_multichip({mesh.size}): ok - {B} scenarios x "
              f"{T_STEPS} steps at n=12/m=6/N=30, {int(total_iters)} fleet "
              f"iters (last step), max_viol={float(max_viol):.2e}",
              flush=True)

    # ---- 2. the rocket's SOC window sharded over the mesh
    probr = rocket.rocket_problem(ROCKET_N, tf=(ROCKET_N - 1) * ROCKET_DT,
                                  dtype=dtype, device=dev)
    probr = dataclasses.replace(probr, x0=probr.x0 / 6.0)
    cold = graph.solve(dataclasses.replace(probr, x0=probr.x0[None]),
                       SolverOptions(**ROCKET_COLD_OPTS))
    _check(int(cold.stats.status[0]) == 1, "the rocket's cold solve failed")
    Xc, Uc = cold.X[0], cold.U[0]
    pmr = gen_tracking_mpc(probr, Xc, Uc, ROCKET_WINDOW, dt=ROCKET_DT)
    opts_r = SolverOptions(**ROCKET_OPTS)
    x0r = pmr.x0[None] + 0.02 * torch.as_tensor(
        rng.standard_normal((B, pmr.n)), dtype=dtype, device=dev)
    _, _, viol_soc = sharded_solve(pmr, opts_r, x0r, mesh)
    _check(float(viol_soc) <= 2e-4, f"SOC max_viol {float(viol_soc):.2e}")
    out["rocket_max_viol"] = float(viol_soc)
    if mesh.rank == 0:
        print(f"dryrun_multichip({mesh.size}): ok - rocket SOC window "
              f"(3 cones) sharded solve, B={B}, "
              f"max_viol={float(viol_soc):.2e}", flush=True)

    # ---- 3. the device-compacted SOC step, gathering within each rank
    noise_r = torch.as_tensor(rng.standard_normal((1, B, pmr.n)),
                              dtype=dtype)
    res = run_compacted_steps(pmr, opts_r, Xc, Uc, noise_r, mesh=mesh,
                              it_cap=1, block=2)[0]
    _, viol_c, n_ok = _fleet(mesh, res.iters, res.viol, res.status)
    _check(int(n_ok) == B, f"the compacted sharded step solved "
           f"{int(n_ok)}/{B}")
    out["compacted"] = {"n_success": int(n_ok), "max_viol": float(viol_c)}
    if mesh.rank == 0:
        print(f"dryrun_multichip({mesh.size}): ok - device-compacted SOC "
              f"step (per-rank gather/scatter), B={B}, "
              f"max_viol={float(viol_c):.2e}", flush=True)
    out["launches"] = {name: getattr(mod, "launch_count") - launches0[name]
                       for mod, name in COUNTERS}
    out["passes"] = altro.pass_count - passes0
    return out


def dryrun_multichip(n_devices: int, device: str = "cuda") -> list:
    """Run the dry run's three programs over ``n_devices`` spawned ranks
    (one card each on ``device`` "cuda", NCCL; gloo ranks on "cpu"); raises
    if any check fails on any rank. Returns each rank's
    :func:`dryrun_rank` result."""
    return [r[0] for r in launch([(dryrun_rank,)], n_devices, device)]


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("n_devices", type=int, nargs="?", default=None)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args()
    n = args.n_devices
    if n is None:
        n = torch.cuda.device_count() if args.device == "cuda" else 2
    dryrun_multichip(n, args.device)


if __name__ == "__main__":
    main()
