"""Quickstart: the five benchmark problems end to end through the port's
public entry points (the counterpart of ``examples/quickstart.py``).

    python -m altro_tpu_torch.examples.quickstart [--fast] [--device cpu]

1. random-linear MPC: warm-started steps of one scenario
   (``make_mpc_step(shared_k=False)`` at B=1, the JAX package's default
   step);
2. the rocket soft landing with SOC cones: the cold N=301 solve;
3. grasp with rotating friction cones: the cold N=61 solve;
4. the flexible satellite regulator: the cold N=80 solve;
5. the quadruped trot: the closed loop (1 s, 0.5 s with ``--fast``).

Problems 1-4 run in float32 (the JAX quickstart's default precision), the
closed loop in float64 (the port's closed loop). Everything runs on the
card unless ``--device cpu``; with no CUDA device and no ``--device cpu``
it stops with an error. Each section prints one line; ``main`` returns the
sections' results.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from .. import solve
from ..models import flexible_satellite as fs
from ..models import grasp, rocket
from ..models import random_linear as rl
from ..mpc import make_mpc_step
from ..solver.options import SolverOptions

DTYPE = torch.float32


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def banner(s: str) -> None:
    print(f"\n=== {s}", flush=True)


def one(prob):
    """``prob`` as a batch of one scenario."""
    return dataclasses.replace(prob, x0=prob.x0[None])


def random_linear_mpc(device="cuda", fast: bool = False) -> dict:
    banner("1. random-linear MPC (benchmark 1)")
    T = 5 if fast else 20
    rng = np.random.default_rng(1)
    prob = rl.gen_random_linear(rng, 12, 6, T + 32, dtype=DTYPE,
                                device=device)
    X_track, U_track = rl.gen_trajectory(rng, prob, T + 32)
    prob_mpc = rl.gen_tracking_mpc(prob, X_track, U_track, 30)
    opts = SolverOptions(penalty_initial=1e3, penalty_scaling=100.0,
                         reset_duals=False)
    step, init_carry = make_mpc_step(prob_mpc, opts, X_track, U_track,
                                     shared_k=False)
    carry = init_carry(1)
    noise = torch.as_tensor(rng.standard_normal((T, 1, 12)), dtype=DTYPE,
                            device=device)
    _sync(device)
    t0 = time.perf_counter()
    for t in range(T):
        carry, out = step(carry, noise[t])
    _sync(device)
    ms = (time.perf_counter() - t0) / T * 1e3
    res = dict(steps=T, ms_per_step=ms, viol=float(out.viol[0]),
               status=int(out.status[0]), k=int(carry[4][0]))
    print(f"{T} warm-started MPC steps, {ms:.2f} ms/step, "
          f"viol={res['viol']:.1e}")
    return res


def rocket_landing(device="cuda", fast: bool = False) -> dict:
    banner("2. rocket soft landing with SOC cones (benchmark 2)")
    N = 301
    rp = rocket.rocket_problem(N=N, tf=(N - 1) * 0.05, dtype=DTYPE,
                               device=device)
    sol = solve(one(rp), SolverOptions(
        constraint_tolerance=1e-5, penalty_initial=1e-2,
        penalty_scaling=500.0, iterations_outer=40, iterations_inner=100),
        U0=rocket.hover_controls(rp)[None])
    U = sol.U[0]
    ang = torch.rad2deg(torch.atan2(torch.linalg.vector_norm(U[:, :2],
                                                             dim=-1),
                                    U[:, 2]))
    res = dict(landed=sol.X[0, -1, :3].tolist(),
               max_angle_deg=float(ang.max()),
               iterations=int(sol.stats.iterations[0]),
               status=int(sol.stats.status[0]))
    print(f"landed at {np.round(res['landed'], 6)}, max thrust angle "
          f"{res['max_angle_deg']:.2f} deg (limit 5), "
          f"{res['iterations']} iterations")
    return res


def grasp_transfer(device="cuda", fast: bool = False) -> dict:
    banner("3. grasp with rotating friction cones (benchmark 3)")
    o = grasp.make_grasp_object(61, 6.0, dtype=DTYPE, device=device)
    gp = grasp.grasp_problem(o, 61, 6.0)
    sol = solve(one(gp), SolverOptions(
        constraint_tolerance=1e-6, penalty_initial=10.0,
        penalty_scaling=10.0, iterations_outer=30),
        U0=grasp.hover_controls(o, 61)[None])
    res = dict(delivered=sol.X[0, -1, :3].tolist(),
               viol=float(sol.stats.viol[0]),
               status=int(sol.stats.status[0]))
    print(f"object delivered to {np.round(res['delivered'], 5)}, "
          f"viol={res['viol']:.1e}")
    return res


def flexsat_regulator(device="cuda", fast: bool = False) -> dict:
    banner("4. flexible satellite regulator (benchmark 4)")
    fp = fs.flexsat_problem(dtype=DTYPE, device=device)
    sol = solve(one(fp), SolverOptions(penalty_initial=100.0,
                                       penalty_scaling=100.0))
    res = dict(iterations=int(sol.stats.iterations[0]),
               max_abs_u=float(sol.U.abs().max()),
               status=int(sol.stats.status[0]))
    print(f"N=80 solve: {res['iterations']} iterations, "
          f"max|u|={res['max_abs_u']:.4f} (bound 0.01)")
    return res


def quadruped_trot(device="cuda", fast: bool = False) -> dict:
    banner("5. quadruped trot (benchmark 5)")
    from ..models.quadruped import config, controller
    cfg = config.MPCConfig()
    out = controller.simulate(
        cfg, SolverOptions(penalty_initial=10.0, penalty_scaling=100.0,
                           reset_duals=False),
        tf=0.5 if fast else 1.0, backend="altro", device=device)
    res = dict(height=float(out["x"][-1, 2]),
               all_ok=bool((out["status"] == 1).all()),
               periods=int(out["status"].numel()))
    print(f"closed-loop trot: height {res['height']:.3f} m (target "
          f"{cfg.stance_height}), all solves ok: {res['all_ok']}")
    return res


SECTIONS = (random_linear_mpc, rocket_landing, grasp_transfer,
            flexsat_regulator, quadruped_trot)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        raise SystemExit("no CUDA device: pass --device cpu")
    return {fn.__name__: fn(args.device, args.fast) for fn in SECTIONS}


if __name__ == "__main__":
    main()
