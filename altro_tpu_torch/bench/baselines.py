"""The three ADMM baselines on the card against the port on the CPU, and
where their time goes.

    python -m altro_tpu_torch.bench.baselines

Four float64 instances, each built on the card and copied to the CPU, so
both sides solve identical data:

- ``random_linear_qp``: the random-linear MPC QP (n=12, m=6, N=31, seed 1;
  ``admm_qp``, eps_abs 1e-6, eps_rel 1e-9, the random-linear driver's);
- ``rocket_conic``: the rocket's MPC window (N=21 of the cold N=301
  solve, three SOC blocks; ``admm_conic``, eps_abs 1e-9, the rocket
  driver's);
- ``quadruped_qp_knot`` and ``quadruped_socp_knot``: the quadruped's MPC
  problem at t = 0.05 s with two legs about to swing, in knot form
  (``knot_admm`` from its closed-loop workspace, refactored; eps_abs 1e-4,
  the closed loop's).

Each is solved on the CPU (eager), on the card eagerly and on the card on
CUDA graphs (``solver/admm_loop.py``; the first graphed solve captures,
the next ones are timed). :func:`check` gates: equal status, iterations
within one CHUNK of the CPU's, max|x_card - x_cpu| <= 10 eps_abs, and
graphed equal to eager in status and iterations. Per instance it prints
the ms per solve of each form (graphed: the median of REPEATS solves, each
fenced by a device synchronise; eager: one solve), the chunks (host syncs)
per solve and, from one profiled replay of the chunk graph, its device ms
and kernel launches per chunk. The last line is the result as JSON.
Imports nothing of JAX.
"""
from __future__ import annotations

import json
import time

import numpy as np
import torch

from ..convert import tree_to
from ..mpc import gen_tracking_mpc, one_scenario
from ..solver import admm_conic, admm_qp, graph, knot_admm
from ..solver.options import SolverOptions
from ..transcribe import to_batch_conic, to_batch_qp

REPEATS = 5


def rocket_window(device, dtype=torch.float64):
    """The rocket's MPC window (N=21, one scenario) of the cold N=301 solve,
    and the cold solve's (X, U), the window's tracking reference."""
    from ..models import rocket
    N = 301
    prob = rocket.rocket_problem(N=N, tf=(N - 1) * 0.05, dtype=dtype,
                                 device=device)
    cold = graph.solve(one_scenario(prob),
                       SolverOptions(cost_tolerance=1e-6,
                                     gradient_tolerance=1e-8,
                                     constraint_tolerance=1e-5,
                                     penalty_initial=1e-2,
                                     penalty_scaling=500.0,
                                     iterations_outer=40,
                                     iterations_inner=100),
                       U0=rocket.hover_controls(prob)[None])
    pm = gen_tracking_mpc(prob, cold.X[0], cold.U[0], 21, dt=0.05)
    return one_scenario(pm), cold.X[0], cold.U[0]


def quadruped_instance(lin: bool, device, dtype=torch.float64):
    """The quadruped's MPC problem linearized at t = 0.05 s of the trot
    from a perturbed stance (one lane), and its closed loop's knot-ADMM
    workspace."""
    from ..models.quadruped import config, controller, gait, planner
    cfg = config.MPCConfig(linearized_friction=lin)
    g = gait.GAITS[cfg.gait_type](cfg.stance_time, cfg.swing_time).to(device)
    prob, x_des = controller.build_mpc_problem(cfg, dtype, device)
    kw = dict(dtype=dtype, device=device)
    x_curr = x_des + torch.tensor(
        np.random.default_rng(3).standard_normal(12), **kw) * 0.01
    x_ref = x_des.expand(cfg.N, 12)
    feet = planner.nominal_foot_locations(**kw) + x_des[0:3][None, :]
    contacts, foot_locs, _ = planner.foot_history(
        torch.tensor(0.05, **kw), x_ref, feet, feet, g, x_des, cfg.N,
        cfg.dynamics_discretization)
    prob_k = controller._linearized_problem(
        prob, x_curr[None], x_ref, contacts, foot_locs,
        cfg.dynamics_discretization)
    work = controller.make_baseline_state("admm_qp", prob, cfg, x_des, dtype,
                                          native=False)
    return prob_k, work


def instances(device="cuda", dtype=torch.float64) -> dict:
    """name -> (solver module, setup(device) -> workspace, solve kwargs)."""
    from ..models import random_linear as rl

    rng = np.random.default_rng(1)
    prob = rl.gen_random_linear(rng, 12, 6, 40, dtype=dtype, device=device)
    X, U = rl.gen_trajectory(rng, prob, 40)
    pm = rl.gen_tracking_mpc(prob, X, U, 31)
    qp = to_batch_qp(one_scenario(pm))
    conic = to_batch_conic(rocket_window(device, dtype)[0])
    out = {
        "random_linear_qp": (admm_qp, lambda dev: admm_qp.setup(
            tree_to(qp, dev)), dict(eps_abs=1e-6, eps_rel=1e-9)),
        "rocket_conic": (admm_conic, lambda dev: admm_conic.setup(
            tree_to(conic, dev)), dict(eps_abs=1e-9, max_iter=50000)),
    }
    for lin, name in ((True, "quadruped_qp_knot"),
                      (False, "quadruped_socp_knot")):
        prob_k, work = quadruped_instance(lin, device, dtype)
        kqp = knot_admm.to_knot_qp(prob_k)
        out[name] = (knot_admm,
                     lambda dev, w=work, k=kqp: knot_admm.refactor(
                         tree_to(w, dev), tree_to(k, dev)),
                     dict(eps_abs=1e-4))
    return out


def _primal(sol):
    return sol.x if hasattr(sol, "x") else torch.cat(
        [sol.X.flatten(1), sol.U.flatten(1)], dim=1)


def _timed(fn, device, repeats: int):
    ms = []
    for _ in range(repeats):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        sol = fn()
        torch.cuda.synchronize(device)
        ms.append((time.perf_counter() - t0) * 1e3)
    return sol, float(np.median(ms))


def chunk_profile(work) -> dict:
    """Device ms and kernel launches of one replay of ``work``'s chunk
    graph (its only one), from torch.profiler."""
    (loop,) = work.graphs.values()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        loop.chunk.replay()
        torch.cuda.synchronize()
    ms, n = 0.0, 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        ms += (e.self_cuda_time_total if us is None else us) / 1e3
        n += e.count
    if ms == 0.0:
        raise RuntimeError("the profiler recorded no device time")
    return {"device_ms_per_chunk": ms, "launches_per_chunk": n}


def run(device="cuda") -> dict:
    """Solve every instance in the three forms; returns per instance the
    iterations, status, chunks and ms of each form, max|dx| against the
    CPU, the chunk graph's profile and the capture seconds."""
    dev = torch.device(device)
    out = {}
    for name, (mod, make, kw) in instances(dev).items():
        cpu = mod.solve(make("cpu"), graphed=False, **kw)
        work = make(dev)
        eager, eager_ms = _timed(
            lambda: mod.solve(work, graphed=False, **kw), dev, 1)
        t0 = time.perf_counter()
        mod.solve(work, graphed=True, **kw)
        first_s = time.perf_counter() - t0
        graphed, graphed_ms = _timed(
            lambda: mod.solve(work, graphed=True, **kw), dev, REPEATS)
        (loop,) = work.graphs.values()
        row = {"eps_abs": kw["eps_abs"]}
        for form, sol in (("cpu", cpu), ("eager", eager),
                          ("graphed", graphed)):
            row[f"iterations_{form}"] = int(sol.iterations[0])
            row[f"status_{form}"] = int(sol.status[0])
            row[f"chunks_{form}"] = sol.chunks
        row.update(
            ms_eager=eager_ms, ms_graphed=graphed_ms,
            first_graphed_s=first_s, capture_s=loop.capture_s,
            max_dx=float((_primal(graphed).cpu() - _primal(cpu)).abs().max()),
            max_dx_eager=float((_primal(eager).cpu()
                                - _primal(cpu)).abs().max()),
            bit_equal_graphed_eager=bool(torch.equal(_primal(graphed),
                                                     _primal(eager))),
            chunk=getattr(mod, "CHUNK"), **chunk_profile(work))
        out[name] = row
        print(f"{name}: iterations cpu/eager/graphed "
              f"{row['iterations_cpu']}/{row['iterations_eager']}/"
              f"{row['iterations_graphed']}, status "
              f"{row['status_cpu']}/{row['status_eager']}/"
              f"{row['status_graphed']}, chunks {row['chunks_graphed']}; "
              f"ms/solve eager {eager_ms:.3f}, graphed {graphed_ms:.3f} "
              f"(capture {loop.capture_s:.3f} s); per chunk "
              f"{row['device_ms_per_chunk']:.3f} device ms, "
              f"{row['launches_per_chunk']} launches; max|dx| vs CPU "
              f"{row['max_dx']:.3e} (eager {row['max_dx_eager']:.3e}), "
              f"graphed == eager bit for bit: "
              f"{row['bit_equal_graphed_eager']}", flush=True)
    return out


def check(out: dict) -> None:
    """The gates of the module docstring; raises AssertionError."""
    for name, r in out.items():
        if not (r["status_cpu"] == r["status_eager"] == r["status_graphed"]
                == 1):
            raise AssertionError(f"{name}: status {r}")
        if abs(r["iterations_eager"] - r["iterations_cpu"]) > r["chunk"]:
            raise AssertionError(f"{name}: iterations {r}")
        if r["iterations_graphed"] != r["iterations_eager"]:
            raise AssertionError(f"{name}: graphed against eager {r}")
        if not (r["max_dx"] <= 10 * r["eps_abs"]
                and r["max_dx_eager"] <= 10 * r["eps_abs"]):
            raise AssertionError(f"{name}: max|dx| {r}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("the baselines' comparison needs a CUDA device")
    from .flagship import power_limit
    print(f"device: {power_limit()}")
    out = run()
    check(out)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
