"""Benchmark sweep drivers (the port's counterpart of
``altro_tpu/bench/drivers.py``), the reference's experiment scripts:

- random-linear horizon / state-dim / control-dim sweeps
  (run_random_linear.jl:109-173);
- the rocket tolerance sweep (run_simple_rocket.jl:118-206);
- the grasp horizon sweep (grasp_benchmark.jl:16-172);
- the flexible satellite's per-step timing (flexible_sat_mpc.jl:242-308);
- the quadruped's four-configuration table (quadruped_benchmark.jl:1-55).

    python -m altro_tpu_torch.bench.drivers <name> [--device cpu] [--out D]
        [--tf S] [--fig]

Each sweep runs the warm-started ALTRO MPC loop of one scenario, timing
every step as the reference times every solve, and solves the same
instances with the in-framework ADMM baseline in lockstep (``host_lockstep``:
the dense QP or conic ADMM set up once, or, under time-varying
constraints, the knot-structured ADMM set up once and refactored per
step), recording their inf-norm agreement. On a CUDA device both sides run
on CUDA graphs (ALTRO's step as start, loop and finish graphs; the ADMM's
chunks) and every timed section ends in a device synchronise. The dtypes
are the JAX package's: random-linear in float64 on the CPU and float32 on
the card, everything else in float64. The port's kernels take n, m <= 32
(``ops.rollout.MAX_DIM``): on the card a sweep point beyond that is
recorded under ``not_run`` with the reason and never solved by the plain
version.

``rocket_multibaseline`` and ``grasp_multibaseline`` (the JAX package's
four-solver studies, whose truth solves are its native C++ oracle) raise
NotImplementedError: they come with the port's C++-oracle slice.

Results go to ``<out>/<name>.json`` with the device (name and power limit)
beside them; ``--fig`` also draws the figures with matplotlib (not
installed on every machine, so it is imported only then).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, List

import numpy as np
import torch

from ..models.quadruped import config, controller
from ..mpc import (default_noise_model, gen_tracking_mpc, lockstep_steps,
                   make_regulator_step, one_scenario)
from ..ops import riccati, riccati_fused, rollout, rollout_al
from ..solver import admm_conic, admm_qp, altro, graph, knot_admm
from ..solver.options import SolverOptions
from ..transcribe import (extract_traj, qp_set_x0, to_batch_conic,
                          to_batch_qp)
from .flagship import power_limit
from .harness import comparison_plot, save_results

QUAD_OPTS = dict(cost_tolerance=1e-4, constraint_tolerance=1e-4,
                 penalty_initial=10.0, penalty_scaling=100.0,
                 reset_duals=False)
CPP_SLICE = ("its truth solves are the JAX package's native C++ oracle, "
             "which comes with the port's C++-oracle slice (not ported yet)")


def _counts() -> dict:
    return {"batched_ls_rollout": rollout.launch_count,
            "fused_expand_backward": riccati_fused.launch_count,
            "batched_ls_rollout_al": rollout_al.launch_count,
            "batched_riccati": riccati.launch_count,
            "passes": altro.pass_count}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def host_lockstep(prob_mpc, opts, X_track, U_track, noise, *, conic=False,
                  baseline_eps=1e-6, baseline_eps_rel=None, noise_model=None,
                  constraints_fn=None):
    """The warm-started MPC loop of one scenario with per-step timing and a
    lockstep ADMM baseline on the identical instances
    (``mpc.lockstep_steps`` with its warm-up run); ``noise`` [T, n].

    The baseline warm-starts from its previous solution (the reference
    warm-starts OSQP/COSMO; the first from the warm-up run's); with fixed
    constraints its scalings and factor are set up once (OSQP's setup-once
    + update!), with time-varying ones (``constraints_fn``) the knot ADMM
    refactors its band per step. Returns lists altro_ms, baseline_ms,
    err_X, err_U, iters [T, 2], status [T, 2], cost_altro, cost_baseline
    (both solutions under the instance's cost), baseline_dyn_viol and
    baseline_chunks."""
    pm = one_scenario(prob_mpc)
    if constraints_fn is not None:
        kwork0 = knot_admm.setup(knot_admm.to_knot_qp(pm))

        def baseline(prob_k):
            sol = knot_admm.solve(
                knot_admm.refactor(kwork0, knot_admm.to_knot_qp(prob_k)),
                eps_abs=baseline_eps, eps_rel=baseline_eps_rel,
                max_iter=20000)
            return sol.X, sol.U, sol.iterations, sol.status, sol.chunks
    else:
        mod, build = ((admm_conic, to_batch_conic) if conic
                      else (admm_qp, to_batch_qp))
        work0 = mod.setup(build(pm))
        field = "prob" if conic else "qp"
        warm = [None, None]

        def baseline(prob_k):
            data = build(prob_k)
            sol = mod.solve(dataclasses.replace(work0, **{field: data}),
                            x0=warm[0], y0=warm[1], eps_abs=baseline_eps,
                            eps_rel=baseline_eps_rel)
            warm[:] = [sol.x, sol.y]
            return extract_traj(data, sol.x) + (sol.iterations, sol.status,
                                                sol.chunks)

    def dyn_viol(p, X, U):
        # inf-norm dynamics violation (dynamics_violation,
        # simple_rocket.jl:208-216)
        dyn = p.dynamics
        A = dyn.A if dyn.A.dim() == 3 else dyn.A[0]
        Bm = dyn.B if dyn.B.dim() == 3 else dyn.B[0]
        d = dyn.d if dyn.d.dim() == 2 else dyn.d[0]
        X_next = (torch.einsum("kij,kj->ki", A, X[:-1])
                  + torch.einsum("kij,kj->ki", Bm, U) + d)
        return float(torch.amax(torch.abs(X_next - X[1:])))

    rows = dict(altro_ms=[], baseline_ms=[], err_X=[], err_U=[], iters=[],
                status=[], cost_altro=[], cost_baseline=[],
                baseline_dyn_viol=[], baseline_chunks=[])
    for p_k, out, (Xb, Ub, bit, bst, chunks), a_ms, b_ms in lockstep_steps(
            pm, opts, X_track, U_track, noise,
            noise_model or default_noise_model, constraints_fn, baseline,
            warmup=True):
        rows["altro_ms"].append(a_ms)
        rows["baseline_ms"].append(b_ms)
        rows["err_X"].append(float(torch.amax(torch.abs(out.X - Xb))))
        rows["err_U"].append(float(torch.amax(torch.abs(out.U - Ub))))
        rows["iters"].append([int(out.iters[0]), int(bit[0])])
        rows["status"].append([int(out.status[0]), int(bst[0])])
        # the cost-parity oracle: both solutions under one cost
        # (rocket_landing_problem.jl:193-209, simple_rocket.jl:194-203)
        rows["cost_altro"].append(float(p_k.cost.total(out.X[0], out.U[0])))
        rows["cost_baseline"].append(float(p_k.cost.total(Xb[0], Ub[0])))
        rows["baseline_dyn_viol"].append(dyn_viol(p_k, Xb[0], Ub[0]))
        rows["baseline_chunks"].append(chunks)
    return rows


def _summary(rows) -> str:
    it = np.asarray(rows["iters"])
    return (f"ALTRO {np.mean(rows['altro_ms']):.3f} ms/step "
            f"({it[:, 0].mean():.2f} iters), baseline "
            f"{np.mean(rows['baseline_ms']):.3f} ms/step "
            f"({it[:, 1].mean():.1f} iters, "
            f"{np.mean(rows['baseline_chunks']):.2f} chunks), "
            f"err_U={max(rows['err_U']):.2e}")


# ---------------------------------------------------------------------------
# Random linear sweeps
# ---------------------------------------------------------------------------

def _default_dtype(device):
    return (torch.float64 if torch.device(device).type == "cpu"
            else torch.float32)


def random_linear_sweep(kind: str = "horizon", T: int = 50, dtype=None,
                        xs=None, device="cuda"):
    """kind in {horizon, state_dim, control_dim}
    (run_random_linear.jl:109-156)."""
    from ..models import random_linear as rl

    dtype = dtype or _default_dtype(device)
    sweeps = {
        "horizon": dict(xs=[11, 31, 51, 71, 101],
                        cfg=lambda x: (12, 6, x), seed=1,
                        xlabel="MPC horizon N"),
        "state_dim": dict(xs=[2, 15, 25, 35, 45, 55],
                          cfg=lambda x: (x, 2, 21), seed=10,
                          xlabel="state dimension n"),
        "control_dim": dict(xs=[2, 6, 10, 15, 20, 25],
                            cfg=lambda x: (30, x, 21), seed=15,
                            xlabel="control dimension m"),
    }[kind]
    opts = SolverOptions(cost_tolerance=1e-4, constraint_tolerance=1e-4,
                         gradient_tolerance=1e-4, penalty_initial=1e3,
                         penalty_scaling=100.0, reset_duals=False)

    times: Dict[str, Dict[float, List[float]]] = {"ALTRO": {}, "ADMM-QP": {}}
    errs, not_run = {}, {}
    for x in (xs if xs is not None else sweeps["xs"]):
        n, m, N_mpc = sweeps["cfg"](x)
        if (torch.device(device).type == "cuda"
                and max(n, m) > rollout.MAX_DIM):
            not_run[x] = (f"n={n}, m={m}: the kernels take n, m <= "
                          f"{rollout.MAX_DIM}")
            print(f"  {sweeps['xlabel']}={x}: not run ({not_run[x]})",
                  flush=True)
            continue
        rng = np.random.default_rng(sweeps["seed"])
        N_track = N_mpc + T + 2
        prob = rl.gen_random_linear(rng, n, m, N_track, dtype=dtype,
                                    device=device)
        X_track, U_track = rl.gen_trajectory(rng, prob, N_track)
        prob_mpc = rl.gen_tracking_mpc(prob, X_track, U_track, N_mpc)
        noise = torch.tensor(rng.standard_normal((T, n)), dtype=dtype,
                             device=device)
        # float32 cannot reach 1e-6 absolute residuals; use the reference's
        # own OSQP tolerance there (eps_abs = eps_rel = 1e-4)
        tight = dtype == torch.float64
        rows = host_lockstep(prob_mpc, opts, X_track, U_track, noise,
                             baseline_eps=1e-6 if tight else 1e-4,
                             baseline_eps_rel=1e-9 if tight else 1e-4)
        times["ALTRO"][x] = rows["altro_ms"]
        times["ADMM-QP"][x] = rows["baseline_ms"]
        errs[x] = dict(err_X=max(rows["err_X"]), err_U=max(rows["err_U"]),
                       success=float(np.mean([s[0] for s in rows["status"]])))
        print(f"  {sweeps['xlabel']}={x}: {_summary(rows)}", flush=True)
    out = dict(kind=kind, xlabel=sweeps["xlabel"], times=times, errs=errs)
    if not_run:
        out["not_run"] = not_run
    return out


# ---------------------------------------------------------------------------
# Rocket tolerance sweep
# ---------------------------------------------------------------------------

def _cold(prob, opts, U0):
    """The long-horizon cold solve of one scenario (on graphs on a CUDA
    device)."""
    return graph.solve(one_scenario(prob), opts, U0=U0[None])


def rocket_tol_sweep(tols=(1e-2, 1e-4, 1e-6, 1e-8), T: int = 20,
                     N_mpc: int = 21, dtype=torch.float64, device="cuda"):
    """Trajectory error and timing against the solver tolerance
    (run_simple_rocket.jl:146-206 / figures/rocket_solver_tol.tikz)."""
    from ..models import rocket

    N = 301
    prob = rocket.rocket_problem(N=N, tf=(N - 1) * 0.05, dtype=dtype,
                                 device=device)
    cold = _cold(prob, SolverOptions(
        cost_tolerance=1e-6, gradient_tolerance=1e-8,
        constraint_tolerance=1e-5, penalty_initial=1e-2,
        penalty_scaling=500.0, iterations_outer=40, iterations_inner=100),
        rocket.hover_controls(prob))
    Xc, Uc = cold.X[0], cold.U[0]
    prob_mpc = gen_tracking_mpc(prob, Xc, Uc, N_mpc, dt=0.05)
    rng = np.random.default_rng(1)
    noise = torch.tensor(rng.standard_normal((T, 6)), dtype=dtype,
                         device=device)

    out = []
    for tol in tols:
        opts = SolverOptions(cost_tolerance=tol, gradient_tolerance=tol * 1e-2,
                             constraint_tolerance=tol, penalty_initial=1e3,
                             penalty_scaling=10.0, reset_duals=False,
                             iterations_outer=40)
        rows = host_lockstep(prob_mpc, opts, Xc, Uc, noise, conic=True,
                             baseline_eps=1e-9,
                             noise_model=rocket.rocket_noise_model())
        out.append(dict(tol=tol, err_X=max(rows["err_X"]),
                        err_U=max(rows["err_U"]),
                        altro_ms=float(np.mean(rows["altro_ms"])),
                        baseline_ms=float(np.mean(rows["baseline_ms"])),
                        iters=float(np.mean([i[0] for i in rows["iters"]])),
                        success=float(np.mean([s[0] for s in
                                               rows["status"]])),
                        baseline_success=float(np.mean([s[1] for s in
                                                        rows["status"]]))))
        print(f"  tol={tol:g}: {_summary(rows)}", flush=True)
    return dict(rows=out, cold_iterations=int(cold.stats.iterations[0]))


def rocket_multibaseline_tol(*args, **kwargs):
    """The JAX package's four-solver rocket tolerance study: not ported."""
    raise NotImplementedError(f"rocket_multibaseline: {CPP_SLICE}")


# ---------------------------------------------------------------------------
# Grasp horizon sweep
# ---------------------------------------------------------------------------

def grasp_horizon_sweep(Ns=(11, 21, 31, 41, 51), T: int = 15,
                        dtype=torch.float64, device="cuda"):
    """(grasp_benchmark.jl:16-172): the knot ADMM is the baseline, as the
    contact frames rotate every step."""
    from ..models import grasp

    # the reference's cold solve: N=251 knots over the same 6 s
    # (grasp_benchmark.jl:72 "GraspProblem(o,251)" with the tf=6.0 default)
    N, tf = 251, 6.0
    o = grasp.make_grasp_object(N, tf, dtype=dtype, device=device)
    prob = grasp.grasp_problem(o, N, tf)
    cold = _cold(prob, SolverOptions(
        cost_tolerance=1e-6, gradient_tolerance=1e-8,
        constraint_tolerance=1e-6, penalty_initial=10.0, penalty_scaling=10.0,
        iterations_outer=30, iterations_inner=50), grasp.hover_controls(o, N))
    Xc, Uc = cold.X[0], cold.U[0]
    opts = SolverOptions(cost_tolerance=1e-4, constraint_tolerance=1e-4,
                         penalty_initial=1e4, penalty_scaling=100.0,
                         reset_duals=False)

    times = {"ALTRO": {}, "ADMM-Conic": {}}
    errs = {}
    rng = np.random.default_rng(0)
    for N_mpc in Ns:
        prob_mpc = gen_tracking_mpc(prob, Xc, Uc, N_mpc, Qk=1e3, Rk=1.0,
                                    Qfk=10.0, dt=tf / (N - 1))
        prob_mpc = dataclasses.replace(
            prob_mpc, constraints=grasp.grasp_constraints(o, N_mpc, 0))
        noise = torch.tensor(rng.standard_normal((T, 6)), dtype=dtype,
                             device=device)
        rows = host_lockstep(
            prob_mpc, opts, Xc, Uc, noise, conic=True, baseline_eps=1e-7,
            constraints_fn=lambda k, N_mpc=N_mpc: grasp.grasp_constraints(
                o, N_mpc, k))
        times["ALTRO"][N_mpc] = rows["altro_ms"]
        times["ADMM-Conic"][N_mpc] = rows["baseline_ms"]
        # the cost-parity gap puts err_U in context: at tolerance 1e-4 with
        # the N=251 reference's fine dt the control curvature R dt is small
        cost_gap = max(abs(a - b) / max(abs(a), 1.0)
                       for a, b in zip(rows["cost_altro"],
                                       rows["cost_baseline"]))
        errs[N_mpc] = dict(err_U=max(rows["err_U"]),
                           cost_parity_gap=cost_gap,
                           success=float(np.mean([s[0] for s in
                                                  rows["status"]])))
        print(f"  N={N_mpc}: {_summary(rows)}, cost_gap={cost_gap:.2e}",
              flush=True)
    return dict(times=times, errs=errs, xlabel="MPC horizon N")


def grasp_multibaseline_tol(*args, **kwargs):
    """The JAX package's four-solver grasp tolerance study: not ported."""
    raise NotImplementedError(f"grasp_multibaseline: {CPP_SLICE}")


# ---------------------------------------------------------------------------
# Flexible satellite
# ---------------------------------------------------------------------------

def flexsat_benchmark(T: int = 45, trials: int = 10, dtype=torch.float64,
                      device="cuda"):
    """(flexible_sat_mpc.jl:242-308): per-step solve times of the regulator
    loop (no shifting) for both solvers: ALTRO's regulator step
    (``mpc.make_regulator_step``, one scenario) and the dense ADMM QP from
    the propagated x0, cold, with the factor set up once."""
    from ..models import flexible_satellite as fs

    prob = fs.flexsat_problem(dtype=dtype, device=device)
    opts = SolverOptions(cost_tolerance=1e-4, constraint_tolerance=1e-4,
                         penalty_initial=100.0, penalty_scaling=100.0)
    step, init_carry = make_regulator_step(prob, opts)
    sol0 = graph.solve(one_scenario(prob), opts)
    work0 = admm_qp.setup(to_batch_qp(one_scenario(prob)))

    def qstep(x0):
        sol = admm_qp.solve(dataclasses.replace(
            work0, qp=qp_set_x0(work0.qp, x0)), eps_abs=1e-4)
        return sol.iterations, sol.status

    # capture and warm-up, outside the timed loop
    step(init_carry(1, sol0=sol0),
         torch.zeros((1, prob.n), dtype=dtype, device=device), 0)
    qstep(prob.x0[None])
    altro_mat = np.zeros((T, trials))
    osqp_mat = np.zeros((T, trials))
    altro_ok = np.zeros((T, trials))
    osqp_ok = np.zeros((T, trials))
    for trial in range(trials):
        rng = np.random.default_rng(trial)
        carry = init_carry(1, sol0=sol0)
        for t in range(T):
            nz = torch.tensor(rng.standard_normal(prob.n), dtype=dtype,
                              device=device)[None]
            t0 = time.perf_counter()
            carry, out = step(carry, nz, t)
            _sync(device)
            altro_mat[t, trial] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            _, q_st = qstep(carry[0])
            _sync(device)
            osqp_mat[t, trial] = (time.perf_counter() - t0) * 1e3
            altro_ok[t, trial] = int(out.status[0]) == 1
            osqp_ok[t, trial] = int(q_st[0]) == 1
        print(f"  trial {trial}: altro median "
              f"{np.median(altro_mat[:, trial]):.3f} ms, qp "
              f"{np.median(osqp_mat[:, trial]):.3f} ms", flush=True)
    return dict(altro_ms=altro_mat.tolist(), qp_ms=osqp_mat.tolist(),
                altro_median_per_step=np.median(altro_mat, axis=1).tolist(),
                qp_median_per_step=np.median(osqp_mat, axis=1).tolist(),
                altro_success=float(altro_ok.mean()),
                qp_success=float(osqp_ok.mean()))


# ---------------------------------------------------------------------------
# Quadruped
# ---------------------------------------------------------------------------

def quadruped_benchmark(tf: float = 2.0, dtype=torch.float64,
                        device="cuda") -> dict:
    """The reference's quadruped table (quadruped_benchmark.jl): the
    closed-loop trot of ``tf`` seconds on the single-rigid-body plant,
    timing each MPC period in three fenced sections
    (``controller.simulate_host``): the solve alone (``ms_per_solve``, the
    reference table's accounting), the schedule and relinearization
    (``ms_prep``) and the period's 1 kHz ticks (``ms_per_period_sim``).
    Rows ALTRO-QP and OSQP-role (linearized friction pyramids; ALTRO and
    the knot ADMM), ALTRO-SOCP and ECOS-role (friction cones), with the
    keys of the JAX package's rows, plus ``launches`` (kernel launches and
    ALTRO loop passes of the row's run, the warm-up period's included),
    ``loop_replays``, ``admm_chunks``, ``capture_s``, ``tick_ms``,
    ``periods``, ``final_height`` (m) and ``max_roll_pitch`` (the largest
    |MRP roll or pitch component| over the periods). ``table_md`` is the
    markdown table."""
    opts = SolverOptions(**QUAD_OPTS)
    rows = {}
    for name, lin, backend in (("ALTRO-QP", True, "altro"),
                               ("OSQP-role", True, "admm_qp"),
                               ("ALTRO-SOCP", False, "altro"),
                               ("ECOS-role", False, "admm_conic")):
        cfg = config.MPCConfig(linearized_friction=lin)
        before = _counts()
        res = controller.simulate_host(cfg, opts, tf=tf, backend=backend,
                                       dtype=dtype, device=device)
        launches = {k: v - before[k] for k, v in _counts().items()}
        status = res["status"].cpu().numpy()
        mpc_ms = np.asarray(res["mpc_ms"])
        prep_ms = np.asarray(res["prep_ms"])
        rows[name] = dict(
            ms_per_solve=float(np.mean(mpc_ms)),
            ms_per_solve_std=float(np.std(mpc_ms)),
            ms_prep=float(np.mean(prep_ms)),
            ms_per_solve_total=float(np.mean(mpc_ms) + np.mean(prep_ms)),
            ms_per_period_sim=float(np.mean(res["tick_ms"])),
            mean_iters=float(res["iters"].double().mean()),
            success=float(status.mean()),
            mpc_ms=mpc_ms.tolist(),
            prep_ms=prep_ms.tolist(),
            tick_ms=list(res["tick_ms"]),
            periods=int(status.size),
            capture_s=res["capture_s"],
            loop_replays=res["loop_replays"],
            admm_chunks=res["admm_chunks"],
            launches=launches,
            final_height=float(res["x"][-1, 2]),
            max_roll_pitch=float(res["x"][:, 3:5].abs().max()))
        r = rows[name]
        print(f"  {name}: {r['ms_per_solve']:.3f} ± "
              f"{r['ms_per_solve_std']:.3f} ms/solve "
              f"(+{r['ms_prep']:.3f} prep), {r['ms_per_period_sim']:.3f} ms "
              f"sim per period, {r['mean_iters']:.2f} iters (success "
              f"{r['success']:.2f}); ALTRO loop replays "
              f"{r['loop_replays']}, ADMM chunks {r['admm_chunks']}; "
              f"launches {launches}", flush=True)

    lines = ["| configuration | ms/solve | σ | +prep | success |",
             "|---|---|---|---|---|"]
    for k, v in rows.items():
        lines.append(f"| {k} | {v['ms_per_solve']:.3f} | "
                     f"{v['ms_per_solve_std']:.3f} | {v['ms_prep']:.3f} | "
                     f"{v['success']:.2f} |")
    rows["table_md"] = "\n".join(lines)
    return rows


BENCHMARKS = {
    "random_linear_horizon":
        lambda dev, a: random_linear_sweep("horizon", device=dev),
    "random_linear_state_dim":
        lambda dev, a: random_linear_sweep("state_dim", device=dev),
    "random_linear_control_dim":
        lambda dev, a: random_linear_sweep("control_dim", device=dev),
    "rocket": lambda dev, a: rocket_tol_sweep(device=dev),
    "rocket_multibaseline": lambda dev, a: rocket_multibaseline_tol(),
    "grasp": lambda dev, a: grasp_horizon_sweep(device=dev),
    "grasp_multibaseline": lambda dev, a: grasp_multibaseline_tol(),
    "flexsat": lambda dev, a: flexsat_benchmark(device=dev),
    "quadruped": lambda dev, a: quadruped_benchmark(tf=a.tf, device=dev),
}


# ---------------------------------------------------------------------------
# Figures (the committed-figure parity set: figures/*.tikz analogs)
# ---------------------------------------------------------------------------

def _mpl():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _fig_rocket(res, path):
    """Trajectory error and solve time against the solver tolerance
    (figures/rocket_solver_tol.tikz + rocket_tol_comp.tikz)."""
    plt = _mpl()
    rows = res["rows"]
    tols = [r["tol"] for r in rows]
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(9, 3.6))
    ax1.loglog(tols, [r["err_U"] for r in rows], "o-", color="tab:red",
               label="ALTRO vs conic-ADMM (1e-9)")
    ax1.set_xlabel("ALTRO optimality tolerance")
    ax1.set_ylabel("inf-norm control error")
    ax1.invert_xaxis()
    ax1.grid(True, alpha=0.3)
    ax1.legend(fontsize=8)
    ax2.semilogx(tols, [r["altro_ms"] for r in rows], "o-", color="tab:red",
                 label="ALTRO")
    ax2.semilogx(tols, [r["baseline_ms"] for r in rows], "s-",
                 color="tab:cyan", label="conic ADMM (ECOS role)")
    ax2.set_xlabel("ALTRO optimality tolerance")
    ax2.set_ylabel("time per MPC step (ms)")
    ax2.invert_xaxis()
    ax2.grid(True, alpha=0.3)
    ax2.legend(fontsize=8)
    fig.savefig(path, bbox_inches="tight", dpi=120)
    plt.close(fig)


def _fig_flexsat(res, path):
    """Per-MPC-step solve-time medians (figures/flexible_sat_comp.tikz:
    red ALTRO, blue the OSQP role)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(6, 4))
    a = res["altro_median_per_step"]
    q = res["qp_median_per_step"]
    steps = np.arange(1, len(a) + 1)
    am = np.asarray(res["altro_ms"])      # [T, trials]
    qm = np.asarray(res["qp_ms"])
    for t in range(am.shape[1]):
        ax.plot(steps, am[:, t], color="tab:red", alpha=0.15, lw=0.6)
        ax.plot(steps, qm[:, t], color="tab:blue", alpha=0.15, lw=0.6)
    ax.plot(steps, a, color="tab:red", lw=2, label="ALTRO (median)")
    ax.plot(steps, q, color="tab:blue", lw=2, label="ADMM-QP (median)")
    ax.set_xlabel("MPC step")
    ax.set_ylabel("solve time (ms)")
    ax.set_yscale("log")
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.savefig(path, bbox_inches="tight", dpi=120)
    plt.close(fig)


def _fig_quadruped(res, path):
    """Per-configuration solve-time bars with std whiskers
    (figures/quadruped_times.tikz + plots/table.tex)."""
    plt = _mpl()
    names = [k for k in res if isinstance(res[k], dict)
             and "ms_per_solve" in res[k]]
    means = [res[k]["ms_per_solve"] for k in names]
    stds = [res[k].get("ms_per_solve_std", 0.0) for k in names]
    colors = ["tab:red", "tab:blue", "tab:red", "tab:cyan"]
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.bar(range(len(names)), means, yerr=stds, capsize=4,
           color=colors[:len(names)], alpha=0.8)
    ax.set_xticks(range(len(names)))
    ax.set_xticklabels(names, rotation=15)
    ax.set_ylabel("MPC solve time (ms)")
    ax.grid(True, axis="y", alpha=0.3)
    fig.savefig(path, bbox_inches="tight", dpi=120)
    plt.close(fig)


FIGURES = {"rocket": _fig_rocket, "flexsat": _fig_flexsat,
           "quadruped": _fig_quadruped}


def figures(name: str, res, out: str) -> None:
    """Draw ``name``'s figures into ``out`` (needs matplotlib)."""
    path = os.path.join(out, f"{name}.png")
    if "times" in res:
        times = {s: {float(x): v for x, v in series.items()}
                 for s, series in res["times"].items()}
        comparison_plot(times, res.get("xlabel", "sweep"), path)
    if name in FIGURES:
        FIGURES[name](res, path)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("benchmark", choices=list(BENCHMARKS))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits without one) or cpu")
    ap.add_argument("--out", default="results",
                    help="directory of the result json (default results)")
    ap.add_argument("--tf", type=float, default=2.0,
                    help="quadruped: seconds of closed loop (default 2.0)")
    ap.add_argument("--fig", action="store_true",
                    help="also draw the figures (needs matplotlib)")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("the drivers run on a CUDA device unless "
                             "--device cpu is given; none is available")
        where = f"{torch.cuda.get_device_name(0)} [{power_limit()}]"
    else:
        where = "CPU (the kernels' plain versions; no device metric)"
    name = args.benchmark
    print(f"== {name} on {where}", flush=True)
    res = BENCHMARKS[name](dev, args)
    save_results(os.path.join(args.out, f"{name}.json"),
                 dict(res, device=where))
    if name == "quadruped":
        print(res["table_md"])
        print(json.dumps({"device": where, "rows": {
            k: {kk: vv for kk, vv in v.items()
                if kk not in ("mpc_ms", "prep_ms", "tick_ms")}
            for k, v in res.items() if k != "table_md"}}))
    if args.fig:
        figures(name, res, args.out)


if __name__ == "__main__":
    main()
