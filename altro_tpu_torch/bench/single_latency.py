"""Single-instance warm-MPC latency (the port's counterpart of
``altro_tpu/bench/single_latency.py``): the native AL-iLQR on the host
beside the port's warm step at B=1 on the card.

    python -m altro_tpu_torch.bench.single_latency [--device cpu]
        [--out DIR] [--fig]

The reference's single-core latency row (the random-linear horizon sweep;
figures/horizon_comp.tikz's mean line) times ``benchmark_solve!``: the
solver call alone on a warm-started, already-updated problem
(random_linear_problem.jl:161). Both rows take that configuration
(n=12, m=6, 1% noise, float64) at N = 11, 31, 51, 71, 101:

- ``native``: the port's copy of the C++ AL-iLQR (``native/``,
  ilqr_solver.cpp): the ``solve()`` wall per step, the shifts and the
  problem update untimed (the reference's scope), and update + solve
  beside it (100 warm steps);
- ``graphed``: the port's warm MPC step (``mpc.make_mpc_step``) at B=1 on
  CUDA graphs on the card (the place of the JAX package's jitted step):
  the whole step's wall, shifts and solve, each fenced by a device
  synchronise (60 warm steps after one warm-up step that captures).

Prints one line per row and writes ``<out>/single_latency.json`` with the
device (name and power limit). Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..costs import retarget_tracking
from ..mpc import make_mpc_step, track_window
from ..native import qp as native_qp
from ..solver.options import SolverOptions
from .flagship import power_limit

# the reference ALTRO's horizon-sweep means, ms (figures/horizon_comp.tikz)
REFERENCE_MS = {11: 0.193, 31: 0.583, 51: 0.984, 71: 1.406, 101: 2.132}
HORIZONS = (11, 31, 51, 71, 101)


def _config(N_mpc: int, T: int, device="cpu", seed: int = 0):
    from ..models import random_linear as rl
    rng = np.random.default_rng(seed)
    N_track = N_mpc + T + 2
    prob = rl.gen_random_linear(rng, 12, 6, N_track, dtype=torch.float64,
                                device=device)
    X_track, U_track = rl.gen_trajectory(rng, prob, N_track)
    pm = rl.gen_tracking_mpc(prob, X_track, U_track, N_mpc)
    opts = SolverOptions(
        cost_tolerance=1e-4, gradient_tolerance=1e-4,
        constraint_tolerance=1e-4, penalty_initial=1e3,
        penalty_scaling=100.0, reset_duals=False,
        # the flagship's warm-solve options: an L=2 ladder and the exact-step
        # early stop
        iterations_linesearch=2, early_exact_tol=1e-3)
    return pm, X_track, U_track, opts, rng


def native_row(N_mpc: int, T: int = 100) -> dict:
    """The native AL-iLQR's warm MPC loop of T steps on the host."""
    import dataclasses
    pm, X_track, U_track, opts, rng = _config(N_mpc, T)
    w = native_qp.ilqr_setup(pm)
    s = w.solve(opts)
    if s.status != 1:
        raise RuntimeError(f"native AL-iLQR: the cold solve at N={N_mpc} "
                           "did not converge")
    Xc, Uc, lam = s.X, s.U, s.lam
    A, B, d = (getattr(pm.dynamics, f)[0].numpy() for f in "ABd")
    x0 = pm.x0.numpy()
    noise = rng.standard_normal((T, 12))
    solve_ms, upd_ms, iters, viols = [], [], [], []
    for t in range(T):
        x_prop = A @ x0 + B @ Uc[0] + d
        x0 = x_prop + noise[t] * np.max(np.abs(x_prop)) / 100.0
        Xw, Uw = track_window(X_track, U_track, t + 1, pm.N)
        pk = dataclasses.replace(pm, cost=retarget_tracking(pm.cost, Xw, Uw),
                                 x0=torch.as_tensor(x0))
        U_ws = np.concatenate([Uc[1:], Uc[-1:]], 0)
        lam_ws = np.concatenate([lam[1:], lam[-1:]], 0)
        X_ws = np.concatenate([Xc[1:],
                               (A @ Xc[-1] + B @ Uc[-1] + d)[None]], 0)
        t0 = time.perf_counter()
        w.update(pk)
        t1 = time.perf_counter()
        s = w.solve(opts, U0=U_ws, lam0=lam_ws, X0=X_ws)
        t2 = time.perf_counter()
        if s.status != 1:
            raise RuntimeError(f"native AL-iLQR: step {t} at N={N_mpc} did "
                               f"not converge (violation {s.viol:.2e})")
        upd_ms.append((t1 - t0) * 1e3)
        solve_ms.append((t2 - t1) * 1e3)
        iters.append(s.iterations)
        viols.append(s.viol)
        Xc, Uc, lam = s.X, s.U, s.lam
    return dict(
        N=N_mpc, solve_ms_mean=float(np.mean(solve_ms)),
        solve_ms_p50=float(np.percentile(solve_ms, 50)),
        solve_ms_std=float(np.std(solve_ms)),
        update_ms_mean=float(np.mean(upd_ms)),
        update_plus_solve_ms=float(np.mean(upd_ms) + np.mean(solve_ms)),
        mean_iters=float(np.mean(iters)), max_viol=float(np.max(viols)),
        reference_ms=REFERENCE_MS.get(N_mpc),
        vs_reference=(REFERENCE_MS[N_mpc] / float(np.mean(solve_ms))
                      if N_mpc in REFERENCE_MS else None))


def graphed_row(N_mpc: int, T: int = 60, device="cuda") -> dict:
    """The port's warm MPC step at B=1 (on CUDA graphs on a card; on the
    CPU the same route over fixed buffers), T timed steps after one
    warm-up step."""
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    pm, X_track, U_track, opts, rng = _config(N_mpc, T, device=dev)
    step, init_carry = make_mpc_step(pm, opts, X_track, U_track)
    carry = init_carry(1)
    noise = torch.as_tensor(rng.standard_normal((T, 12)), device=dev)
    step(carry, noise[0][None], 0)
    sync()
    walls, iters, status = [], [], []
    for t in range(T):
        t0 = time.perf_counter()
        carry, out = step(carry, noise[t][None], t)
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
        iters.append(int(out.iters[0]))
        status.append(int(out.status[0]))
    return dict(N=N_mpc, step_ms_mean=float(np.mean(walls)),
                step_ms_p50=float(np.percentile(walls, 50)),
                mean_iters=float(np.mean(iters)),
                success=float(np.mean(status)))


def write_figure(res, path):
    """The horizon sweep's latency (figures/horizon_comp.tikz's analog)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    Ns = [r["N"] for r in res["native"]]
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(Ns, [REFERENCE_MS[n] for n in Ns], "s--", color="0.25", lw=2,
            label="reference ALTRO (Julia, 1 core)")
    ax.plot(Ns, [r["solve_ms_mean"] for r in res["native"]], "o-",
            color="tab:red", lw=2, label="native AL-iLQR")
    ax.plot(Ns, [r["update_plus_solve_ms"] for r in res["native"]], "o:",
            color="tab:red", lw=1.2, alpha=0.7,
            label="native incl. problem update")
    ax.plot([r["N"] for r in res["graphed"]],
            [r["step_ms_mean"] for r in res["graphed"]], "^-",
            color="tab:blue", lw=2, label="warm step, B=1 (graphed)")
    ax.set_xlabel("MPC horizon N")
    ax.set_ylabel("warm solve time (ms)")
    ax.grid(True, alpha=0.3)
    ax.legend(fontsize=8)
    fig.savefig(path, bbox_inches="tight", dpi=120)
    plt.close(fig)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="of the graphed row: cuda (default; exits without "
                         "one) or cpu")
    ap.add_argument("--out", default="results",
                    help="directory of the result json (default results)")
    ap.add_argument("--fig", action="store_true",
                    help="also draw the figure (needs matplotlib)")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("the graphed row runs on a CUDA device unless "
                             "--device cpu is given; none is available")
        where = f"{torch.cuda.get_device_name(0)} [{power_limit()}]"
    else:
        where = "CPU (the kernels' plain versions; no device metric)"
    res = {"config": "random-linear n=12 m=6, 1% noise, warm MPC steps, "
                     "float64", "device": where, "native": [], "graphed": []}
    for N in HORIZONS:
        r = native_row(N)
        print(f"native N={N}: solve {r['solve_ms_mean']:.4f} ms (reference "
              f"{r['reference_ms']} ms), update+solve "
              f"{r['update_plus_solve_ms']:.4f} ms, iterations "
              f"{r['mean_iters']:.2f}", flush=True)
        res["native"].append(r)
    for N in HORIZONS:
        r = graphed_row(N, device=dev)
        print(f"graphed N={N} on {where}: step {r['step_ms_mean']:.4f} ms "
              f"(p50 {r['step_ms_p50']:.4f}), iterations "
              f"{r['mean_iters']:.2f}, success {r['success']:.2f}",
              flush=True)
        res["graphed"].append(r)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "single_latency.json")
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    print(f"wrote {path}")
    if args.fig:
        write_figure(res, os.path.join(args.out, "single_latency.png"))


if __name__ == "__main__":
    main()
