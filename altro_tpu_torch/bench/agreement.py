"""Float32-on-the-card against float64 and the C++ oracle: the flagship's
agreement gate (the counterpart of ``altro_tpu/bench/agreement.py``).

Phase 1 runs the flagship warm-started MPC (random-linear n=12, m=6,
N_mpc=30, one NONPOS control bound; ``make_mpc_step(shared_k=False)`` as
the JAX package runs it: every lane carries its window index, so the solve
takes the split route, kernels D and A on the card) in float32 on B lanes
for T steps, at tolerances 1e-4 and 1e-6 with the exact-step stop at
1e-3 and the L=2 ladder of the benchmark. The problem is built in float64
on the CPU and cast, so the truth solves see the identical instances (the
same x0, tracking window and convex QP, whose optimum is unique). After
the last step (window k = T):

- SAMPLE lanes at ``linspace(0, B - 1, SAMPLE)``, solved in float64 on the
  CPU by the port's plain path at tolerance 1e-8 from the float32
  controls: the largest and mean |U32 - U64| per tolerance;
- the same lanes of the first tolerance as dense QPs solved by the native
  C++ ADMM oracle (``altro_tpu_torch/native``) at 1e-8: the largest
  |U64 - U_native| and the oracle's worst status;
- every lane, scored by its float64 true cost against a cold float64 truth
  solve of its instance (from the window's controls) on the CPU: the
  relative gap's largest value, p99 and mean per tolerance.

The result carries the JAX module's keys (``per_tpu_tolerance``'s entries
name the float32 device run, here the card). Gate (``check``): success 1.0
on every lane of every step at both tolerances (``PERF.md`` §2); the rest
is reported.

Run on a CUDA machine: ``python -m altro_tpu_torch.bench.agreement
[--batch B] [--steps T] [--out FILE]``; it prints the result as one JSON
line (the card's name and power limit in ``card``), writes it to
``--out`` when given, and exits non-zero when the gate fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from ..convert import tree_to
from ..costs import retarget_tracking
from ..models import random_linear as rl
from ..mpc import make_mpc_step, track_window
from ..native import qp as native
from ..solver.altro import solve
from ..solver.options import SolverOptions
from ..transcribe import extract_traj, to_batch_qp

SEED = 1
N_MPC = 30
N_DIM, M_DIM = 12, 6
SAMPLE = 32
T_STEPS = 10
B_DEFAULT = 1024
TOLS = (1e-4, 1e-6)
# the flagship benchmark's exact-step stop: the same configuration the
# throughput number ships with
EARLY_TOL = 1e-3
# the float64 truth
TRUTH_OPTS = dict(cost_tolerance=1e-8, gradient_tolerance=1e-9,
                  constraint_tolerance=1e-7, penalty_initial=1e3,
                  penalty_scaling=100.0)
NATIVE_TOL = 1e-8


def flagship(T: int):
    """The float64 flagship MPC problem and tracking reference on the CPU,
    for T steps from window 0."""
    rng = np.random.default_rng(SEED)
    N_track = N_MPC + T + 2
    prob = rl.gen_random_linear(rng, N_DIM, M_DIM, N_track)
    X_track, U_track = rl.gen_trajectory(rng, prob, N_track)
    return rl.gen_tracking_mpc(prob, X_track, U_track, N_MPC), X_track, U_track


def card_options(tol: float) -> SolverOptions:
    return SolverOptions(
        cost_tolerance=tol, gradient_tolerance=tol,
        constraint_tolerance=max(tol, 1e-5), penalty_initial=1e3,
        penalty_scaling=100.0, reset_duals=False, iterations_linesearch=2,
        early_exact_tol=EARLY_TOL)


def phase1(B: int = B_DEFAULT, T: int = T_STEPS, device="cuda") -> dict:
    """The float32 ``shared_k=False`` MPC on ``device`` at each tolerance:
    {tol: dict(x0, U of the last step as float64 on the CPU, status [T, B],
    step ms)}."""
    pm64, X64, U64 = flagship(T)
    pm, X_track, U_track = tree_to((pm64, X64, U64), device, torch.float32)
    noise = torch.as_tensor(np.random.default_rng(SEED).standard_normal(
        (T, B, N_DIM)), dtype=torch.float32, device=device)
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    out = {}
    for tol in TOLS:
        step, init_carry = make_mpc_step(pm, card_options(tol), X_track,
                                         U_track, shared_k=False)
        carry = init_carry(B)
        step(carry, noise[0])                     # capture, warm up
        status, ms = [], []
        for t in range(T):
            sync()
            t0 = time.perf_counter()
            carry, res = step(carry, noise[t])
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            status.append(res.status.cpu())
        out[tol] = dict(x0=res.x0.double().cpu(), U=res.U.double().cpu(),
                        status=torch.stack(status), step_ms=ms,
                        k=int(carry[4][0]))
    return out


def run(B: int = B_DEFAULT, T: int = T_STEPS, device="cuda",
        sample: int = SAMPLE) -> dict:
    """Phase 1 on ``device``, then the float64 truths and the native
    oracle on the CPU."""
    p1 = phase1(B, T, device)
    pm, X_track, U_track = flagship(T)
    k = p1[TOLS[0]]["k"]
    Xw, Uw = track_window(X_track, U_track, k, N_MPC)
    cost_k = retarget_tracking(pm.cost, Xw, Uw)
    prob_k = dataclasses.replace(pm, cost=cost_k)
    opts64 = SolverOptions(**TRUTH_OPTS)
    idx = torch.as_tensor(np.linspace(0, B - 1, sample).astype(int))

    def cost_of(x0, U):
        return cost_k.total(pm.dynamics.rollout(x0, U), U)

    per_tol, fullbatch = {}, {}
    d_nat, nat_status = [], []
    for tol in TOLS:
        key = f"{tol:g}"
        x0s, U32 = p1[tol]["x0"][idx], p1[tol]["U"][idx]
        U64 = solve(dataclasses.replace(prob_k, x0=x0s), opts64, U0=U32).U
        d = (U32 - U64).abs().amax(dim=(1, 2))
        if tol == TOLS[0]:
            for i in range(sample):
                qp = to_batch_qp(dataclasses.replace(prob_k, x0=x0s[i]))
                nat = native.solve_qp(qp.P[0], qp.q[0], qp.A[0], qp.l[0],
                                      qp.u[0], eps_abs=NATIVE_TOL,
                                      max_iter=40000)
                nat_status.append(nat.status)
                _, U_nat = extract_traj(qp, torch.as_tensor(nat.x)[None])
                d_nat.append(float((U64[i] - U_nat[0]).abs().max()))
        status = p1[tol]["status"]
        per_tol[key] = dict(
            tpu_success_rate=float(status[-1].double().mean()),
            success_all_steps=float(status.double().mean()),
            max_dU_tpu_f32_vs_cpu_f64=float(d.max()),
            mean_dU_tpu_f32_vs_cpu_f64=float(d.mean()),
            step_ms_p50=float(np.median(p1[tol]["step_ms"])))
        # every lane against a cold float64 truth solve of its instance
        x0b, Ub = p1[tol]["x0"], p1[tol]["U"]
        Ut = solve(dataclasses.replace(prob_k, x0=x0b), opts64,
                   U0=Uw.expand(B, -1, -1).contiguous()).U
        Jt = cost_of(x0b, Ut)
        g = (cost_of(x0b, Ub) - Jt) / Jt.abs().clamp(min=1e-12)
        fullbatch[f"tol_{key}"] = dict(
            lanes=int(g.numel()), gap_max=float(g.max()),
            gap_p99=float(torch.quantile(g, 0.99)),
            gap_mean=float(g.mean()))
    return dict(
        config=dict(n=N_DIM, m=M_DIM, N_mpc=N_MPC, seed=SEED, sample=sample,
                    step=k, batch=B, steps=T, device=str(device),
                    f64_tol=TRUTH_OPTS["cost_tolerance"],
                    native_tol=NATIVE_TOL, early_exact_tol=EARLY_TOL),
        per_tpu_tolerance=per_tol,
        max_dU_cpu_f64_vs_native_cpp=max(d_nat),
        native_success=int(min(nat_status)),
        fullbatch=fullbatch,
        note=("identical instances: the problem is built in float64 on the "
              "CPU and cast to float32 for the device run; every lane starts "
              "at window 0, so the last step's window is k = steps"))


def check(res: dict) -> None:
    """Raise AssertionError unless every lane of every step succeeded at
    both tolerances."""
    bad = {k: v["success_all_steps"] for k, v in
           res["per_tpu_tolerance"].items() if v["success_all_steps"] != 1.0}
    if bad:
        raise AssertionError(f"flagship agreement: success below 1.0 at "
                             f"{bad}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=B_DEFAULT)
    ap.add_argument("--steps", type=int, default=T_STEPS)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the flagship agreement runs its float32 phase on a "
                         "CUDA device; none is available")
    from .flagship import power_limit
    res = run(args.batch, args.steps, "cuda")
    res["card"] = power_limit()
    print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    check(res)


if __name__ == "__main__":
    main()
