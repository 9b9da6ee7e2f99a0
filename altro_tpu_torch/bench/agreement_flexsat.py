"""Float32-on-the-card against float64 agreement gate of the flexsat
regulator benchmark (the counterpart of
``altro_tpu/bench/agreement_flexsat.py``).

Phase 1 runs the benchmark's regulator MPC (``bench/families.py``: the
float32 problem built in float64 and cast, the benchmark's options, the
plain step as the JAX gate runs it) for T_STEPS steps on B lanes on the
card and keeps every lane's x0 and controls after the steps CHECK_STEPS.
The regulator never moves its window, so an instance is its x0 alone. The
truth is the port's own solver in float64:

- SAMPLE lanes at ``linspace(0, B - 1, SAMPLE)`` of each checked step,
  solved at tolerance 1e-7 from the float32 controls by the plain float64
  path on the CPU (independent of the kernels): the largest and mean
  |U32 - U_truth|, the relative true-cost gaps and the truth solves'
  success;
- every lane of each checked step, re-solved cold at cost tolerance 1e-6
  in float64 (on the card through the kernels' float64 instantiations, or
  on the CPU): the relative true-cost gap of each lane-step, its mean, p99
  of |gap| and largest value, and the tight solves' success. The sampled
  truth solves cross-check the tight re-solves' own tolerance.

Costs are scored in float64: the true cost of the controls rolled out from
x0 (a float32 cost of a marginally stable rollout carries percent-level
noise, far above the ~1e-3 gaps measured here).

Gates (``check``): phase 1 success 1.0 and max_viol <= 1e-4, every truth
solve succeeds, full-batch |mean gap| <= 1e-3 and p99 |gap| <= 1e-2.

Run on a CUDA machine: ``python -m altro_tpu_torch.bench.agreement_flexsat
[--batch B]``; it prints the result as one JSON line (the card's name and
power limit in ``card``) and exits non-zero when a gate fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from ..convert import tree_to
from ..solver import graph
from ..solver.altro import solve
from .families import flexsat_setup, flexsat_step

SAMPLE = 16
T_STEPS = 20
CHECK_STEPS = (5, 12, 20)
B_DEFAULT = 1024
# the truth solves: tolerance 1e-7, a longer ladder, more rounds
TRUTH_OPTS = dict(cost_tolerance=1e-7, gradient_tolerance=1e-9,
                  constraint_tolerance=1e-7, early_exact_tol=0.0,
                  iterations_linesearch=10, iterations_outer=40,
                  iterations_inner=100)
# the full batch's cold re-solves
TIGHT_OPTS = dict(cost_tolerance=1e-6, gradient_tolerance=1e-8,
                  iterations_outer=30, iterations_inner=50, reg_min=1e-8,
                  early_exact_tol=0.0)
GATE_BIAS, GATE_P99, GATE_VIOL = 1e-3, 1e-2, 1e-4


def phase1(B: int = B_DEFAULT, device="cuda", steps: int = T_STEPS,
           check_steps=CHECK_STEPS) -> dict:
    """The float32 regulator MPC on ``device``: {step: (x0 [B, 12], U
    [B, N-1, 3]) as float64 on the CPU} for the checked steps, and every
    step's status and violation."""
    su = flexsat_setup(B, steps, torch.float32, device)
    step, init_carry = flexsat_step(su, 0)
    carry = init_carry(B)
    kept, status, viol = {}, [], []
    for t in range(steps):
        carry, out = step(carry, su.noise[t], t)
        if t + 1 in check_steps:
            kept[t + 1] = (out.x0.double().cpu(), out.U.double().cpu())
        status.append(out.status.cpu())
        viol.append(out.viol.double().cpu())
    return dict(kept=kept, status=torch.stack(status),
                viol=torch.stack(viol))


def true_cost(prob, x0, U):
    """The float64 true cost of controls U [B, N-1, m] from x0 [B, n]."""
    return prob.cost.total(prob.dynamics.rollout(x0, U), U)


def rel_gap(J, J_ref):
    return (J - J_ref) / J_ref.abs().clamp(min=1e-12)


def run(B: int = B_DEFAULT, device="cuda", sample: int = SAMPLE,
        steps: int = T_STEPS, check_steps=CHECK_STEPS) -> dict:
    """Phase 1 on ``device``, then the float64 truth of the sampled lanes
    on the CPU and the tight float64 re-solve of every lane on
    ``device``."""
    p1 = phase1(B, device, steps, check_steps)
    su = flexsat_setup(1, 1, torch.float64, "cpu")
    prob, opts = su.prob, su.opts
    idx = torch.as_tensor(np.linspace(0, B - 1, sample).astype(int))

    # the sampled lanes of every checked step in one float64 batch
    x0s = torch.cat([p1["kept"][k][0][idx] for k in check_steps])
    U32 = torch.cat([p1["kept"][k][1][idx] for k in check_steps])
    truth = solve(dataclasses.replace(prob, x0=x0s),
                  dataclasses.replace(opts, **TRUTH_OPTS), U0=U32)
    err_U = (U32 - truth.U).abs().amax(dim=(1, 2))
    J_truth = true_cost(prob, x0s, truth.U)
    gaps = rel_gap(true_cost(prob, x0s, U32), J_truth)

    # every lane against a cold tight float64 re-solve
    tight_opts = dataclasses.replace(opts, **TIGHT_OPTS)
    prob_fb = tree_to(prob, device)
    fb_gaps, fb_status, J_tight_sample = [], [], []
    for k in check_steps:
        x0b, Ub = p1["kept"][k]
        sol = graph.solve(dataclasses.replace(prob_fb, x0=x0b.to(device)),
                          tight_opts)
        Ut = sol.U.cpu()
        Jt = true_cost(prob, x0b, Ut)
        fb_gaps.append(rel_gap(true_cost(prob, x0b, Ub), Jt))
        fb_status.append(sol.stats.status.cpu())
        J_tight_sample.append(Jt[idx])
    g = torch.cat(fb_gaps)
    tight_vs_truth = rel_gap(torch.cat(J_tight_sample), J_truth)
    return dict(
        config=dict(batch=B, sample=sample, steps=steps,
                    window_ks=list(check_steps), truth_tol=1e-7,
                    device=str(device)),
        f32_success_rate=float(p1["status"].double().mean()),
        f32_max_viol=float(p1["viol"].max()),
        err_U_max=float(err_U.max()), err_U_mean=float(err_U.mean()),
        cost_rel_gap_max=float(gaps.max()),
        cost_rel_gap_mean=float(gaps.mean()),
        truth_success=int(truth.stats.status.min()),
        truth_iters_max=int(truth.stats.iterations.max()),
        fullbatch=dict(
            lanes_x_windows=int(g.numel()), gap_max=float(g.max()),
            gap_min=float(g.min()), gap_mean=float(g.mean()),
            gap_abs_p99=float(torch.quantile(g.abs(), 0.99)),
            tight_success=float(torch.cat(fb_status).double().mean()),
            tight_vs_truth_gap_max_abs=float(tight_vs_truth.abs().max())))


def check(res: dict) -> None:
    """Raise AssertionError when a gate fails."""
    fb = res["fullbatch"]
    failed = []
    if not (res["f32_success_rate"] == 1.0
            and res["f32_max_viol"] <= GATE_VIOL):
        failed.append(f"float32 success {res['f32_success_rate']}, "
                      f"max_viol {res['f32_max_viol']:.3e}")
    if res["truth_success"] != 1:
        failed.append("a float64 truth solve did not succeed")
    if not (abs(fb["gap_mean"]) <= GATE_BIAS
            and fb["gap_abs_p99"] <= GATE_P99):
        failed.append(f"full-batch gap mean {fb['gap_mean']:.3e}, p99 "
                      f"|gap| {fb['gap_abs_p99']:.3e}")
    if failed:
        raise AssertionError("flexsat agreement: " + "; ".join(failed))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=B_DEFAULT)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the flexsat agreement runs its float32 phase on a "
                         "CUDA device; none is available")
    from .flagship import power_limit
    res = run(args.batch, "cuda")
    res["card"] = power_limit()
    print(json.dumps(res), flush=True)
    check(res)


if __name__ == "__main__":
    main()
