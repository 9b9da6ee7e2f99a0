"""Float32-on-the-card against float64 and the C++ oracle on the conic
benchmarks, rocket and grasp (the counterpart of
``altro_tpu/bench/agreement_conic.py``).

Raw control agreement at the benchmark's tolerance is ill-posed on these
SOC problems (at a loose tolerance any stopping point in a flat cost valley
is converged, so two valid solves can differ by O(1) in late controls while
their costs agree), so the report follows the reference's own three-way
oracle: cost and control error against a tight truth. Per family, the
T-step, B-lane float32 MPC (the plain step, on CUDA graphs on the card)
runs in two configurations, the shipped warm options ("bench") and a tight
one (TIGHT: tolerance 1e-6, no exact-step stop), and reports for each:

- against a float64 truth solve at 1e-7 on the CPU (the port's plain path,
  from the float32 controls) of SAMPLE lanes at each of CHECK_STEPS:
  ``err_U`` (largest and mean |U32 - U_truth|), ``cost_rel_gap`` (largest
  and mean relative excess of the float32 controls' float64 true cost over
  the truth's) and the truth solves' worst status;
- at FULL_STEPS, every lane against a cold tight re-solve of its instance
  (from the window's controls, fresh duals) in float64 on the device (the
  kernels' float64 instantiations on the card): the relative true-cost
  gap's largest, smallest, p99 and mean, the share above 5%, and the tight
  re-solves' success and violation; their sampled lanes scored against the
  truth check the re-solves themselves;
- for the tight configuration at the last checked step, the truth solves
  against the native C++ conic ADMM at 1e-9 (``altro_tpu_torch/native``):
  the largest |U_truth - U_native| and the oracle's worst status.

The JAX module gates none of this; neither does :func:`run`. The gate of
this module is :func:`conic_agreement`: the float32 kernel path on the card
against the float64 plain path on the CPU from the same carry at every
step, scored by the true cost (at most one lane-step whose status differs,
|mean gap| and p99 |gap| under each family's bounds, ``GATES``).

Run on a CUDA machine: ``python -m altro_tpu_torch.bench.agreement_conic
[--batch B] [--out FILE]``; it prints the report as one JSON line (the
card's name and power limit in ``card``), writes it to ``--out`` when
given, then runs :func:`conic_agreement` on both families and exits
non-zero when its gate fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from ..convert import tree_to
from ..costs import retarget_tracking
from ..mpc import track_window
from ..native import qp as native
from ..solver import graph
from ..solver.altro import solve
from ..transcribe import extract_traj, to_batch_conic
from .conic import SETUPS, make_step

SAMPLE = 16
T_STEPS = 10
# windows where sampled lanes are held against the float64 truth
CHECK_STEPS = (4, 7, 10)
# windows where every lane is held against a cold tight re-solve
FULL_STEPS = (2, 4, 6, 8, 10)
B_DEFAULT = 1024
FAMILIES = ("rocket", "grasp")
# the tight configuration: the classical inner loop, no exact-step stop
TIGHT = dict(cost_tolerance=1e-6, gradient_tolerance=1e-8,
             constraint_tolerance=1e-5, iterations_outer=30,
             iterations_inner=50, reg_min=1e-8, early_exact_tol=0.0)
CONFIGS = (("bench", None), ("tight", TIGHT))
TRUTH_OPTS = dict(cost_tolerance=1e-7, gradient_tolerance=1e-9,
                  constraint_tolerance=1e-7, penalty_initial=1e3,
                  penalty_scaling=10.0, iterations_outer=40,
                  iterations_inner=100)
NATIVE_TOL = 1e-9
# conic_agreement's gates per family: (|mean gap|, p99 |gap|). A float32
# solve at the warm options stops where its own rounding hides further
# decrease; with kernel C's merit summed in doubles the rocket measured on
# an NVIDIA H100 a mean gap of -3.9e-5 and a p99 of 8.6e-4 over 64 lanes x
# 5 steps; with the float merit it had measured 1.2e-3 and 3.7e-2, and the
# JAX package's own float32 replay of the comparison on the CPU gives
# 1.7e-2 and 0.36. The rocket's gates sit between the two kernel paths, so
# that a return of the float merit's stalls (or any defect that biases many
# lanes) fails them. Grasp: the JAX package's shipped float32 measured a
# cost gap of 4.6e-5 against a float64 truth on the TPU.
GATES = {"rocket": (1e-3, 2e-2), "grasp": (1e-3, 1e-2)}
# conic_agreement's lanes and steps when run from main
GATE_B, GATE_T = 64, 5


def _prob_at(su, k: int):
    """Window ``k``'s problem of a setup (its x0 not set)."""
    pm = su.prob_mpc
    Xw, Uw = track_window(su.X_track, su.U_track, k, pm.N)
    p = dataclasses.replace(pm, cost=retarget_tracking(pm.cost, Xw, Uw))
    if su.constraints_fn is not None:
        p = dataclasses.replace(p, constraints=tuple(su.constraints_fn(k)))
    return p, Uw


def true_cost(prob, x0, U):
    """The true cost [B] of controls U [B, N-1, m] rolled out from x0."""
    return prob.cost.total(prob.dynamics.rollout(x0, U), U)


def rel_gap(J, J_ref):
    return (J - J_ref) / J_ref.abs().clamp(min=1e-12)


def phase1(su, B: int, T: int, check_steps, full_steps, sample: int,
           device) -> dict:
    """Both configurations' float32 MPC on ``device``, and the tight float64
    re-solves of every lane at ``full_steps`` there; every kept tensor as
    float64 on the CPU."""
    s64d = SETUPS[su.family](torch.float64, device=device,
                             track=(su.X_track.double(),
                                    su.U_track.double()))
    tight = dataclasses.replace(s64d.opts, **TIGHT)
    idx = torch.as_tensor(np.linspace(0, B - 1, sample).astype(int))
    noise = torch.as_tensor(np.random.default_rng(su.noise_seed)
                            .standard_normal((T, B, 6)),
                            dtype=torch.float32, device=device)
    out = {}
    for cname, ov in CONFIGS:
        opts = su.opts if ov is None else dataclasses.replace(su.opts, **ov)
        step, init = make_step(su, opts=opts)
        carry, kept = init(B), {}
        for t in range(T):
            carry, res = step(carry, noise[t], t)
            k = t + 1
            x0, U = res.x0.double().cpu(), res.U.double().cpu()
            if k in check_steps:
                kept[f"k{k}"] = (x0[idx], U[idx])
            if k in full_steps:
                p, Uw = _prob_at(s64d, k)
                sol = graph.solve(
                    dataclasses.replace(p, x0=res.x0.double()), tight,
                    U0=Uw.expand(B, -1, -1).contiguous())
                kept[f"f{k}"] = (x0, U, sol.U.cpu(), sol.stats.status.cpu(),
                                 sol.stats.viol.cpu())
        kept["status"] = res.status.cpu()
        kept["viol"] = res.viol.double().cpu()
        out[cname] = kept
    return out


def family_report(su, B: int = B_DEFAULT, T: int = T_STEPS,
                  check_steps=CHECK_STEPS, full_steps=FULL_STEPS,
                  sample: int = SAMPLE, device="cuda") -> dict:
    """One family's report: phase 1 on ``device``, then the float64 truth
    and the native oracle on the CPU."""
    p1 = phase1(su, B, T, check_steps, full_steps, sample, device)
    s64 = SETUPS[su.family](torch.float64, device="cpu",
                            track=(su.X_track.double().cpu(),
                                   su.U_track.double().cpu()))
    opts_truth = dataclasses.replace(s64.opts, **TRUTH_OPTS)
    idx = torch.as_tensor(np.linspace(0, B - 1, sample).astype(int))
    row = {}
    for cname, _ in CONFIGS:
        kept = p1[cname]
        errs, gaps, stts, gaps_cold, d_nat, stns = [], [], [], [], [], []
        for k in check_steps:
            p, _ = _prob_at(s64, k)
            x0s, U32 = kept[f"k{k}"]
            truth = solve(dataclasses.replace(p, x0=x0s), opts_truth, U0=U32)
            stts.append(int(truth.stats.status.min()))
            errs.append((U32 - truth.U).abs().amax(dim=(1, 2)))
            J_tr = true_cost(p, x0s, truth.U)
            gaps.append(rel_gap(true_cost(p, x0s, U32), J_tr))
            if f"f{k}" in kept:
                gaps_cold.append(rel_gap(true_cost(p, x0s,
                                                   kept[f"f{k}"][2][idx]),
                                         J_tr))
            if cname == "tight" and k == check_steps[-1]:
                for i in range(sample):
                    cp = to_batch_conic(dataclasses.replace(p, x0=x0s[i]))
                    nat = native.solve_conic(*native.conic_arrays(cp),
                                             eps_abs=NATIVE_TOL,
                                             max_iter=300000)
                    stns.append(int(nat.status))
                    _, U_nat = extract_traj(cp, torch.as_tensor(nat.x)[None])
                    d_nat.append(float((truth.U[i] - U_nat[0]).abs().max()))
        errs, gaps = torch.cat(errs), torch.cat(gaps)
        r = dict(tpu_success_rate=float(kept["status"].double().mean()),
                 tpu_max_viol=float(kept["viol"].max()),
                 err_U_max=float(errs.max()), err_U_mean=float(errs.mean()),
                 cost_rel_gap_max=float(gaps.max()),
                 cost_rel_gap_mean=float(gaps.mean()),
                 truth_success=int(min(stts)))
        if d_nat:
            r["max_dU_cpu_f64_vs_native_cpp"] = max(d_nat)
            r["native_success"] = int(min(stns))
        fks = [k for k in full_steps if f"f{k}" in kept]
        if fks:
            fbg = []
            for k in fks:
                p, _ = _prob_at(s64, k)
                x0b, Ub, Uc, _, _ = kept[f"f{k}"]
                fbg.append(rel_gap(true_cost(p, x0b, Ub),
                                   true_cost(p, x0b, Uc)))
            g = torch.cat(fbg)
            r["fullbatch"] = dict(
                lanes=B, windows=fks,
                cold_tight_success=float(torch.cat(
                    [kept[f"f{k}"][3] for k in fks]).double().mean()),
                cold_tight_max_viol=float(torch.cat(
                    [kept[f"f{k}"][4] for k in fks]).max()),
                gap_max=float(g.max()), gap_min=float(g.min()),
                gap_p99=float(torch.quantile(g, 0.99)),
                gap_mean=float(g.mean()),
                frac_above_5pct=float((g > 0.05).double().mean()),
                cold_tight_vs_truth_gap_max=(
                    float(torch.cat(gaps_cold).max()) if gaps_cold
                    else None))
        row[cname] = r
    return row


def run(B: int = B_DEFAULT, T: int = T_STEPS, device="cuda",
        families=FAMILIES, check_steps=CHECK_STEPS, full_steps=FULL_STEPS,
        sample: int = SAMPLE, setups=None) -> dict:
    """Every family's report (``setups``: {family: a float32
    ``bench/conic.py`` setup on ``device``} instead of building one)."""
    res = dict(config=dict(sample=sample, steps=T, batch=B,
                           device=str(device), window_ks=list(check_steps),
                           full_ks=list(full_steps),
                           truth_tol=TRUTH_OPTS["cost_tolerance"],
                           native_tol=NATIVE_TOL, tight_config=TIGHT),
               families={})
    for family in families:
        su = ((setups or {}).get(family)
              or SETUPS[family](torch.float32, device=device))
        res["families"][family] = family_report(
            su, B, T, check_steps, full_steps, sample, device)
    return res


def conic_agreement(su32, Bn: int, T: int, device="cuda") -> dict:
    """The float32 kernel path on ``device`` against the float64 plain path
    on the CPU, rocket or grasp: at each step the float32 carry is advanced
    by the float32 step and, cast to float64, solved by the float64 step
    (both ``ls_fused="on"``); both solutions' controls are scored by the
    float64 true cost of the instance (rolled out from the float64 step's
    x0). Returns the statistics; raises AssertionError when more than one
    lane-step's status differs or the gap's |mean| or p99 |gap| exceeds
    the family's ``GATES``."""
    family = su32.family
    gate_bias, gate_p99 = GATES[family]
    s64 = SETUPS[family](torch.float64, device="cpu",
                         track=(su32.X_track.double().cpu(),
                                su32.U_track.double().cpu()))
    step32, init32 = make_step(su32, opts=dataclasses.replace(
        su32.opts, ls_fused="on"))
    step64, _ = make_step(s64, opts=dataclasses.replace(s64.opts,
                                                        ls_fused="on"))
    noise = np.random.default_rng(su32.noise_seed).standard_normal((T, Bn, 6))
    carry = init32(Bn)
    gaps, status_diff, dU = [], 0, 0.0
    for t in range(T):
        c64 = tree_to(carry, "cpu", torch.float64)
        carry, o32 = step32(carry, torch.as_tensor(
            noise[t], dtype=torch.float32, device=device), t)
        _, o64 = step64(c64, torch.as_tensor(noise[t]), t)
        p, _ = _prob_at(s64, t + 1)
        U32 = o32.U.double().cpu()
        gaps.append(rel_gap(true_cost(p, o64.x0, U32),
                            true_cost(p, o64.x0, o64.U)))
        status_diff += int((o32.status.cpu() != o64.status).sum())
        dU = max(dU, float((U32 - o64.U).abs().max()))
    gap = torch.stack(gaps)
    worst = int(gap.abs().argmax())
    res = dict(family=family, lanes=Bn, steps=T, status_diff=status_diff,
               gap_mean=float(gap.mean()),
               gap_abs_p99=float(torch.quantile(gap.abs().flatten(), 0.99)),
               gap_worst=float(gap.flatten()[worst]),
               worst_step=worst // Bn, worst_lane=worst % Bn, max_dU=dU,
               gate_bias=gate_bias, gate_p99=gate_p99)
    print(f"{family} agreement {Bn} lanes x {T} steps, f32 kernels vs f64 "
          f"plain (ls_fused='on'): status differs on {status_diff} "
          f"lane-steps; true-cost gap mean {res['gap_mean']:.3e}, p99 |gap| "
          f"{res['gap_abs_p99']:.3e}, worst {res['gap_worst']:.3e} (step "
          f"{res['worst_step']}, lane {res['worst_lane']}); max|dU| {dU:.3e};"
          f" gates |mean| <= {gate_bias:.0e}, p99 <= {gate_p99:.0e}",
          flush=True)
    if status_diff > 1:
        raise AssertionError(f"{family} status differs on {status_diff} "
                             "lane-steps")
    if not (abs(res["gap_mean"]) <= gate_bias
            and res["gap_abs_p99"] <= gate_p99):
        raise AssertionError(f"{family} cost gap: mean {res['gap_mean']:.3e}"
                             f", p99 {res['gap_abs_p99']:.3e}")
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=B_DEFAULT)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the conic agreement runs its float32 phase on a "
                         "CUDA device; none is available")
    from .flagship import power_limit
    setups = {f: SETUPS[f](torch.float32, device="cuda") for f in FAMILIES}
    res = run(args.batch, device="cuda", setups=setups)
    res["card"] = power_limit()
    print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    for f in FAMILIES:
        conic_agreement(setups[f], GATE_B, GATE_T)


if __name__ == "__main__":
    main()
