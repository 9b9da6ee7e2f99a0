"""Float32-on-the-card against float64 agreement of the batched quadruped
rows (the counterpart of ``altro_tpu/bench/agreement_quadruped.py``).

The instances are ``bench/families.py``'s (8 contact schedules x B/8
perturbed initial states, built in float64 and cast), but sampled at
mid-phase, t = (i + 0.5) cycle / 8: at the bench's t = i cycle / 8 the
samples land on gait phase boundaries, where float32 and float64 round to
different contact schedules and the instances stop matching. Per friction
mode:

- phase 1, float32 on the card (on CUDA graphs): the flat and the grouped
  layout's solves of the same B instances, and a tight grouped re-solve
  (cost tolerance 1e-6, gradient tolerance 1e-8, 30 x 50 iterations, the
  JAX module's options); every lane of both layouts scored against the
  tight re-solve by the relative true-cost gap (the float64 cost of each
  lane's controls rolled out through its own dynamics from its x0);
- phase 2, the truth: SAMPLE lanes at ``linspace(0, B - 1, SAMPLE)`` of the
  grouped solutions (the shipped row) re-solved in float64 at tolerance
  1e-7, warm-started from the card's controls, by the port's plain float64
  path on the CPU in the same process: the largest and mean
  max|U_card - U_truth| per lane, the first control's largest error, the
  relative true-cost gaps and the truth solves' success.

The result carries the JAX module's keys (``config``; per mode
``tpu_success_rate`` and ``tpu_max_viol``, the card's grouped solve's,
``err_U_max``, ``err_U_mean``, ``err_u0_max``, ``cost_rel_gap_max``,
``cost_rel_gap_mean``, ``truth_success``, ``fullbatch_grouped`` and
``fullbatch_flat`` with ``lanes``, ``gap_max``, ``gap_p99`` and
``gap_mean``), plus ``gap_abs_p99`` in each full-batch entry, the flat
solve's success, the lanes whose status differs between the two layouts
and the tight re-solve's success. The JAX module scores the full batch in
float32 on its device; the port scores every cost in float64.

Gates (``check``), per mode, on the grouped layout: every truth solve
succeeds, at most one lane whose status differs from the flat layout's,
full-batch |mean gap| <= 1e-4 and p99 |gap| <= 1e-3.

Run on a CUDA machine: ``python -m altro_tpu_torch.bench.agreement_quadruped
[--batch B]`` (B = 512 by default, as the JAX module's); it prints the
result as one JSON line (the card's name and power limit in ``card``) and
exits non-zero when a gate fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from ..convert import tree_to
from ..solver import graph
from ..solver.altro import solve, take_lanes
from .families import quadruped_setup

SAMPLE = 16
B_DEFAULT = 512
# the tight float32 re-solve of the full batch (agreement_quadruped.py:
# 108-111) and the float64 truth solves (:173-176)
TIGHT_OPTS = dict(cost_tolerance=1e-6, gradient_tolerance=1e-8,
                  constraint_tolerance=1e-4, iterations_outer=30,
                  iterations_inner=50)
TRUTH_OPTS = dict(cost_tolerance=1e-7, gradient_tolerance=1e-9,
                  constraint_tolerance=1e-7, iterations_outer=40,
                  iterations_inner=100)
GATE_BIAS, GATE_P99, GATE_STATUS = 1e-4, 1e-3, 1
MID_PHASE = 0.5


def true_cost(prob, x0, U):
    """The float64 true cost of controls U [B, N-1, m] from x0 [B, n]."""
    return prob.cost.total(prob.dynamics.rollout(x0, U), U)


def rel_gap(J, J_ref):
    return (J - J_ref) / J_ref.abs().clamp(min=1e-12)


def _fullbatch(gap) -> dict:
    return dict(lanes=int(gap.numel()), gap_max=float(gap.max()),
                gap_p99=float(torch.quantile(gap, 0.99)),
                gap_mean=float(gap.mean()),
                gap_abs_p99=float(torch.quantile(gap.abs(), 0.99)))


def run_mode(linearized_friction: bool, B: int = B_DEFAULT, device="cuda",
             sample: int = SAMPLE) -> dict:
    """Both phases for one friction mode; the row of the JAX module's
    ``modes``."""
    s64 = quadruped_setup(B, linearized_friction, torch.float64, "cpu",
                          phase=MID_PHASE)
    x0 = s64.draw_x0()
    p64 = dataclasses.replace(s64.prob, x0=x0)
    g64 = quadruped_setup(B, linearized_friction, torch.float64, "cpu",
                          grouped=True, phase=MID_PHASE)
    opts = s64.opts

    # phase 1: float32 on the device, flat, grouped and tight grouped
    def on_device(prob, o):
        p32 = tree_to(dataclasses.replace(prob, x0=x0), device,
                      torch.float32)
        sol = graph.solve(p32, o, U0=s64.U0.to(device, torch.float32))
        return (sol.U.double().cpu(), sol.stats.status.cpu(),
                sol.stats.viol.double().cpu())

    Uf, stf, _ = on_device(s64.prob, opts)
    Ug, stg, vlg = on_device(g64.prob, opts)
    Ut, stt, _ = on_device(g64.prob, dataclasses.replace(opts, **TIGHT_OPTS))
    Jt = true_cost(p64, x0, Ut)
    gap_flat = rel_gap(true_cost(p64, x0, Uf), Jt)
    gap_grouped = rel_gap(true_cost(p64, x0, Ug), Jt)

    # phase 2: the float64 truth of the sampled grouped lanes, on the CPU
    idx = torch.as_tensor(np.linspace(0, B - 1, sample).astype(int))
    ps = take_lanes(p64, idx)
    truth = solve(ps, dataclasses.replace(opts, **TRUTH_OPTS), U0=Ug[idx])
    err = (Ug[idx] - truth.U).abs()
    gaps = rel_gap(true_cost(ps, ps.x0, Ug[idx]),
                   true_cost(ps, ps.x0, truth.U))
    return dict(
        tpu_success_rate=float(stg.double().mean()),
        tpu_max_viol=float(vlg.max()),
        err_U_max=float(err.amax(dim=(1, 2)).max()),
        err_U_mean=float(err.amax(dim=(1, 2)).mean()),
        err_u0_max=float(err[:, 0].max()),
        cost_rel_gap_max=float(gaps.max()),
        cost_rel_gap_mean=float(gaps.mean()),
        truth_success=int(truth.stats.status.min()),
        fullbatch_grouped=_fullbatch(gap_grouped),
        fullbatch_flat=_fullbatch(gap_flat),
        flat_success_rate=float(stf.double().mean()),
        status_differs=int((stg != stf).sum()),
        tight_success_rate=float(stt.double().mean()))


def run(B: int = B_DEFAULT, device="cuda", sample: int = SAMPLE) -> dict:
    """Both friction modes; the JAX module's result layout."""
    return dict(config=dict(sample=sample, batch=B, truth_tol=1e-7,
                            device=str(device)),
                modes={("qp" if lin else "socp"):
                       run_mode(lin, B, device, sample)
                       for lin in (True, False)})


def check(res: dict) -> None:
    """Raise AssertionError when a gate fails."""
    failed = []
    for mode, row in res["modes"].items():
        fb = row["fullbatch_grouped"]
        if row["truth_success"] != 1:
            failed.append(f"{mode}: a float64 truth solve did not succeed")
        if row["status_differs"] > GATE_STATUS:
            failed.append(f"{mode}: status differs from the flat layout on "
                          f"{row['status_differs']} lanes")
        if not (abs(fb["gap_mean"]) <= GATE_BIAS
                and fb["gap_abs_p99"] <= GATE_P99):
            failed.append(f"{mode}: grouped full-batch gap mean "
                          f"{fb['gap_mean']:.3e}, p99 |gap| "
                          f"{fb['gap_abs_p99']:.3e}")
    if failed:
        raise AssertionError("quadruped agreement: " + "; ".join(failed))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=B_DEFAULT)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the quadruped agreement runs its float32 phase on "
                         "a CUDA device; none is available")
    from .flagship import power_limit
    res = run(args.batch, "cuda")
    res["card"] = power_limit()
    print(json.dumps(res), flush=True)
    check(res)


if __name__ == "__main__":
    main()
