"""The comparison that decides ``correct``: the program's answers in the
lane-steps the window recorded, judged against the plain reference.

For every recorded lane-step the reference works out again, in float64 from
the configuration's data and the recorded inputs (the lane's previous state
and first control, the noise row, the window index), the propagated state
and the window's optimal controls. The numbers compared:

- ``x0_err``: the largest gap between the program's propagated state and
  the reference's, inf-norm, relative to max(1, |x0|);
- ``cost_gap_p90``: the 90th percentile, over the lane-steps the program
  reports as solved and the set-up's initial carry (window 0 from the
  configuration's x0), of the gap between the true tracking cost of the
  program's controls and the reference optimum's, both from the reference's
  state, relative to max(1, |J*|). A quarter of the recorded lane-steps are
  their step's slowest lane, so a fault in the stragglers' answers (a
  compaction level's gather or scatter) reaches it; the largest gap, a
  widest gap that swings from seed to seed, is reported beside it;
- ``viol_max``: the largest constraint violation of the program's controls
  over the same lane-steps, rolled out from the reference's state (the
  inf-norm of c - proj_K(c) over the active rows), which the
  configuration's constraint tolerance bounds;
- ``fail_share``: the share of the window's lane-solves that the program
  reports as not solved, against the configuration's success rate.

The control (``control_answers``) puts the reference in the program's place,
computed in TF32: its answers are judged by the same numbers.
"""
from __future__ import annotations

import torch

from benchmark.reference.ipm import F64, TF32, Arith

# the reference solver's duality-gap tolerance, relative to 1 + |f|, in
# float64 and in the control's float32
GAP_TOL = {torch.float64: 1e-11, torch.float32: 1e-7}


def _inputs(cell, samples: dict, device):
    """(x0_prev, u0_prev, noise, k) of the recorded lane-steps and, last,
    the start sample (zeros and window 0), on ``device``."""
    d = dict(device=device)
    n = cell.n
    x0p = torch.cat([samples["x0_prev"], torch.zeros(1, n)]).to(**d)
    u0p = torch.cat([samples["u0_prev"],
                     torch.zeros(1, cell.m)]).to(**d)
    noise = torch.cat([samples["noise"], torch.zeros(1, n)]).to(**d)
    k = torch.cat([samples["k"], torch.zeros(1, dtype=torch.int64)]).to(**d)
    return x0p, u0p, noise, k


def reference_state(ref, cell, x0p, u0p, noise, ar: Arith = F64):
    """Every lane-step's propagated state; the last row is the start
    sample's, the configuration's x0."""
    x0 = ref.propagate(x0p[:-1], u0p[:-1], noise[:-1], ar)
    return torch.cat([x0, cell.x0_start.to(x0)[None]])


def control_answers(cell, samples: dict, start: dict, device):
    """The control's answers (x0, U) to the same lane-steps: the reference
    computed in TF32 (operands of every product rounded to TF32, the rest
    in float32)."""
    ref = cell.reference.to(device)
    x0p, u0p, noise, k = _inputs(cell, samples, device)
    x0 = reference_state(ref, cell, x0p, u0p, noise, TF32)
    z0 = cell.ref_start(x0.shape[0]).to(device)
    U = ref.solve(x0, k, z0, TF32, gap_tol=GAP_TOL[torch.float32])
    return x0, U


def judge(cell, samples: dict, start: dict, device, answers=None):
    """(per-sample readings, the compared numbers with diagnostics as Python
    floats) of the program's recorded answers (or of ``answers`` = (x0, U)
    in the same order, the start sample last)."""
    ref = cell.reference.to(device)
    x0p, u0p, noise, k = _inputs(cell, samples, device)
    x0_true = reference_state(ref, cell, x0p, u0p, noise)
    z0 = cell.ref_start(x0_true.shape[0]).to(device)
    U_star = ref.solve(x0_true, k, z0, F64, gap_tol=GAP_TOL[torch.float64])
    if answers is None:
        x0_ans = torch.cat([samples["x0"], start["x0"]]).to(device).double()
        U_ans = torch.cat([samples["U"], start["U"]]).to(device).double()
        solved = torch.cat([samples["status"] == 1,
                            torch.ones(1, dtype=torch.bool)]).to(device)
    else:
        x0_ans, U_ans = (a.to(device).double() for a in answers)
        solved = torch.ones(x0_ans.shape[0], dtype=torch.bool, device=device)
    infeasible = torch.isnan(U_star).flatten(1).any(dim=1)
    J_star = ref.cost(x0_true, torch.nan_to_num(U_star), k)
    J = ref.cost(x0_true, U_ans, k)
    gap = (J - J_star).abs() / torch.clamp(J_star.abs(), min=1.0)
    gap = torch.where(infeasible, torch.full_like(gap, float("inf")), gap)
    scale = torch.clamp(x0_true.abs().amax(dim=1), min=1.0)
    x0_err = (x0_ans - x0_true).abs().amax(dim=1) / scale
    viol = ref.violation(x0_true, U_ans)
    viol_star = ref.violation(x0_true, torch.nan_to_num(U_star))
    judged = solved
    per_sample = {"J": J.cpu(), "J_star": J_star.cpu(), "gap": gap.cpu(),
                  "U_star": U_star.cpu(), "x0_true": x0_true.cpu(),
                  "x0_err": x0_err.cpu(), "viol": viol.cpu(),
                  "k": k.cpu(), "solved": solved.cpu()}
    any_ = bool(judged.any())
    return per_sample, {
        "x0_err": float(x0_err.max()),
        "cost_gap_p90": (float(torch.quantile(gap[judged], 0.9))
                         if any_ else 0.0),
        "cost_gap_max": float(gap[judged].max()) if any_ else 0.0,
        "judged": int(judged.sum()),
        "not_solved_in_sample": int((~solved).sum()),
        "reference_infeasible": int(infeasible.sum()),
        "viol_max": float(viol[judged].max()) if any_ else 0.0,
        "reference_viol_max": float(viol_star[~infeasible].max()),
        "cost_gap_median": float(gap[judged].median()) if any_ else 0.0,
    }


COMPARED = ("x0_err", "cost_gap_p90", "viol_max", "fail_share")


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]) over the numbers that have a limit;
    a number above its limit, or not a number, is not correct."""
    rows = [(k, numbers[k], limits[k]) for k in COMPARED
            if k in numbers and k in limits]
    ok = all(v == v and v <= lim for _, v, lim in rows)
    return ok, rows
