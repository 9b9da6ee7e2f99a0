"""Cost-parity gate between kernel B's route and the split route on the
conic benchmarks (the counterpart of ``altro_tpu/bench/fused_check.py``).

At every step of a T-step warm MPC chain of each family (rocket, grasp;
B lanes, float32, the plain step on CUDA graphs) two solvers start from the
identical carry on the identical instances:

- the fused route (``SolverOptions.fused_expansion`` on, as shipped): the
  AL expansion fused into the Riccati pass, kernel B on the card;
- the split route (``fused_expansion=False``, the JAX package's
  ALTRO_TPU_FUSED=0): the expansion in PyTorch, then the Riccati pass from
  it, kernel D on the card.

Both run the fused ladder + merit (kernel C on the card, the multi-block
default). The chain advances with the fused route's solution. Each lane's
two answers are scored under the true (unpenalized) float64 cost of its
instance, on the CPU in the same process: the controls rolled out from the
step's x0 through the float64 problem built on the same tracking
reference,

    gap = (J_fused - J_split) / max(|J_split|, 1e-12).

A raw dU between two float32 solves is ill-posed at the benchmark
tolerance (rounding flips line-search decisions on knife-edge lanes), and
the largest gap is an extreme-value statistic; a defect of either route
biases many lanes. Gates per family, over all B lanes x T steps:

- success of the fused route >= success of the split route;
- |mean signed gap| <= GATE_BIAS (1e-3);
- p99 of |gap| <= GATE_P99 (2e-2);
- the fused route's largest violation <= max(the split route's,
  ``constraint_tolerance``).

Reported besides: the largest and mean |gap|, both routes' largest
violation, step ms p50 of both routes and their graph capture seconds (in
``compile_s_*``, as the JAX module names its compile times), and on a CUDA
device each route's launches of kernels B and D, whose routing is gated
too (B and no D on the fused route, D and no B on the split route).

Run on a CUDA machine:

    python -m altro_tpu_torch.bench.fused_check [--batch B] [--steps T]
        [--out FILE]

It prints the result as one JSON line (the card's name and power limit in
``card``), writes it to ``--out`` when given, and exits non-zero when a
gate fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from ..costs import retarget_tracking
from ..mpc import track_window
from ..ops import riccati, riccati_fused
from .conic import SETUPS, make_step

B_DEFAULT = 1024
T_STEPS = 6
FAMILIES = ("rocket", "grasp")
GATE_BIAS = 1e-3
GATE_P99 = 2e-2
ROUTES = (("fused", True), ("unfused", False))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def true_costs(s64, k: int, x0, U):
    """The float64 true cost [B] of controls U [B, N-1, m] from x0 [B, n] on
    window ``k`` of the float64 setup ``s64``."""
    pm = s64.prob_mpc
    Xw, Uw = track_window(s64.X_track, s64.U_track, k, pm.N)
    cost = retarget_tracking(pm.cost, Xw, Uw)
    return cost.total(pm.dynamics.rollout(x0, U), U)


def family_run(family: str, B: int = B_DEFAULT, T: int = T_STEPS,
               device="cuda", setup=None) -> dict:
    """Both routes from the same carry at every step of one family's chain;
    returns the family's row (scores, gate)."""
    dev = torch.device(device)
    su = SETUPS[family](torch.float32, device=dev) if setup is None else setup
    s64 = SETUPS[family](torch.float64, device="cpu",
                         track=(su.X_track.double().cpu(),
                                su.U_track.double().cpu()))
    steps = {label: make_step(su, opts=dataclasses.replace(
        su.opts, fused_expansion=flag))[0] for label, flag in ROUTES}
    init = make_step(su)[1]
    noise = torch.as_tensor(np.random.default_rng(su.noise_seed)
                            .standard_normal((T, B, 6)),
                            dtype=torch.float32, device=dev)
    carry0 = init(B)
    compile_s = {}
    for label, step in steps.items():        # capture and warm up
        _sync(dev)
        t0 = time.perf_counter()
        step(carry0, noise[0], 0)
        _sync(dev)
        compile_s[label] = time.perf_counter() - t0

    carry = carry0
    gaps, ms = [], {label: [] for label in steps}
    status = {label: [] for label in steps}
    viol = {label: [] for label in steps}
    launches = {label: [0, 0] for label in steps}
    for t in range(T):
        outs = {}
        # the split route first, from the carry the fused route advances
        for label in ("unfused", "fused"):
            c0 = (riccati_fused.launch_count, riccati.launch_count)
            _sync(dev)
            t0 = time.perf_counter()
            nxt, outs[label] = steps[label](carry, noise[t], t)
            _sync(dev)
            ms[label].append((time.perf_counter() - t0) * 1e3)
            launches[label][0] += riccati_fused.launch_count - c0[0]
            launches[label][1] += riccati.launch_count - c0[1]
            status[label].append(outs[label].status.cpu())
            viol[label].append(outs[label].viol.double().cpu())
            if label == "fused":
                carry = nxt
        x0 = outs["fused"].x0.double().cpu()
        Jf = true_costs(s64, t + 1, x0, outs["fused"].U.double().cpu())
        Ju = true_costs(s64, t + 1, x0, outs["unfused"].U.double().cpu())
        gaps.append((Jf - Ju) / Ju.abs().clamp(min=1e-12))
    g = torch.cat(gaps)
    ag = g.abs()
    succ = {k: float(torch.cat(v).double().mean()) for k, v in status.items()}
    mv = {k: float(torch.cat(v).max()) for k, v in viol.items()}
    row = dict(
        lanes=B, steps=T,
        success_fused=succ["fused"], success_unfused=succ["unfused"],
        max_viol_fused=mv["fused"], max_viol_unfused=mv["unfused"],
        gap_abs_max=float(ag.max()),
        gap_abs_p99=float(torch.quantile(ag, 0.99)),
        gap_abs_mean=float(ag.mean()),
        gap_signed_mean=float(g.mean()),
        compile_s_fused=compile_s["fused"],
        compile_s_unfused=compile_s["unfused"],
        step_ms_p50_fused=float(np.median(ms["fused"])),
        step_ms_p50_unfused=float(np.median(ms["unfused"])),
        launches={k: {"fused_expand_backward": v[0], "batched_riccati": v[1]}
                  for k, v in launches.items()})
    routes_ok = dev.type != "cuda" or (
        launches["fused"][0] > 0 and launches["fused"][1] == 0
        and launches["unfused"][1] > 0 and launches["unfused"][0] == 0)
    row["gate_pass"] = bool(
        row["success_fused"] >= row["success_unfused"]
        and abs(row["gap_signed_mean"]) <= GATE_BIAS
        and row["gap_abs_p99"] <= GATE_P99
        and row["max_viol_fused"] <= max(row["max_viol_unfused"],
                                         su.opts.constraint_tolerance)
        and routes_ok)
    return row


def run(B: int = B_DEFAULT, T: int = T_STEPS, device="cuda",
        families=FAMILIES, setups=None) -> dict:
    """Every family's row and the overall gate. ``setups``: {family: a
    float32 ``bench/conic.py`` setup on ``device``} to use instead of
    building (and cold-solving) one."""
    res = dict(config=dict(steps=T, batch=B, device=str(device),
                           gate_bias=GATE_BIAS, gate_p99=GATE_P99,
                           metric="per-lane relative true-cost gap, fused "
                                  "vs split route from the identical warm "
                                  "carry"))
    for family in families:
        res[family] = family_run(family, B, T, device,
                                 (setups or {}).get(family))
    res["gate_pass"] = all(res[f]["gate_pass"] for f in families)
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=B_DEFAULT)
    ap.add_argument("--steps", type=int, default=T_STEPS)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fused_check compares the kernels' routes on a CUDA "
                         "device; none is available")
    from .flagship import power_limit
    res = run(args.batch, args.steps, "cuda")
    res["card"] = power_limit()
    print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    if not res["gate_pass"]:
        raise SystemExit("fused_check: a gate failed")


if __name__ == "__main__":
    main()
