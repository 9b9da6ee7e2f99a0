"""Benchmark drivers (the port's counterpart of ``altro_tpu/bench/drivers.py``;
the quadruped's so far).

    python -m altro_tpu_torch.bench.drivers quadruped [--device cpu] [--tf S]

``quadruped``: the reference's quadruped table (quadruped_benchmark.jl), the
closed-loop trot of ``tf`` seconds (2.0) on the single-rigid-body plant in
float64 with the benchmark's options, timing each MPC period in three
fenced sections (``models.quadruped.controller.simulate_host``): the solve
alone (``ms_per_solve``, the reference table's accounting), the schedule and
relinearization (``ms_prep``) and the period's 1 kHz ticks
(``ms_per_period_sim``). Rows ALTRO-QP (linearized friction pyramids) and
ALTRO-SOCP (friction cones), with the keys of the JAX package's rows;
printed with the markdown table, the device with its power limit and the
kernel launches of each row. On a CUDA device every period runs on CUDA
graphs. The OSQP-role and ECOS-role rows need the ADMM oracles, which are
not ported yet; the output says so.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..models.quadruped import config, controller
from ..ops import riccati, riccati_fused, rollout, rollout_al
from ..solver import altro
from ..solver.options import SolverOptions
from .flagship import power_limit

QUAD_OPTS = dict(cost_tolerance=1e-4, constraint_tolerance=1e-4,
                 penalty_initial=10.0, penalty_scaling=100.0,
                 reset_duals=False)
WAITING = ("OSQP-role", "ECOS-role")


def _counts() -> dict:
    return {"batched_ls_rollout": rollout.launch_count,
            "fused_expand_backward": riccati_fused.launch_count,
            "batched_ls_rollout_al": rollout_al.launch_count,
            "batched_riccati": riccati.launch_count,
            "passes": altro.pass_count}


def quadruped_benchmark(tf: float = 2.0, dtype=torch.float64,
                        device="cuda") -> dict:
    """ALTRO-QP and ALTRO-SOCP rows of the closed-loop trot (see the module
    docstring); each row also carries ``launches`` (kernel launches and
    solver-loop passes of its run, the warm-up period's included),
    ``loop_replays``, ``capture_s`` and ``tick_ms``. ``table_md`` is the
    markdown table."""
    opts = SolverOptions(**QUAD_OPTS)
    rows = {}
    for name, lin in (("ALTRO-QP", True), ("ALTRO-SOCP", False)):
        cfg = config.MPCConfig(linearized_friction=lin)
        before = _counts()
        res = controller.simulate_host(cfg, opts, tf=tf, dtype=dtype,
                                       device=device)
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
            launches=launches)
        r = rows[name]
        print(f"  {name}: {r['ms_per_solve']:.3f} ± "
              f"{r['ms_per_solve_std']:.3f} ms/solve "
              f"(+{r['ms_prep']:.3f} prep), {r['ms_per_period_sim']:.3f} ms "
              f"sim per period, {r['mean_iters']:.2f} iters (success "
              f"{r['success']:.2f}); launches {launches}", flush=True)

    lines = ["| configuration | ms/solve | σ | +prep | success |",
             "|---|---|---|---|---|"]
    for k, v in rows.items():
        lines.append(f"| {k} | {v['ms_per_solve']:.3f} | "
                     f"{v['ms_per_solve_std']:.3f} | {v['ms_prep']:.3f} | "
                     f"{v['success']:.2f} |")
    rows["table_md"] = "\n".join(lines)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("benchmark", choices=["quadruped"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without one) or cpu")
    ap.add_argument("--tf", type=float, default=2.0,
                    help="seconds of closed loop (default 2.0)")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("the quadruped benchmark runs on a CUDA device "
                             "unless --device cpu is given; none is "
                             "available")
        where = f"{torch.cuda.get_device_name(0)} [{power_limit()}]"
    else:
        where = "CPU (the kernels' plain versions; no device metric)"
    print(f"== quadruped closed loop, tf={args.tf} s, float64, on {where}",
          flush=True)
    rows = quadruped_benchmark(tf=args.tf, device=dev)
    print(rows["table_md"])
    print(f"({', '.join(WAITING)}: not run; they need the ADMM oracles, "
          "which are not ported yet)")
    print(json.dumps({"device": where, "rows": {
        k: {kk: vv for kk, vv in v.items()
            if kk not in ("mpc_ms", "prep_ms", "tick_ms")}
        for k, v in rows.items() if k != "table_md"}}))


if __name__ == "__main__":
    main()
