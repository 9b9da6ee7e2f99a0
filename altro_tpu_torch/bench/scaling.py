"""Multi-card scaling study: MPC throughput against the number of cards the
scenario batch is sharded over (the port's counterpart of
``altro_tpu/bench/scaling.py``).

The flagship's tracking MPC (n=12, m=6, N_mpc=30, float32) runs as the
sharded step (``parallel.sharded_mpc_step``) at ``batch_per_device`` lanes
per card, one launch of ranks per card count in (1, 2, 4, 8), the cards
of one host: each rank on a card of its own (NCCL), so a count above the
host's cards is written "not measured", never run as several ranks on one
card. ``--device cpu`` spawns gloo ranks on the CPU instead (a check of
the sharded program, not of bandwidth). Rows: devices, batch,
solves_per_s (B * steps over the slowest rank's wall of ``steps`` steps
after a warm-up step), n_success (of the last step) and efficiency
(solves_per_s over devices times the one-card row's).

Run: ``python -m altro_tpu_torch.bench.scaling [--batch-per-device 64]
[--steps 10] [--device cpu]`` (``--device cpu``: 1 and 2 ranks).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from ..models import random_linear as rl
from ..parallel.sharding import ScenarioMesh, launch, sharded_mpc_step
from ..solver.options import SolverOptions

# the card counts of a study: one host's cards (the JAX module's 16 and 32
# span hosts, which the ranks' TCP address on this host does not); on the
# CPU two ranks
SIZES = {"cuda": (1, 2, 4, 8), "cpu": (1, 2)}
NOT_MEASURED = "not measured"
OPTS = dict(cost_tolerance=1e-4, gradient_tolerance=1e-4,
            constraint_tolerance=1e-4, penalty_initial=1e3,
            penalty_scaling=100.0, reset_duals=False)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def scaling_rank(prob_mpc, X_track, U_track, noise, *,
                 mesh: ScenarioMesh) -> dict:
    """One rank of a scaling row: the cold batched solve of its lanes, a
    warm-up step (which captures the step's graphs), then ``len(noise) - 1``
    timed steps. Returns the slowest rank's wall seconds of the timed steps
    and the fleet's successes of the last step."""
    step = sharded_mpc_step(prob_mpc, SolverOptions(**OPTS), X_track,
                            U_track, mesh)
    B = noise.shape[1]
    state = step.init_state(prob_mpc.x0.expand(B, prob_mpc.n))
    state, _ = step(state, mesh.shard(noise[0]))
    _sync(mesh.device)
    dist.barrier()
    t0 = time.perf_counter()
    for t in range(1, len(noise)):
        state, metrics = step(state, mesh.shard(noise[t]))
    _sync(mesh.device)
    wall = torch.tensor(time.perf_counter() - t0, dtype=torch.float64,
                        device=mesh.device)
    mesh.all_reduce(wall, dist.ReduceOp.MAX)
    return {"wall_s": float(wall), "n_success": int(metrics[2])}


def measure(batch_per_device: int = 64, steps: int = 10, n: int = 12,
            m: int = 6, N_mpc: int = 30, dtype=torch.float32,
            device: str = "cuda") -> list:
    """The scaling rows (module docstring) for every count in
    SIZES[device]. On "cuda" a count above ``torch.cuda.device_count()`` is
    written "not measured"; with no card at all it raises."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the scaling study on cards needs a CUDA device")
    available = (torch.cuda.device_count() if device == "cuda"
                 else SIZES["cpu"][-1])
    rng = np.random.default_rng(1)
    N_track = N_mpc + steps + 2
    prob = rl.gen_random_linear(rng, n, m, N_track, dtype=dtype)
    X_track, U_track = rl.gen_trajectory(rng, prob, N_track)
    prob_mpc = rl.gen_tracking_mpc(prob, X_track, U_track, N_mpc)
    rows = []
    for nd in SIZES[device]:
        B = batch_per_device * nd
        if nd > available:
            rows.append(dict(devices=nd, batch=B, solves_per_s=NOT_MEASURED,
                             n_success=NOT_MEASURED))
            print(f"devices={nd} B={B}: not measured ({available} "
                  f"device(s) on this host)", flush=True)
            continue
        # the warm-up step's noise row first, then the timed steps'
        noise = torch.as_tensor(rng.standard_normal((steps + 1, B, n)),
                                dtype=dtype)
        res = launch([(scaling_rank, prob_mpc, X_track, U_track, noise)],
                     nd, device)[0][0]
        sps = B * steps / res["wall_s"]
        rows.append(dict(devices=nd, batch=B, solves_per_s=sps,
                         n_success=res["n_success"]))
        print(f"devices={nd} B={B}: {sps:.0f} solves/s "
              f"({res['n_success']}/{B} success)", flush=True)
    base = rows[0]["solves_per_s"]
    for r in rows:
        r["efficiency"] = (NOT_MEASURED if r["solves_per_s"] == NOT_MEASURED
                           else r["solves_per_s"] / (base * r["devices"]))
    return rows


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch-per-device", type=int, default=64)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args()
    if args.device == "cuda":
        from .flagship import power_limit
        print(f"card: {power_limit()}", flush=True)
    rows = measure(args.batch_per_device, args.steps, device=args.device)
    print(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
