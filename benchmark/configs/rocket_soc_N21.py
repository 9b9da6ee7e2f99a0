"""The conic rocket landing MPC: n=6, m=3, N_mpc=21 windows of a 301-knot
landing, three SOC blocks of 4, 4 and 7 rows, tracking-seeded warm starts
with fresh duals and the straggler-compaction schedule the JAX package's
conic benchmark ships (``rocket_soc_N21.json``).

The tracking reference is the plain reference's solution of the long
landing problem (``reference/rocket_track.json``), rounded to float32 and
handed to the program and to the reference alike; the program builds the
landing's dynamics and cones with the port's ``models.rocket`` from the
configuration's physical parameters.
"""
from __future__ import annotations

import torch

from benchmark import programs
from benchmark.reference import rocket as ref_rocket


def build(spec: dict, traffic: dict, device) -> programs.Cell:
    from altro_tpu_torch import mpc
    from altro_tpu_torch.models import rocket

    n, m, N = spec["n"], spec["m"], spec["N_mpc"]
    X64, U64 = ref_rocket.load_track()
    data = {"X_track": X64.float(), "U_track": U64.float()}
    reference = ref_rocket.tracking_mpc(spec, data)

    model, cold = spec["model"], spec["cold"]
    prob = rocket.rocket_problem(
        N=int(cold["knots"]), tf=float(cold["tf"]), x0=tuple(model["x0"]),
        gravity=tuple(model["gravity"]), mass=float(model["mass"]),
        omega_planet=tuple(model["omega_planet"]),
        per_weight_max=float(model["per_weight_max"]),
        theta_thrust_max=float(model["theta_thrust_max"]),
        theta_glideslope=float(model["theta_glideslope"]),
        glide_recover_k=int(model["glide_recover_k"]),
        dtype=torch.float32, device=device)
    X_track = data["X_track"].to(device)
    U_track = data["U_track"].to(device)
    w = spec["tracking"]
    pm = mpc.gen_tracking_mpc(prob, X_track, U_track, N, Qk=w["Q"],
                              Rk=w["R"], Qfk=w["Qf"], dt=w["dt"])
    noise = spec["noise"]
    opts = programs.solver_options(spec)
    rows = [int(b.Cx.shape[0]) for b in reference.blocks]
    soc = tuple(r for r, b in zip(rows, reference.blocks) if b.kind == "soc")
    kernels = {"kernel_b": (N, n, m, sum(rows), soc),
               "kernel_c": (N, n, m, sum(rows), programs.ladder_rungs(opts)),
               "kernel_a": (N, n, m, 1, False)}
    return programs.tracking_cell(
        pm, opts, X_track, U_track, traffic=traffic, spec=spec,
        noise_model=rocket.rocket_noise_model(float(noise["wp"]),
                                              float(noise["wv"])),
        reference=reference,
        ref_start=lambda L: ref_rocket.hover(spec, L, N),
        kernels=kernels, warm_start=spec["warm_start"],
        compaction=spec["compaction"])
