"""The quadruped trot as a fleet of Woofers re-solved in lockstep: n = m =
12, N = 15 knots 0.03 s apart, one SOC friction cone a foot and one NONPOS
block of the vertical forces' bounds (``quadruped_trot_N15.json``), in G
gait-phase groups of B / G lanes whose dynamics move with the gait every
step.

The program is the port's own controller: ``controller.build_mpc_problem``
(the tracking cost about x_des, the cones and bounds) and, per window and
group, ``episode.trot_windows`` (the controller's linearization on the
whole-millisecond contact schedule, built in float64 on the CPU and cast),
stepped by ``mpc.make_mpc_step(dynamics_fn=...)`` on its graphed route,
uncompacted (compaction refuses grouped data), warm-started from the
shifted controls and duals. The plain reference (``reference/quadruped.py``)
computes the same windows from the configuration's published parameters.

A lane's window index is ``(t + 1) G + its group`` (lane b in group
b // (B / G)): the reference's key.
"""
from __future__ import annotations

import torch

from benchmark import programs
from benchmark.reference import quadruped as ref_quadruped


def _check_robot(spec: dict) -> None:
    """The port models one Woofer: the configuration's robot must be it."""
    from altro_tpu_torch.models.quadruped.config import woofer

    have = {**{k: getattr(woofer.inertial, k) for k in
               ("frame_mass", "module_mass", "upper_link_mass")},
            "body_inertia": [woofer.inertial.body_ix, woofer.inertial.body_iy,
                             woofer.inertial.body_iz],
            **{k: getattr(woofer.geometry, k) for k in
               ("hip_center_x", "hip_center_y", "abduction_offset",
                "foot_radius")}}
    if have != spec["robot"]:
        raise ValueError(f"the port's Woofer {have} is not the "
                         f"configuration's {spec['robot']}")


def mpc_config(spec: dict):
    from altro_tpu_torch.models.quadruped.config import MPCConfig

    c = spec["mpc"]
    if c["gait"] != "trot" or c["friction"] != "soc":
        raise ValueError("the configuration is the SOC trot")
    return MPCConfig(
        N=int(c["N"]), dynamics_discretization=float(c["dt"]),
        update_dt=float(c["dt"]), mu=float(c["mu"]),
        min_vert_force=float(c["min_vert_force"]),
        max_vert_force=float(c["max_vert_force"]),
        stance_height=float(c["stance_height"]), gait_type=c["gait"],
        stance_time=float(c["stance_time"]),
        swing_time=float(c["swing_time"]), linearized_friction=False,
        xy_vel=tuple(c["xy_vel"]), q=tuple(c["q"]), r=tuple(c["r"]))


def build(spec: dict, traffic: dict, device) -> programs.Cell:
    from altro_tpu_torch import mpc
    from altro_tpu_torch.convert import tree_to
    from altro_tpu_torch.models.quadruped import controller, episode

    _check_robot(spec)
    B, T = int(traffic["batch"]), int(traffic["episode_steps"])
    G = int(spec["groups"])
    if B % G:
        raise ValueError(f"a batch of {B} lanes is not {G} equal groups")
    cfg = mpc_config(spec)
    N, n, m = cfg.N, 12, 12
    f32 = torch.float32
    prob64, _ = controller.build_mpc_problem(cfg, torch.float64)
    windows = episode.trot_windows(cfg, prob64, T + 1, G,
                                   int(spec["phase_offset_ms"]))
    pm = tree_to(prob64, device, f32)
    windows = windows.to(device, f32)
    X_track = pm.x0.expand(N, n).contiguous()
    U_track = torch.zeros((N - 1, m), dtype=f32, device=device)
    noise = spec["noise"]
    sigma = float(noise["w"]) * torch.tensor(noise["x0_scale"], dtype=f32,
                                             device=device)

    def noise_model(x_prop, noise_i):
        return x_prop + noise_i * sigma

    opts = programs.solver_options(spec)
    step, init = mpc.make_mpc_step(
        pm, opts, X_track, U_track, noise_model=noise_model,
        warm_start=spec["warm_start"], graphed=True, dynamics_fn=windows)
    reference = ref_quadruped.TrotReference(spec)
    lanes_per_group = B // G

    def window_k(t, lanes):
        return (t + 1) * G + torch.div(lanes, lanes_per_group,
                                       rounding_mode="floor")

    rows = [int(b.Cu.shape[0]) for b in reference.blocks]
    soc = tuple(r for r, b in zip(rows, reference.blocks) if b.kind == "soc")
    groups = {"groups": G}
    kernels = {"kernel_b": (N, n, m, sum(rows), soc, groups),
               "kernel_c": (N, n, m, sum(rows), programs.ladder_rungs(opts),
                            groups),
               "kernel_a": (N, n, m, 1, False, groups)}
    return programs.Cell(
        B=B, n=n, m=m, N=N, T=T, carry0=init(B), step=step,
        window_k=window_k, x0_start=pm.x0.detach().cpu(),
        reference=reference, ref_start=reference.hover,
        success_rate_min=float(spec["success_rate_min"]), kernels=kernels,
        itemsize=pm.x0.element_size())
