"""Rocket soft-landing benchmark (PyTorch counterpart of
``altro_tpu/models/rocket.py``).

- linear rocket model with planet rotation, exact ZOH discretization;
- three SOC families: max thrust ||u|| <= m|g|k, thrust angle
  ||[ux, uy]|| <= tan(theta) uz, glideslope ||[x, y]|| <= tan(theta_gs) z
  active from knot ``glide_recover_k``; or, with ``conic=False``, their
  nonconvex quadratic counterparts ||A z||^2 <= (c'z + offset)^2 (the
  SOC-against-Inequality comparison);
- hover warm start U0 = -m g;
- position/velocity-split MPC process noise.
"""
from __future__ import annotations

import torch

from ..constraints import (goal_constraint, norm_constraint, norm_constraint2,
                           quad_norm_constraint)
from ..costs import lqr_objective
from ..dynamics import lti_dynamics, zoh_discretize
from ..problem import Problem


def skew(w):
    """3x3 cross-product matrix of w [3]."""
    z = torch.zeros((), dtype=w.dtype, device=w.device)
    return torch.stack([torch.stack([z, -w[2], w[1]]),
                        torch.stack([w[2], z, -w[0]]),
                        torch.stack([-w[1], w[0], z])])


def rocket_dynamics(mass, gravity, dt, omega_planet=(0.0, 0.0, 0.0),
                    dtype=torch.float64, device=None):
    """Continuous A = [[0, I], [-skew(w)^2, -2 skew(w)]], B = [[0], [I/m]],
    d = [0; g], discretized by matrix exponential (ZOH). Returns
    (Ad, Bd, dd)."""
    kw = dict(dtype=dtype, device=device)
    w = torch.as_tensor(omega_planet, **kw)
    g = torch.as_tensor(gravity, **kw)
    S = skew(w)
    Z3, I3 = torch.zeros((3, 3), **kw), torch.eye(3, **kw)
    A = torch.cat([torch.cat([Z3, I3], dim=1),
                   torch.cat([-S @ S, -2.0 * S], dim=1)], dim=0)
    B = torch.cat([Z3, I3 / mass], dim=0)
    d = torch.cat([torch.zeros(3, **kw), g])
    return zoh_discretize(A, B, dt, d)


def rocket_problem(N: int = 301, tf: float = 15.0, *,
                   x0=(4.0, 2.0, 20.0, -3.0, 2.0, -5.0),
                   Qk: float = 1e-2, Qfk: float = 1e4, Rk: float = 1.0,
                   gravity=(0.0, 0.0, -9.81), mass: float = 10.0,
                   omega_planet=(0.0, 0.0, 0.0), per_weight_max: float = 2.0,
                   theta_thrust_max: float = 5.0,
                   theta_glideslope: float = 45.0,
                   glide_recover_k: int = 8, include_goal: bool = True,
                   include_thrust_angle: bool = True,
                   include_glideslope: bool = True, conic: bool = True,
                   dtype=torch.float64, device=None) -> Problem:
    """n=6, m=3 soft-landing problem: LQR cost to the origin, a terminal
    goal (ZERO) and the max-thrust, thrust-angle and glideslope blocks,
    second-order cones (``conic``) or their quadratic NONPOS counterparts
    (``QuadNormConstraint``)."""
    n, m = 6, 3
    kw = dict(dtype=dtype, device=device)
    dt = tf / (N - 1)
    x0 = torch.as_tensor(x0, **kw)
    xf = torch.zeros(n, **kw)
    g = torch.as_tensor(gravity, **kw)

    Ad, Bd, dd = rocket_dynamics(mass, g, dt, omega_planet, dtype, device)
    dyn = lti_dynamics(Ad, Bd, N, dd)
    cost = lqr_objective(torch.eye(n, **kw) * Qk, torch.eye(m, **kw) * Rk,
                         torch.eye(n, **kw) * Qfk, xf, N, dt=dt)

    cons = []
    if include_goal:
        cons.append(goal_constraint(N, n, m, xf, **kw))
    u_bnd = mass * abs(float(g[2])) * per_weight_max
    if conic:
        cons.append(norm_constraint(N, n, m, u_bnd, on="control", **kw))
    else:
        cons.append(quad_norm_constraint(N, n, m, torch.eye(3, **kw),
                                         offset=u_bnd, on="control", **kw))
    if include_thrust_angle:
        alpha = torch.tan(torch.deg2rad(torch.tensor(theta_thrust_max,
                                                     **kw)))
        A_ang = torch.tensor([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 0]], **kw)
        c_ang = torch.tensor([0.0, 0.0, 1.0], **kw) * alpha
        if conic:
            cons.append(norm_constraint2(N, n, m, A_ang, c_ang,
                                         on="control", **kw))
        else:
            cons.append(quad_norm_constraint(N, n, m, A_ang, c=c_ang,
                                             on="control", **kw))
    if include_glideslope:
        alpha_g = torch.tan(torch.deg2rad(torch.tensor(theta_glideslope,
                                                       **kw)))
        A_gs = torch.zeros((6, 6), **kw)
        A_gs[0, 0] = A_gs[1, 1] = 1.0
        c_gs = torch.zeros(6, **kw)
        c_gs[2] = alpha_g
        # active from knot glide_recover_k (1-indexed) to N-1
        if conic:
            cons.append(norm_constraint2(N, n, m, A_gs, c_gs, on="state",
                                         start=glide_recover_k - 1, **kw))
        else:
            cons.append(quad_norm_constraint(N, n, m, A_gs, c=c_gs,
                                             on="state",
                                             start=glide_recover_k - 1,
                                             **kw))
    return Problem(dynamics=dyn, cost=cost, constraints=tuple(cons), x0=x0)


def hover_controls(prob: Problem, mass: float = 10.0,
                   gravity=(0.0, 0.0, -9.81)):
    """Hover warm start U0 = -m g, [N-1, 3]."""
    g = torch.as_tensor(gravity, dtype=prob.x0.dtype, device=prob.x0.device)
    return (-mass * g).expand(prob.N - 1, 3).contiguous()


def rocket_noise_model(wp: float = 1e-3, wv: float = 1e-2):
    """Split position/velocity noise, per scenario: the position part is
    scaled by ||pos|| wp, the velocity part by ||vel|| wv. The model maps
    x_prop [B, 6] and standard-normal noise [B, 6] to the noisy state."""
    def model(x_prop, noise_i):
        pos_mag = torch.linalg.vector_norm(x_prop[..., :3], dim=-1,
                                           keepdim=True)
        vel_mag = torch.linalg.vector_norm(x_prop[..., 3:], dim=-1,
                                           keepdim=True)
        noise = torch.cat([noise_i[..., :3] * pos_mag * wp,
                           noise_i[..., 3:] * vel_mag * wv], dim=-1)
        return x_prop + noise

    return model
