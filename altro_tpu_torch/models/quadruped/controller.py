"""Quadruped trot MPC problem (PyTorch counterpart of the problem part of
``altro_tpu/models/quadruped/controller.py``): the LQR tracking objective
around the desired stance, one friction block per foot (the NONPOS pyramid
or the SOC cone) and the vertical-force bounds, relinearized per contact
schedule."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...constraints import (bound_constraint, friction_cone,
                            linearized_friction)
from ...costs import lqr_objective
from ...dynamics import LTVDynamics
from ...problem import Problem
from .config import MPCConfig, woofer as _w
from .srb import linearize_horizon

SPRUNG_MASS = _w.inertial.sprung_mass


def build_mpc_problem(cfg: MPCConfig, dtype=torch.float64, device=None):
    """The MPC problem's static parts: the LQR objective tracking x_des,
    the per-foot friction blocks and the vertical-force bound block; the
    dynamics stacks are placeholders, relinearized for every solve.
    Returns (problem, x_des [12])."""
    N, n, m = cfg.N, 12, 12
    kw = dict(dtype=dtype, device=device)
    Q = torch.diag(torch.tensor(cfg.q, **kw))
    R = torch.diag(torch.tensor(cfg.r, **kw))
    x_des = torch.tensor(
        [0.0, 0.0, cfg.stance_height, 0.0, 0.0, cfg.yaw_angle,
         cfg.xy_vel[0], cfg.xy_vel[1], 0.0, 0.0, 0.0, cfg.omega_z], **kw)
    cost = lqr_objective(Q, R, Q, x_des, N, dt=cfg.dynamics_discretization)

    friction = linearized_friction if cfg.linearized_friction else \
        friction_cone
    cons = [friction(N, n, m, cfg.mu, (3 * leg, 3 * leg + 1, 3 * leg + 2),
                     **kw) for leg in range(4)]
    u_min = np.full(m, -np.inf)
    u_min[2::3] = cfg.min_vert_force
    u_max = np.full(m, np.inf)
    u_max[2::3] = cfg.max_vert_force
    cons.append(bound_constraint(N, n, m, u_min=u_min, u_max=u_max, **kw))

    dyn = LTVDynamics(A=torch.eye(n, **kw).expand(N - 1, n, n).contiguous(),
                      B=torch.zeros((N - 1, n, m), **kw),
                      d=torch.zeros((N - 1, n), **kw))
    return Problem(dynamics=dyn, cost=cost, constraints=tuple(cons),
                   x0=x_des), x_des


def _linearized_problem(prob: Problem, x_curr, x_ref, contacts, foot_locs,
                        dt_mpc) -> Problem:
    """The problem instance of one contact schedule: dynamics linearized
    about x_ref and the gravity-distributing stance forces (m g / stance
    feet, vertical, per stance foot), x0 = x_curr."""
    nst = torch.clamp(torch.sum(contacts, dim=1, keepdim=True), min=1.0)
    fz_ref = SPRUNG_MASS * 9.81 / nst * contacts                 # [N, 4]
    u_ref = torch.zeros((prob.N, 12), dtype=x_curr.dtype,
                        device=x_curr.device)
    u_ref[:, 2::3] = fz_ref
    dyn = linearize_horizon(x_ref, u_ref, foot_locs, contacts, dt_mpc)
    return dataclasses.replace(prob, dynamics=dyn, x0=x_curr)
