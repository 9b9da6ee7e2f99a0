"""Grasp-optimization benchmark with time-varying second-order-cone
constraints (PyTorch counterpart of ``altro_tpu/models/grasp.py``).

- a 2-contact rigid square (n=6 position/velocity, m=6: two 3-D contact
  forces), mu=0.5, mass=0.2, f_max=3, exact double-integrator dynamics;
- a cubic orientation trajectory theta(t) and its acceleration;
- per-knot contact normals v_i(theta) and torque skews B_i(theta);
- per knot: torque balance [B1 B2] u = [thdd, 0, 0] (ZERO), max normal
  force v_i'F_i <= f_max (NONPOS) and two SOC friction cones
  ||(I - v v')F_i|| <= mu v'F_i.

The whole-horizon contact data lives in stacks; an MPC window's constraint
blocks are cut from them by index (:func:`grasp_constraints`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..cones import Cone
from ..constraints import (ConicConstraint, _range_mask, goal_constraint,
                           linear_constraint, norm_constraint2)
from ..costs import lqr_objective
from ..dynamics import lti_dynamics
from ..problem import Problem


@dataclass
class GraspObject:
    """Square-object data with full-horizon contact stacks (length Nt)."""

    theta: torch.Tensor    # [Nt]
    thdd: torch.Tensor     # [Nt]
    v1: torch.Tensor       # [Nt, 3] inward normal, contact 1
    v2: torch.Tensor       # [Nt, 3]
    B1: torch.Tensor       # [Nt, 3, 3] torque skew, contact 1
    B2: torch.Tensor       # [Nt, 3, 3]
    mu: float = 0.5
    mass: float = 0.2
    f_max: float = 3.0

    @property
    def g(self):
        return torch.tensor([0.0, 0.0, -9.81], dtype=self.theta.dtype,
                            device=self.theta.device)


def _rot3(theta):
    """Rotation about the x axis, [..., 3, 3]."""
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(theta), torch.ones_like(theta)
    return torch.stack([torch.stack([o, z, z], -1),
                        torch.stack([z, c, -s], -1),
                        torch.stack([z, s, c], -1)], -2)


def _skew_batch(p):
    """Cross-product matrices of p [..., 3]."""
    z = torch.zeros_like(p[..., 0])
    return torch.stack([torch.stack([z, -p[..., 2], p[..., 1]], -1),
                        torch.stack([p[..., 2], z, -p[..., 0]], -1),
                        torch.stack([-p[..., 1], p[..., 0], z], -1)], -2)


def make_grasp_object(N: int, tf: float, *, mu=0.5, mass=0.2, f_max=3.0,
                      theta0=0.0, thetaf=np.pi / 4, thetad0=0.0,
                      thetadf=0.15, dtype=torch.float64,
                      device=None) -> GraspObject:
    """Cubic orientation trajectory over [0, tf] at N knots and the rotating
    contact frames."""
    kw = dict(dtype=dtype, device=device)
    dt = tf / (N - 1)
    t0 = 0.0
    A = np.array([[t0**3, t0**2, t0, 1],
                  [tf**3, tf**2, tf, 1],
                  [3 * t0**2, 2 * t0, 1, 0],
                  [3 * tf**2, 2 * tf, 1, 0]])
    c = np.linalg.solve(A, np.array([theta0, thetaf, thetad0, thetadf]))
    ts = torch.as_tensor(np.arange(N) * dt, **kw)
    theta = c[0] * ts**3 + c[1] * ts**2 + c[2] * ts + c[3]
    thdd = 6 * c[0] * ts + 2 * c[1]

    p1_0 = torch.tensor([0.0, -1.0, 0.0], **kw)
    v1_0 = torch.tensor([0.0, 1.0, 0.0], **kw)
    p2_0 = torch.tensor([0.0, 1.0, 0.0], **kw)
    v2_0 = torch.tensor([0.0, -1.0, 0.0], **kw)
    R = _rot3(theta)                                       # [Nt, 3, 3]
    p1 = torch.einsum("kij,j->ki", R, p1_0)
    p2 = torch.einsum("kij,j->ki", R, p2_0)
    v1 = torch.einsum("kij,j->ki", R, v1_0)
    v2 = torch.einsum("kij,j->ki", R, v2_0)
    return GraspObject(theta=theta, thdd=thdd, v1=v1, v2=v2,
                       B1=_skew_batch(p1), B2=_skew_batch(p2), mu=mu,
                       mass=mass, f_max=f_max)


def grasp_dynamics(o: GraspObject, N: int, dt):
    """Exact double-integrator discrete dynamics with both forces and
    gravity."""
    kw = dict(dtype=o.theta.dtype, device=o.theta.device)
    I3 = torch.eye(3, **kw)
    Z3 = torch.zeros((3, 3), **kw)
    Ad = torch.cat([torch.cat([I3, I3 * dt], 1), torch.cat([Z3, I3], 1)], 0)
    Bhalf = torch.cat([I3 * (0.5 * dt**2 / o.mass), I3 * (dt / o.mass)], 0)
    Bd = torch.cat([Bhalf, Bhalf], 1)
    g = o.g
    dd = torch.cat([0.5 * g * dt**2, g * dt])
    return lti_dynamics(Ad, Bd, N, dd)


def grasp_constraints(o: GraspObject, N: int, k0=0,
                      include_goal: bool = False,
                      xf=None) -> Tuple[ConicConstraint, ...]:
    """The constraint window [k0, k0 + N) as four blocks (torque balance,
    max force, two friction cones), cut from the object's stacks. ``k0`` is
    clamped to [0, Nt - N], as ``lax.dynamic_slice`` clamps it. An int64
    tensor ``k0`` [B] gives every lane its own window: per-lane blocks
    (stacks [B, N, ...]; :func:`_lane_windows`)."""
    if isinstance(k0, torch.Tensor):
        if include_goal:
            raise ValueError("per-lane windows take no goal block")
        return _lane_windows(o, N, k0)
    n, m = 6, 6
    kw = dict(dtype=o.theta.dtype, device=o.theta.device)
    k0 = min(max(int(k0), 0), o.theta.shape[0] - N)
    v1, v2 = o.v1[k0:k0 + N], o.v2[k0:k0 + N]
    B1, B2 = o.B1[k0:k0 + N], o.B2[k0:k0 + N]
    thdd = o.thdd[k0:k0 + N]

    # torque balance: [B1 B2] u = [thdd, 0, 0]
    Au_torque = torch.cat([B1, B2], dim=2)                   # [N, 3, 6]
    z = torch.zeros_like(thdd)
    rhs = torch.stack([thdd, z, z], -1)
    torque = linear_constraint(N, n, m, torch.zeros((N, 3, n), **kw),
                               Au_torque, rhs, Cone.ZERO, name="torque", **kw)

    # max normal force: v1'F1 <= f_max, v2'F2 <= f_max
    z3 = torch.zeros_like(v1)
    Au_force = torch.stack([torch.cat([v1, z3], -1),
                            torch.cat([z3, v2], -1)], dim=1)  # [N, 2, 6]
    force = linear_constraint(N, n, m, torch.zeros((N, 2, n), **kw),
                              Au_force, torch.full((N, 2), o.f_max, **kw),
                              Cone.NONPOS, name="max_force", **kw)

    # SOC friction cones ||(I - v v')F_i|| <= mu v'F_i on each force slice
    def cone_block(v, first):
        P = torch.eye(3, **kw) - torch.einsum("ki,kj->kij", v, v)
        zero = torch.zeros_like(P)
        A_full = torch.cat([P, zero] if first else [zero, P], dim=2)
        cvec = o.mu * v
        zv = torch.zeros_like(cvec)
        c_full = torch.cat([cvec, zv] if first else [zv, cvec], dim=1)
        return norm_constraint2(N, n, m, A_full, c_full, on="control", **kw)

    blocks = (torque, force, cone_block(v1, True), cone_block(v2, False))
    if include_goal:
        blocks = (goal_constraint(N, n, m, xf, **kw),) + blocks
    return blocks


def _lane_windows(o: GraspObject, N: int, k0) -> Tuple[ConicConstraint,
                                                      ...]:
    """:func:`grasp_constraints`'s four blocks for every lane's window
    [k0_b, k0_b + N), k0 an integer tensor [B]: the stacks gathered on the
    device (no host sync, so a CUDA graph can capture it) and each block
    built with the int branch's arithmetic over the lane axis, so lane b's
    blocks equal ``grasp_constraints(o, N, int(k0[b]))`` bit for bit."""
    n = 6
    kx = torch.clamp(k0, 0, o.theta.shape[0] - N)
    idx = kx[:, None] + torch.arange(N, device=k0.device)       # [B, N]
    v1, v2, B1, B2, thdd = (s[idx] for s in (o.v1, o.v2, o.B1, o.B2,
                                               o.thdd))
    mask = _range_mask(N, 0, N - 1, o.theta.dtype, o.theta.device)

    def block(Cu, b, cone, name):
        Cx = Cu.new_zeros(Cu.shape[:-1] + (n,))
        return ConicConstraint(Cx=Cx, Cu=Cu.contiguous(), b=b.contiguous(),
                               mask=mask, cone=cone, name=name)

    # torque balance: [B1 B2] u = [thdd, 0, 0]
    z = torch.zeros_like(thdd)
    torque = block(torch.cat([B1, B2], dim=3), -torch.stack([thdd, z, z], -1),
                   Cone.ZERO, "torque")
    # max normal force: v1'F1 <= f_max, v2'F2 <= f_max
    z3 = torch.zeros_like(v1)
    force = block(torch.stack([torch.cat([v1, z3], -1),
                               torch.cat([z3, v2], -1)], dim=2),
                  torch.full(v1.shape[:2] + (2,), -o.f_max, dtype=v1.dtype,
                             device=v1.device), Cone.NONPOS, "max_force")

    # SOC friction cones ||(I - v v')F_i|| <= mu v'F_i, rows (A z, c'z)
    def cone_block(v, first):
        P = (torch.eye(3, dtype=v.dtype, device=v.device)
             - torch.einsum("bki,bkj->bkij", v, v))
        zero = torch.zeros_like(P)
        A_full = torch.cat([P, zero] if first else [zero, P], dim=3)
        cvec = o.mu * v
        zv = torch.zeros_like(cvec)
        c_full = torch.cat([cvec, zv] if first else [zv, cvec], dim=2)
        M = torch.cat([A_full, c_full[:, :, None, :]], dim=2)
        return block(M, M.new_zeros(M.shape[:-1]), Cone.SOC, "norm_soc")

    return (torque, force, cone_block(v1, True), cone_block(v2, False))


def grasp_problem(o: GraspObject, N: int = 61, tf: float = 6.0,
                  x0=(0.0, 3.0, 3.0, 0.0, 0.0, 0.0)) -> Problem:
    """The cold-solve problem: Q = 1e-3 I, R = I, Qf = 10 I to the origin,
    a goal block at the last knot and the four constraint blocks."""
    n, m = 6, 6
    kw = dict(dtype=o.theta.dtype, device=o.theta.device)
    dt = tf / (N - 1)
    xf = torch.zeros(n, **kw)
    cost = lqr_objective(1e-3 * torch.eye(n, **kw), torch.eye(m, **kw),
                         10.0 * torch.eye(n, **kw), xf, N, dt=dt)
    return Problem(dynamics=grasp_dynamics(o, N, dt), cost=cost,
                   constraints=grasp_constraints(o, N, 0, include_goal=True,
                                                 xf=xf),
                   x0=torch.as_tensor(x0, **kw))


def hover_controls(o: GraspObject, N: int):
    """U0 = [0, -1.5, m g / 2, 0, 1.5, m g / 2] at every knot, [N-1, 6]."""
    w = o.mass * 9.81 / 2
    u0 = torch.tensor([0.0, -1.5, w, 0.0, 1.5, w], dtype=o.theta.dtype,
                      device=o.theta.device)
    return u0.expand(N - 1, 6).contiguous()
