"""Single-rigid-body dynamics of the quadruped MPC and of its closed-loop
plant (PyTorch counterpart of ``altro_tpu/models/quadruped/srb.py``).

State x = [p(3), mrp(3), v(3), omega_body(3)], control u = 4 world-frame
contact forces (12). The MPC's per-knot dynamics are the Euler-discretized
linearization A_d = I + A_c dt, B_d = B_c dt, d = (f(xbar, ubar) - A_c xbar
- B_c ubar) dt, with A_c and B_c by forward-mode autodiff
(``torch.func.jacfwd``, vmapped over knots). The plant of the closed loop
integrates the same nonlinear dynamics with RK4 (:func:`rk4_plant`), with
mass and inertia scales for a plant that differs from the controller's
model. The body constants are taken onto the input's device and dtype once
per pair, so no call copies from the host.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ...dynamics import LTVDynamics
from .config import woofer as _w

SPRUNG_MASS = _w.inertial.sprung_mass
J_BODY = torch.tensor(_w.inertial.body_inertia, dtype=torch.float64)
J_INV = torch.tensor(np.linalg.inv(_w.inertial.body_inertia),
                     dtype=torch.float64)
GRAVITY = 9.81


@functools.lru_cache(maxsize=None)
def _body(device, dtype):
    """(J_BODY, J_INV, the gravity vector [0, 0, -g]) on ``device`` in
    ``dtype``."""
    kw = dict(device=device, dtype=dtype)
    return (J_BODY.to(**kw), J_INV.to(**kw),
            torch.tensor([0.0, 0.0, -GRAVITY], **kw))


def skew(a):
    """3x3 cross-product matrix of a [3]."""
    z = torch.zeros_like(a[0])
    return torch.stack([torch.stack([z, -a[2], a[1]]),
                        torch.stack([a[2], z, -a[0]]),
                        torch.stack([-a[1], a[0], z])])


def _skew_batch(p):
    """Cross-product matrices [..., 3, 3] of p [..., 3]."""
    z = torch.zeros_like(p[..., 0])
    return torch.stack([
        torch.stack([z, -p[..., 2], p[..., 1]], -1),
        torch.stack([p[..., 2], z, -p[..., 0]], -1),
        torch.stack([-p[..., 1], p[..., 0], z], -1),
    ], -2)


def mrp_rotation(phi):
    """Body-to-world rotation matrix of a modified Rodrigues parameter."""
    n2 = torch.sum(phi * phi)
    S = skew(phi)
    denom = (1.0 + n2) ** 2
    return (torch.eye(3, dtype=phi.dtype, device=phi.device)
            + (4.0 * (1.0 - n2) / denom) * S + (8.0 / denom) * (S @ S))


def mrp_kinematics(phi, omega):
    """phidot = 0.25 ((1 - phi'phi) I + 2 skew(phi) + 2 phi phi') omega."""
    n2 = torch.sum(phi * phi)
    M = ((1.0 - n2) * torch.eye(3, dtype=phi.dtype, device=phi.device)
         + 2.0 * skew(phi) + 2.0 * torch.outer(phi, phi))
    return 0.25 * M @ omega


def mrp_from_quat(q):
    """MRP [3] of a quaternion (w, x, y, z), taking the shorter rotation
    (the sign of w flipped to non-negative)."""
    q = torch.where(q[0] < 0, -q, q)
    return q[1:] / (1.0 + q[0])


def continuous_dynamics(x, u, foot_locs, contacts, mass_scale=1.0,
                        inertia_scale=1.0):
    """Nonlinear SRB xdot [12]. foot_locs [4, 3] world-frame foot
    positions, contacts [4] {0,1}; ``mass_scale`` and ``inertia_scale``
    (floats or 0-d tensors) scale the body's mass and inertia away from the
    nominal model (the MPC always linearizes scale 1, which keeps the
    nominal arithmetic bit for bit)."""
    J_body, J_inv, gravity = _body(x.device, x.dtype)
    p = x[0:3]
    phi = x[3:6]
    v = x[6:9]
    omega = x[9:12]
    rot = mrp_rotation(phi)

    pd = v
    phid = mrp_kinematics(phi, omega)

    F = u.reshape(4, 3) * contacts[:, None]
    force_sum = gravity + torch.sum(F, dim=0) / (SPRUNG_MASS * mass_scale)

    r_b = torch.einsum("ji,kj->ki", rot, foot_locs - p)   # rot' (r - p)
    F_b = torch.einsum("ji,kj->ki", rot, F)               # rot' F
    torque_sum = torch.sum(torch.einsum("kij,kj->ki", _skew_batch(r_b), F_b),
                           dim=0)

    omegad = (J_inv / inertia_scale) @ (
        -skew(omega) @ ((J_body * inertia_scale) @ omega) + torque_sum)
    return torch.cat([pd, phid, force_sum, omegad])


def linearize_horizon(x_ref, u_ref, foot_locs, contacts, dt) -> LTVDynamics:
    """Per-knot (A, B, d) stacks of the Euler-discretized linearization.

    x_ref [N, 12], u_ref [N, 12], foot_locs [N, 4, 3], contacts [N, 4];
    returns an N-knot LTVDynamics (stacks of length N-1)."""
    def one(x, u, r, c):
        A_c = jacfwd(lambda xx: continuous_dynamics(xx, u, r, c))(x)
        B_c = jacfwd(lambda uu: continuous_dynamics(x, uu, r, c))(u)
        d_c = continuous_dynamics(x, u, r, c) - A_c @ x - B_c @ u
        n = x.shape[0]
        return (torch.eye(n, dtype=x.dtype, device=x.device) + A_c * dt,
                B_c * dt, d_c * dt)

    A, B, d = vmap(one)(x_ref[:-1], u_ref[:-1], foot_locs[:-1],
                        contacts[:-1])
    return LTVDynamics(A=A.contiguous(), B=B.contiguous(),
                       d=d.contiguous())


def rk4_plant(x, u, foot_locs, contacts, dt, mass_scale=1.0,
              inertia_scale=1.0):
    """One RK4 step of length dt of the nonlinear SRB under the contact
    forces u [12] at the feet foot_locs [4, 3] in contact (contacts [4]):
    the closed loop's plant. ``mass_scale``/``inertia_scale`` != 1 give the
    plant other parameters than the controller's model."""
    def f(xx):
        return continuous_dynamics(xx, u, foot_locs, contacts, mass_scale,
                                   inertia_scale)
    k1 = f(x)
    k2 = f(x + 0.5 * dt * k1)
    k3 = f(x + 0.5 * dt * k2)
    k4 = f(x + dt * k3)
    return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
