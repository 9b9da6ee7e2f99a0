"""Woofer leg kinematics (PyTorch counterpart of
``altro_tpu/models/quadruped/kinematics.py``): the parallel-linkage forward
kinematics with the gamma/theta parameterisation, its Jacobian, the
force-to-torque map tau = J^T f and the analytic inverse kinematics. Angles
alpha = (abduction, alpha2, alpha3) per leg; 12-vectors are leg-major.

The Jacobian is the forward map's derivative in closed form (the JAX
package differentiates it with ``jax.jacfwd``; the two agree to round-off).
The ``*_all`` forms and :func:`force_to_torque` work on the four legs at
once. The layout constants are taken onto the input's device and dtype once
per pair (:func:`_layout`), so no call copies from the host.
"""
from __future__ import annotations

import functools
import math

import torch

from .config import woofer as _w

UPPER = _w.geometry.upper_link_length
LOWER = _w.geometry.lower_link_length
HIP_LAYOUT = torch.tensor(_w.geometry.hip_layout, dtype=torch.float64)
ABDUCTION = torch.tensor(_w.geometry.abduction_layout, dtype=torch.float64)


@functools.lru_cache(maxsize=None)
def _layout(device, dtype):
    """(HIP_LAYOUT [4, 3], ABDUCTION [4]) on ``device`` in ``dtype``."""
    return HIP_LAYOUT.to(device, dtype), ABDUCTION.to(device, dtype)


def _rotx(a):
    """Rotation about the x axis by a (any leading shape)."""
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack([
        torch.stack([o, z, z], -1),
        torch.stack([z, c, -s], -1),
        torch.stack([z, s, c], -1),
    ], -2)


def forward_kinematics(alpha, leg: int):
    """Body-frame foot position [3] of one leg from its angles [3]."""
    hip, ab = _layout(alpha.device, alpha.dtype)
    gamma = 0.5 * (alpha[2] - alpha[1]) + 0.5 * math.pi
    theta = -0.5 * (alpha[1] + alpha[2])
    d = UPPER * torch.sin(gamma)
    h1 = UPPER * torch.cos(gamma)
    h2 = torch.sqrt(LOWER ** 2 - d ** 2)
    L = h1 + h2
    unrotated = torch.stack([L * torch.sin(theta), ab[leg],
                             -L * torch.cos(theta)])
    return _rotx(alpha[0]) @ unrotated + hip[leg]


def forward_kinematics_all(alpha12):
    """All four feet [12] from the 12-vector of joint angles."""
    return torch.cat([forward_kinematics(alpha12[3 * i:3 * i + 3], i)
                      for i in range(4)])


def _jacobians(alpha, ab):
    """d foot / d alpha [..., 3, 3] of legs with angles alpha [..., 3] and
    abduction offsets ab [...]: the forward map's chain rule written out
    (gamma and theta are linear in alpha2, alpha3; L depends on gamma)."""
    a0, a1, a2 = alpha[..., 0], alpha[..., 1], alpha[..., 2]
    gamma = 0.5 * (a2 - a1) + 0.5 * math.pi
    theta = -0.5 * (a1 + a2)
    sg, cg = torch.sin(gamma), torch.cos(gamma)
    st, ct = torch.sin(theta), torch.cos(theta)
    d = UPPER * sg
    h2 = torch.sqrt(LOWER ** 2 - d ** 2)
    L = UPPER * cg + h2
    dL = -UPPER * sg - d * (UPPER * cg) / h2          # dL / dgamma
    z = torch.zeros_like(a0)
    unrot = torch.stack([L * st, ab.expand_as(a0), -L * ct], -1)
    du_dg = torch.stack([dL * st, z, -dL * ct], -1)   # d unrot / dgamma
    du_dt = torch.stack([L * ct, z, L * st], -1)      # d unrot / dtheta
    du1 = -0.5 * du_dg - 0.5 * du_dt
    du2 = 0.5 * du_dg - 0.5 * du_dt
    c0, s0 = torch.cos(a0), torch.sin(a0)
    drot = torch.stack([torch.stack([z, z, z], -1),
                        torch.stack([z, -s0, -c0], -1),
                        torch.stack([z, c0, -s0], -1)], -2)
    rot = _rotx(a0)
    cols = [drot @ unrot[..., None], rot @ du1[..., None],
            rot @ du2[..., None]]
    return torch.cat(cols, -1)


def leg_jacobian(alpha, leg: int):
    """d foot / d alpha [3, 3] of one leg at angles alpha [3]."""
    _, ab = _layout(alpha.device, alpha.dtype)
    return _jacobians(alpha, ab[leg])


def force_to_torque(f12, alpha12):
    """tau = J^T f per leg: joint torques [12] of foot forces f12 [12] at
    joint angles alpha12 [12]."""
    _, ab = _layout(alpha12.device, alpha12.dtype)
    J = _jacobians(alpha12.reshape(4, 3), ab)
    return (J.mT @ f12.reshape(4, 3, 1)).reshape(12)


def _inverse(foot, hip, ab):
    """Joint angles [..., 3] of body-frame feet [..., 3] with their hips
    [..., 3] and abduction offsets [...].

    With the hip-relative target r: L^2 = |r|^2 - ab^2, cos(gamma) =
    (L^2 + l_u^2 - l_l^2) / (2 L l_u) (clipped to [-1, 1]), theta from the
    leg-plane components, alpha1 the y-z rotation taking (ab, -rho) onto
    (r_y, r_z); the squares under the roots are floored at 1e-10."""
    r = foot - hip
    r0, r1, r2 = r[..., 0], r[..., 1], r[..., 2]
    L2 = torch.clamp(torch.sum(r * r, -1) - ab * ab, min=1e-10)
    L = torch.sqrt(L2)
    cg = torch.clamp((L2 + UPPER ** 2 - LOWER ** 2) / (2.0 * L * UPPER),
                     -1.0, 1.0)
    gamma = torch.arccos(cg)
    rho = torch.sqrt(torch.clamp(r1 ** 2 + r2 ** 2 - ab * ab, min=1e-10))
    theta = torch.atan2(r0, rho)
    alpha1 = torch.atan2(r2, r1) - torch.atan2(-rho, ab)
    alpha1 = torch.atan2(torch.sin(alpha1), torch.cos(alpha1))   # wrap
    alpha2 = -theta - (gamma - 0.5 * math.pi)
    alpha3 = -theta + (gamma - 0.5 * math.pi)
    return torch.stack([alpha1, alpha2, alpha3], -1)


def inverse_kinematics(foot_pos, leg: int):
    """Joint angles [3] of one leg from its body-frame foot position [3]
    (the inverse of :func:`forward_kinematics`)."""
    hip, ab = _layout(foot_pos.device, foot_pos.dtype)
    return _inverse(foot_pos, hip[leg], ab[leg])


def inverse_kinematics_all(feet12):
    """Joint angles [12] of the four legs from their feet [12]."""
    hip, ab = _layout(feet12.device, feet12.dtype)
    return _inverse(feet12.reshape(4, 3), hip, ab).reshape(12)
