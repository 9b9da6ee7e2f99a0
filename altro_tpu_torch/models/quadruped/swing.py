"""Swing-leg controller: cubic spline foot trajectories and a Cartesian PD
force around them (PyTorch counterpart of
``altro_tpu/models/quadruped/swing.py``; kp = omega^2, kd = 2 zeta omega).

The functions take one leg or the four legs at once: every per-leg input
carries a leading leg axis or none. A spline is the monomial cubic
[t^3, t^2, t, 1] in absolute time, as in the JAX package, its coefficients
from a 4 x 4 solve (``torch.linalg.solve_ex``: no singularity check on the
host, so the solve can be captured in a CUDA graph). Over a swing at a time
of order seconds these systems are ill-conditioned (condition number up to
~1e9 near t = 2 s), so two LU factorizations, or two LAPACKs, agree on the
coefficients only to ~1e-9 of their size; the spline's values near its
interval agree far better.
"""
from __future__ import annotations

import torch

from .config import woofer as _w

FOOT_RADIUS = _w.geometry.foot_radius


def _rows(t):
    """Value and slope rows [..., 4] of the monomial cubic at t."""
    o, z = torch.ones_like(t), torch.zeros_like(t)
    t2 = t * t
    return (torch.stack([t2 * t, t2, t, o], -1),
            torch.stack([3 * t2, 2 * t, o, z], -1))


def _solve(A, b):
    return torch.linalg.solve_ex(A, b)[0]


def _cubic_coeffs_pv(t0, tf, p0, pf, v0, vf):
    """Cubics [..., 4, k] through (t0, p0) and (tf, pf) with slopes v0 and
    vf; p0, pf, v0, vf [..., k] (k columns share the matrix)."""
    v_t0, s_t0 = _rows(t0)
    v_tf, s_tf = _rows(tf)
    A = torch.stack(torch.broadcast_tensors(v_t0, v_tf, s_t0, s_tf), -2)
    return _solve(A, torch.stack(torch.broadcast_tensors(p0, pf, v0, vf),
                                 -2))


def _cubic_coeffs_z(t0, tf, z0, zf, z_mid, vf):
    """The height cubics [..., 4]: through (t0, z0), (tf, zf) and the
    mid-swing point ((t0 + tf) / 2, z_mid), with slope vf at tf."""
    v_t0, _ = _rows(t0)
    v_tf, s_tf = _rows(tf)
    v_tm, _ = _rows(0.5 * (tf + t0))
    A = torch.stack(torch.broadcast_tensors(v_t0, v_tf, v_tm, s_tf), -2)
    b = torch.stack(torch.broadcast_tensors(z0, zf, z_mid, vf), -1)
    return _solve(A, b[..., None])[..., 0]


def foot_trajectory_coeffs(x_est, rot, foot_loc_cur_b, foot_vel_b,
                           next_foot_loc, t0, tf, step_height,
                           prev_z_coeffs=None, regen_z: bool = True):
    """Spline coefficients [..., 12] (x, y, z cubics) from the current foot
    state (body frame, [..., 3]) to the planned placement (world frame,
    [..., 3]) over [t0, tf] (tf [...]; held at least 10 ms past t0, so that
    a replan at the end of a swing keeps the system regular). With
    ``regen_z`` False the height cubic is ``prev_z_coeffs`` [..., 4]."""
    foot_loc_cur_n = x_est[0:3] + foot_loc_cur_b @ rot.mT
    foot_vel_n = x_est[6:9] + foot_vel_b @ rot.mT
    tf = torch.maximum(tf, t0 + 0.01)
    zero = torch.zeros_like(foot_vel_n[..., :2])
    cxy = _cubic_coeffs_pv(t0, tf, foot_loc_cur_n[..., :2],
                           next_foot_loc[..., :2], foot_vel_n[..., :2], zero)
    if regen_z or prev_z_coeffs is None:
        z = foot_loc_cur_n[..., 2]
        cz = _cubic_coeffs_z(t0, tf, z, torch.full_like(z, FOOT_RADIUS),
                             torch.full_like(z, step_height),
                             torch.zeros_like(z))
    else:
        cz = prev_z_coeffs
    return torch.cat([cxy.mT.flatten(-2), cz], -1)


def swing_foot_target(coeffs, t):
    """Desired world position and velocity [..., 3] at time t of the
    splines coeffs [..., 12]."""
    t_p, t_v = _rows(t)
    c = coeffs.unflatten(-1, (3, 4))
    return (c @ t_p[..., None])[..., 0], (c @ t_v[..., None])[..., 0]


def swing_pd_force(x_est, rot, coeffs, foot_loc_cur_b, foot_vel_cur_b, t,
                   omega: float = 100.0, zeta: float = 1.0):
    """Cartesian PD force [..., 3] (body frame) around the splines (the
    torque map is ``kinematics.force_to_torque``)."""
    kp = omega * omega
    kd = 2.0 * zeta * omega
    r_des_n, v_des_n = swing_foot_target(coeffs, t)
    r_des_b = (r_des_n - x_est[0:3]) @ rot
    v_des_b = (v_des_n - x_est[6:9]) @ rot
    return kp * (r_des_b - foot_loc_cur_b) + kd * (v_des_b - foot_vel_cur_b)
