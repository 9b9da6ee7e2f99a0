"""Woofer leg forward kinematics (PyTorch counterpart of the forward part
of ``altro_tpu/models/quadruped/kinematics.py``: the parallel-linkage FK
with the gamma/theta parameterisation). Angles alpha = (abduction, alpha2,
alpha3) per leg; 12-vectors are leg-major."""
from __future__ import annotations

import math

import torch

from .config import woofer as _w

UPPER = _w.geometry.upper_link_length
LOWER = _w.geometry.lower_link_length
HIP_LAYOUT = torch.tensor(_w.geometry.hip_layout, dtype=torch.float64)
ABDUCTION = torch.tensor(_w.geometry.abduction_layout, dtype=torch.float64)


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
    gamma = 0.5 * (alpha[2] - alpha[1]) + 0.5 * math.pi
    theta = -0.5 * (alpha[1] + alpha[2])
    d = UPPER * torch.sin(gamma)
    h1 = UPPER * torch.cos(gamma)
    h2 = torch.sqrt(LOWER ** 2 - d ** 2)
    L = h1 + h2
    unrotated = torch.stack([L * torch.sin(theta),
                             ABDUCTION[leg].to(alpha.dtype),
                             -L * torch.cos(theta)])
    return _rotx(alpha[0]) @ unrotated + HIP_LAYOUT[leg].to(alpha.dtype)


def forward_kinematics_all(alpha12):
    """All four feet [12] from the 12-vector of joint angles."""
    return torch.cat([forward_kinematics(alpha12[3 * i:3 * i + 3], i)
                      for i in range(4)])
