"""Convex cone projections (PyTorch counterpart of ``altro_tpu/cones.py``).

Cone conventions (constraint residual ``c`` of length ``p``):

- ``ZERO``   : c == 0
- ``NONPOS`` : c <= 0 elementwise
- ``SOC``    : ||c[:-1]|| <= c[-1]

Every function is branchless (``torch.where``) and batched over leading
axes. The AL penalty uses the *polar* projection; by the Moreau
decomposition ``proj_polar(z) = z - proj_K(z)`` for every cone here.
"""
from __future__ import annotations

import enum

import torch


class Cone(str, enum.Enum):
    """Static cone tag attached to each constraint block."""

    ZERO = "zero"        # equality: c == 0
    NONPOS = "nonpos"    # inequality: c <= 0
    SOC = "soc"          # second-order cone: ||c[:-1]|| <= c[-1]

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.value


def _soc_parts(z):
    """Split z into (v, s, ||v||, safe ||v|| for division). The boundary
    branch (the only one that divides) is selected only when a > |s|, so
    the guard value never leaks into a selected output."""
    v = z[..., :-1]
    s = z[..., -1]
    a = torch.sqrt(torch.sum(v * v, dim=-1))
    a_safe = torch.where(a > 0, a, torch.ones_like(a))
    return v, s, a, a_safe


def project_soc(z):
    """Euclidean projection onto the second-order cone.

    z = (v, s); a = ||v||:
      a <= s        -> z                       (inside)
      a <= -s       -> 0                       (inside the polar)
      otherwise     -> ((a + s) / (2a)) (v, a) (boundary ray)
    """
    v, s, a, a_safe = _soc_parts(z)
    scale = (a + s) / (2.0 * a_safe)
    boundary = torch.cat([scale[..., None] * v, (scale * a)[..., None]],
                         dim=-1)
    inside = (a <= s)[..., None]
    in_polar = (a <= -s)[..., None]
    return torch.where(inside, z,
                       torch.where(in_polar, torch.zeros_like(z), boundary))


def project(cone: Cone, z):
    """Projection onto cone K."""
    if cone == Cone.ZERO:
        return torch.zeros_like(z)
    if cone == Cone.NONPOS:
        return torch.clamp(z, max=0.0)
    if cone == Cone.SOC:
        return project_soc(z)
    raise ValueError(f"unknown cone {cone!r}")


def project_polar(cone: Cone, z):
    """Projection onto the polar cone K^o, used for the AL dual update
    ``lambda <- proj_polar(lambda + rho * c)``."""
    if cone == Cone.ZERO:
        return z                      # polar of {0} is R^p
    if cone == Cone.NONPOS:
        return torch.clamp(z, min=0.0)    # polar of R^p_- is R^p_+
    if cone == Cone.SOC:
        return z - project_soc(z)     # Moreau
    raise ValueError(f"unknown cone {cone!r}")


def violation(cone: Cone, c):
    """Elementwise infeasibility vector c - proj_K(c); its inf-norm is the
    constraint violation used for AL termination."""
    return c - project(cone, c)
