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


def project_soc_jacobian(z):
    """Jacobian of ``project_soc`` at z, shape [..., p, p]. Branchless.

    Boundary-case closed form with w = v/a (unit), a = ||v||:
      d proj_v / dv = ((a+s)/(2a)) I - (s/(2a)) w w^T
      d proj_v / ds = w / 2,   d proj_s / dv = w^T / 2,   d proj_s / ds = 1/2

    Every factor is a ratio of same-scale quantities (the boundary branch is
    selected only when a > |s|), so a denormal-scale residual near the apex
    cannot underflow the way a form dividing by a^3 would.
    """
    v, s, a, a_safe = _soc_parts(z)
    p = z.shape[-1]
    kw = dict(dtype=z.dtype, device=z.device)
    w = v / a_safe[..., None]
    wwT = w[..., :, None] * w[..., None, :]
    coef = (a + s) / (2.0 * a_safe)
    Jvv = (coef[..., None, None] * torch.eye(p - 1, **kw)
           - (s / (2.0 * a_safe))[..., None, None] * wwT)
    Jvs = w / 2.0
    top = torch.cat([Jvv, Jvs[..., :, None]], dim=-1)
    bot = torch.cat([Jvs, torch.full_like(s[..., None], 0.5)], dim=-1)
    J_boundary = torch.cat([top, bot[..., None, :]], dim=-2)
    eye_p = torch.eye(p, **kw).expand(J_boundary.shape)
    inside = (a <= s)[..., None, None]
    in_polar = (a <= -s)[..., None, None]
    return torch.where(inside, eye_p,
                       torch.where(in_polar, torch.zeros_like(J_boundary),
                                   J_boundary))


def soc_polar_curvature_factors(z):
    """Exact diag + rank-2 factorization of the SOC polar-projection
    Jacobian: J_polar(z) = diag(w) + c1 u1 u1' + c2 u2 u2'.

    With z = (v, s), a = ||v||, v_hat = v / a, gamma = (a - s) / (2a):

      inside  (a <= s):  w = 0,                  c1 = c2 = 0
      polar   (a <= -s): w = 1,                  c1 = c2 = 0
      boundary:          w = (gamma, ..., gamma, 0),
                         c1 = -gamma, u1 = (v_hat, 0),
                         c2 = 1/2,    u2 = (-v_hat, 1)

    Shapes: z [..., p] -> w [..., p], c1/c2 [...], u1/u2 [..., p].
    """
    v, s, a, a_safe = _soc_parts(z)
    p = z.shape[-1]
    vh = v / a_safe[..., None]
    gamma = (a - s) / (2.0 * a_safe)
    inside = a <= s
    in_polar = a <= -s
    bnd = (~(inside | in_polar)).to(z.dtype)
    head = torch.ones(p, dtype=z.dtype, device=z.device)
    head[-1] = 0.0
    w = ((bnd * gamma)[..., None] * head
         + in_polar.to(z.dtype)[..., None] * torch.ones_like(head))
    c1 = -(bnd * gamma)
    c2 = 0.5 * bnd
    u1 = torch.cat([vh, torch.zeros_like(s)[..., None]], dim=-1)
    u2 = torch.cat([-vh, torch.ones_like(s)[..., None]], dim=-1)
    return w, c1, u1, c2, u2


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


def project_polar_jacobian(cone: Cone, z):
    """Jacobian of ``project_polar`` at z, shape [..., p, p] (symmetric
    PSD): the Gauss-Newton curvature of the conic AL penalty."""
    p = z.shape[-1]
    eye = torch.eye(p, dtype=z.dtype, device=z.device)
    if cone == Cone.ZERO:
        return eye.expand(z.shape + (p,))
    if cone == Cone.NONPOS:
        return (z > 0.0).to(z.dtype)[..., :, None] * eye
    if cone == Cone.SOC:
        return eye - project_soc_jacobian(z)
    raise ValueError(f"unknown cone {cone!r}")


def violation(cone: Cone, c):
    """Elementwise infeasibility vector c - proj_K(c); its inf-norm is the
    constraint violation used for AL termination."""
    return c - project(cone, c)


def in_cone(cone: Cone, c, tol: float = 0.0):
    """Boolean [...]: whether c [..., p] lies within ``tol`` (inf-norm) of
    the cone."""
    return torch.amax(torch.abs(violation(cone, c)), dim=-1) <= tol
