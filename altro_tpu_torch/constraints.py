"""Constraint blocks (PyTorch counterpart of ``altro_tpu/constraints.py``):
affine ZERO, NONPOS and SOC blocks,

    c_k = Cx_k @ x_k + Cu_k @ u_k + b_k   in  K       (for knots with mask=1)

and the nonlinear quadratic norm block :class:`QuadNormConstraint`. The
stacks carry a leading knot axis and are shared problem data, or (an
affine block, ``per_lane``) carry a lane axis in front of it: every lane's
own window of a time-varying block ([B, N, p, .]); trajectories and
multipliers carry leading batch axes, and so do a nonlinear block's
Jacobians and curvature, taken at each lane's iterate. The mask [N] is
shared either way.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from .cones import (Cone, project_polar, project_polar_jacobian,
                    soc_polar_curvature_factors, violation)
from .costs import pad_terminal


@dataclass
class ConicConstraint:
    """One block of p-row affine conic constraints applied along the
    horizon: shared stacks [N, p, .], or (``per_lane``) one window per
    lane [B, N, p, .] (a lane axis, never guessed: a shared stack has
    three axes)."""

    Cx: torch.Tensor    # [(B,) N, p, n]
    Cu: torch.Tensor    # [(B,) N, p, m]
    b: torch.Tensor     # [(B,) N, p]
    mask: torch.Tensor  # [N] float {0,1}: knots where the block is active
    cone: Cone
    name: str = ""

    @property
    def per_lane(self) -> bool:
        """Whether the stacks carry a lane axis."""
        return self.Cx.dim() == 4

    @property
    def N(self) -> int:
        return self.Cx.shape[-3]

    @property
    def p(self) -> int:
        return self.Cx.shape[-2]

    def evaluate(self, X, U):
        """Residual stack c [..., N, p]; u at the terminal knot is zero.
        Per-lane stacks take X [B, ..., N, n]: lane b's rows act on every
        trajectory of lane b (the rungs of a ladder)."""
        Up = pad_terminal(U)
        if not self.per_lane:
            return (torch.einsum("kpn,...kn->...kp", self.Cx, X)
                    + torch.einsum("kpm,...km->...kp", self.Cu, Up)
                    + self.b)
        # the lane axis first, then the axes between it and the knot axis
        lead = (X.shape[0],) + (1,) * (X.dim() - 3)
        Cx = self.Cx.reshape(lead + tuple(self.Cx.shape[1:]))
        Cu = self.Cu.reshape(lead + tuple(self.Cu.shape[1:]))
        return ((Cx @ X[..., None])[..., 0] + (Cu @ Up[..., None])[..., 0]
                + self.b.reshape(lead + tuple(self.b.shape[1:])))

    def jacobians(self, X, U):
        """(Cx [(B,) N,p,n], Cu [(B,) N,p,m]): constant for affine
        blocks."""
        del X, U
        return self.Cx, self.Cu

    @property
    def is_affine(self) -> bool:
        return True

    def violations(self, X, U):
        """[..., N, p] infeasibility (c - proj_K(c)), zeroed at inactive
        knots."""
        c = self.evaluate(X, U)
        return violation(self.cone, c) * self.mask[:, None]

    def max_violation(self, X, U):
        """[...] largest |violation| over the knots and rows."""
        return torch.amax(torch.abs(self.violations(X, U)), dim=(-2, -1))


@dataclass
class QuadNormConstraint:
    """Nonlinear (quadratic) norm constraint ||A z||^2 <= (c'z + offset)^2,
    z = x or u: one NONPOS row per knot.

    The nonconvex "naive" counterpart of the SOC norm blocks (the rocket's
    SOC-against-Inequality comparison). The solver consumes it through the
    same block protocol as :class:`ConicConstraint`, with the Jacobians
    re-evaluated at every iterate and the exact constraint curvature
    (:meth:`second_order`) added to the expansion."""

    A: torch.Tensor       # [N, p_rows, dim]
    c: torch.Tensor       # [N, dim]
    offset: torch.Tensor  # [N]
    mask: torch.Tensor    # [N]
    on: str = "control"
    name: str = "quad_norm"
    cone: Cone = Cone.NONPOS

    @property
    def N(self) -> int:
        return self.A.shape[0]

    @property
    def p(self) -> int:
        return 1

    @property
    def is_affine(self) -> bool:
        return False

    @property
    def per_lane(self) -> bool:
        """The stacks are shared (the Jacobians, per lane, are not data)."""
        return False

    def _z(self, X, U):
        return pad_terminal(U) if self.on == "control" else X

    def _parts(self, X, U):
        """(z, A z, c'z + offset) with the leading axes of X and U."""
        z = self._z(X, U)
        Az = torch.einsum("kpd,...kd->...kp", self.A, z)
        lin = torch.einsum("kd,...kd->...k", self.c, z) + self.offset
        return z, Az, lin

    def evaluate(self, X, U):
        """Residual [..., N, 1]: ||A z||^2 - (c'z + offset)^2."""
        _, Az, lin = self._parts(X, U)
        return (torch.sum(Az * Az, dim=-1) - lin * lin)[..., None]

    def jacobians(self, X, U):
        """(Cx [..., N, 1, n], Cu [..., N, 1, m]) at (X, U), with the leading
        axes of the trajectory: the gradient 2 A'A z - 2 (c'z + offset) c in
        the constrained variable's slot, zeros in the other."""
        _, Az, lin = self._parts(X, U)
        g = (2.0 * torch.einsum("...kp,kpd->...kd", Az, self.A)
             - 2.0 * lin[..., None] * self.c)
        if self.on == "control":
            zero = X.new_zeros(X.shape[:-1] + (1, X.shape[-1]))
            return zero, g[..., None, :]
        zero = U.new_zeros(X.shape[:-1] + (1, U.shape[-1]))
        return g[..., None, :], zero

    def violations(self, X, U):
        """[..., N, 1] infeasibility, zeroed at inactive knots."""
        return violation(self.cone, self.evaluate(X, U)) * self.mask[:, None]

    def max_violation(self, X, U):
        """[...] largest |violation| over the knots."""
        return torch.amax(torch.abs(self.violations(X, U)), dim=(-2, -1))

    def second_order(self, X, U, g):
        """Multiplier-weighted constraint Hessian g_k d2c_k, with g the
        block's AL gradient [..., N, 1]: the exact curvature, the constant
        2 A'A - 2 c c' (indefinite in general: the nonconvexity the naive
        form exhibits) scaled per lane. Returns (Hxx, Huu, Hux), the
        constrained variable's [..., N, dim, dim] and shared zero stacks
        [N, ...] for the others."""
        H = (2.0 * torch.einsum("kpi,kpj->kij", self.A, self.A)
             - 2.0 * torch.einsum("ki,kj->kij", self.c, self.c))
        Hw = g[..., 0, None, None] * H
        N, n, m = self.N, X.shape[-1], U.shape[-1]
        zxx = X.new_zeros((N, n, n))
        zuu = X.new_zeros((N, m, m))
        zux = X.new_zeros((N, m, n))
        if self.on == "control":
            return zxx, Hw, zux
        return Hw, zuu, zux


def quad_norm_constraint(N: int, n: int, m: int, A, c=None, offset=0.0,
                         on: str = "control", start: int = 0,
                         stop: Optional[int] = None, dtype=torch.float64,
                         device=None) -> QuadNormConstraint:
    """||A z||^2 <= (c'z + offset)^2, z = u (``on="control"``) or x
    (``"state"``), at knots [start, stop) (stop = N - 1 by default). A
    [p, dim] or per knot [N, p, dim]; c [dim] or [N, dim] (zeros when
    None)."""
    if on not in ("control", "state"):
        raise ValueError(on)
    kw = dict(dtype=dtype, device=device)
    A = torch.as_tensor(A, **kw)
    if A.dim() == 2:
        A = A.expand((N,) + tuple(A.shape))
    dim = A.shape[-1]
    if dim != (m if on == "control" else n):
        raise ValueError(f"A acts on {dim} entries, the {on} has "
                         f"{m if on == 'control' else n}")
    c = torch.zeros(dim, **kw) if c is None else torch.as_tensor(c, **kw)
    if c.dim() == 1:
        c = c.expand(N, dim)
    stop = N - 1 if stop is None else stop
    return QuadNormConstraint(
        A=A.contiguous(), c=c.contiguous(),
        offset=torch.full((N,), float(offset), **kw),
        mask=_range_mask(N, start, stop, dtype, device), on=on)


@dataclass
class DualState:
    """AL multipliers and penalties for one constraint block."""

    lam: torch.Tensor  # [..., N, p]
    rho: torch.Tensor  # [..., N]  scalar penalty per knot

    @staticmethod
    def init(con, penalty_initial, dtype=None, batch=()) -> "DualState":
        """Zero multipliers and a constant penalty for block ``con`` (affine
        or not), with leading axes ``batch``."""
        dtype = con.mask.dtype if dtype is None else dtype
        kw = dict(dtype=dtype, device=con.mask.device)
        batch = tuple(batch)
        return DualState(
            lam=torch.zeros(batch + (con.N, con.p), **kw),
            rho=torch.full(batch + (con.N,), float(penalty_initial), **kw))

    def shift(self) -> "DualState":
        """Warm-start shift one knot forward, filling the tail with the last
        entry."""
        lam = torch.cat([self.lam[..., 1:, :], self.lam[..., -1:, :]], dim=-2)
        return dataclasses.replace(self, lam=lam)


def _penalty_parts(con: ConicConstraint, dual: DualState, X, U):
    """(z, ctilde) with z = lam + rho c and ctilde = proj_polar(z)."""
    z = dual.lam + dual.rho[..., None] * con.evaluate(X, U)
    return z, project_polar(con.cone, z)


def al_cost(con: ConicConstraint, dual: DualState, X, U):
    """AL penalty value [...]:
    sum_k mask_k (||ctilde_k||^2 - ||lam_k||^2) / (2 rho_k)."""
    _, ct = _penalty_parts(con, dual, X, U)
    return torch.sum(con.mask * (torch.sum(ct * ct, dim=-1)
                                 - torch.sum(dual.lam ** 2, dim=-1))
                     / (2.0 * dual.rho), dim=-1)


def al_terms(con: ConicConstraint, dual: DualState, X, U):
    """Per-block AL penalty value [...], gradient in c [..., N, p]
    (ctilde * mask) and Gauss-Newton curvature in c [..., N, p, p]
    (rho * Jac(proj_polar)(lam + rho c) * mask)."""
    z, ct = _penalty_parts(con, dual, X, U)
    value = torch.sum(con.mask * (torch.sum(ct * ct, dim=-1)
                                  - torch.sum(dual.lam ** 2, dim=-1))
                      / (2.0 * dual.rho), dim=-1)
    J = project_polar_jacobian(con.cone, z)
    curv = (dual.rho[..., None, None] * J) * con.mask[:, None, None]
    return value, ct * con.mask[:, None], curv


def al_terms_structured(con: ConicConstraint, dual: DualState, X, U):
    """AL penalty gradient g [..., N, p] and curvature of one block in the
    cheapest structured form per cone, with ctilde = proj_polar(lam + rho c):

      ZERO:   g = ctilde * mask, ('diag', w) with w = rho * mask
      NONPOS: g = ctilde * mask, ('diag', w) with w = rho * active * mask
      SOC, p >= 12: ('diag_lr', (w, ((c1, u1), (c2, u2)))) with
              rho * mask * J_polar = diag(w) + c1 u1 u1' + c2 u2 u2'
      SOC, p < 12:  ('dense', H [..., N, p, p]) = rho * mask * J_polar
    """
    z, ct = _penalty_parts(con, dual, X, U)
    g = ct * con.mask[:, None]
    if con.cone == Cone.ZERO:
        w = (dual.rho * con.mask)[..., None].expand(z.shape)
        return g, ("diag", w)
    if con.cone == Cone.NONPOS:
        active = (z > 0.0).to(z.dtype)
        w = (dual.rho[..., None] * active) * con.mask[:, None]
        return g, ("diag", w)
    if z.shape[-1] < 12:
        J = project_polar_jacobian(con.cone, z)
        H = (dual.rho[..., None, None] * J) * con.mask[:, None, None]
        return g, ("dense", H)
    w, c1, u1, c2, u2 = soc_polar_curvature_factors(z)
    rm = dual.rho * con.mask
    return g, ("diag_lr", (w * rm[..., None],
                           ((c1 * rm, u1), (c2 * rm, u2))))


def dual_update(con: ConicConstraint, dual: DualState, X, U,
                penalty_scaling, penalty_max) -> DualState:
    """AL outer-loop update: lam <- proj_polar(lam + rho c) * mask,
    rho <- min(rho * phi, rho_max)."""
    _, ct = _penalty_parts(con, dual, X, U)
    return DualState(lam=ct * con.mask[:, None],
                     rho=torch.clamp(dual.rho * penalty_scaling,
                                     max=penalty_max))


# ----------------------------------------------------------------------------
# Constructors
# ----------------------------------------------------------------------------

def _range_mask(N: int, start: int, stop: int, dtype=torch.float32,
                device=None):
    k = torch.arange(N, device=device)
    return ((k >= start) & (k < stop)).to(dtype)


def bound_constraint(N: int, n: int, m: int,
                     x_min=None, x_max=None, u_min=None, u_max=None,
                     start: int = 0, stop: Optional[int] = None,
                     dtype=torch.float32, device=None) -> ConicConstraint:
    """Box bounds as NONPOS rows; only finite bounds produce rows. Scalar
    bounds broadcast."""
    import numpy as np

    stop = N - 1 if stop is None else stop
    rows_Cx, rows_Cu, rows_b = [], [], []

    def add(vec, sign, is_state):
        if vec is None:
            return
        v = np.broadcast_to(np.asarray(vec, float), (n if is_state else m,))
        for i in range(v.shape[0]):
            if not np.isfinite(v[i]):
                continue
            cx = np.zeros(n)
            cu = np.zeros(m)
            (cx if is_state else cu)[i] = sign
            rows_Cx.append(cx)
            rows_Cu.append(cu)
            rows_b.append(-sign * v[i])

    add(x_max, 1.0, True)    # x - x_max <= 0
    add(x_min, -1.0, True)   # x_min - x <= 0
    add(u_max, 1.0, False)
    add(u_min, -1.0, False)

    kw = dict(dtype=dtype, device=device)
    Cx = torch.as_tensor(np.stack(rows_Cx), **kw)
    Cu = torch.as_tensor(np.stack(rows_Cu), **kw)
    b = torch.as_tensor(np.stack(rows_b), **kw)
    p = Cx.shape[0]
    return ConicConstraint(
        Cx=Cx.expand(N, p, n).contiguous(),
        Cu=Cu.expand(N, p, m).contiguous(),
        b=b.expand(N, p).contiguous(),
        mask=_range_mask(N, start, stop, dtype, device),
        cone=Cone.NONPOS,
        name="bound",
    )


def goal_constraint(N: int, n: int, m: int, xf, dtype=torch.float32,
                    device=None) -> ConicConstraint:
    """x_N = xf as a ZERO block at the terminal knot."""
    kw = dict(dtype=dtype, device=device)
    xf = torch.as_tensor(xf, **kw)
    return ConicConstraint(
        Cx=torch.eye(n, **kw).expand(N, n, n).contiguous(),
        Cu=torch.zeros((N, n, m), **kw),
        b=(-xf).expand(N, n).contiguous(),
        mask=_range_mask(N, N - 1, N, dtype, device),
        cone=Cone.ZERO, name="goal")


def norm_constraint(N: int, n: int, m: int, bound, on: str = "control",
                    start: int = 0, stop: Optional[int] = None,
                    dtype=torch.float32, device=None) -> ConicConstraint:
    """||z|| <= bound as the SOC row (z, bound), z = x or u."""
    dim = m if on == "control" else n
    kw = dict(dtype=dtype, device=device)
    return norm_constraint2(N, n, m, torch.eye(dim, **kw),
                            torch.zeros(dim, **kw), on=on, offset=bound,
                            start=start, stop=stop, dtype=dtype,
                            device=device)


def norm_constraint2(N: int, n: int, m: int, A, c, on: str = "control",
                     offset=0.0, start: int = 0, stop: Optional[int] = None,
                     mask=None, dtype=torch.float32,
                     device=None) -> ConicConstraint:
    """||A z|| <= c'z + offset, z = x or u, as an SOC block. A [p, dim] or
    per knot [N, p, dim]; c [dim] or [N, dim]."""
    kw = dict(dtype=dtype, device=device)
    A = torch.as_tensor(A, **kw)
    c = torch.as_tensor(c, **kw)
    if A.dim() == 2:
        A = A.expand((N,) + tuple(A.shape))
    if c.dim() == 1:
        c = c.expand(N, c.shape[0])
    p_rows, dim = A.shape[1], A.shape[2]
    M = torch.cat([A, c[:, None, :]], dim=1)              # [N, p+1, dim]
    if on == "control":
        assert dim == m
        Cx, Cu = torch.zeros((N, p_rows + 1, n), **kw), M
    elif on == "state":
        assert dim == n
        Cx, Cu = M, torch.zeros((N, p_rows + 1, m), **kw)
    else:
        raise ValueError(on)
    b = torch.zeros((N, p_rows + 1), **kw)
    b[:, -1] += torch.as_tensor(offset, **kw)
    if mask is None:
        stop = N - 1 if stop is None else stop
        mask = _range_mask(N, start, stop, dtype, device)
    return ConicConstraint(Cx=Cx.contiguous(), Cu=Cu.contiguous(), b=b,
                           mask=mask, cone=Cone.SOC, name="norm_soc")


def linear_constraint(N: int, n: int, m: int, Ax, Au, rhs, cone: Cone,
                      start: int = 0, stop: Optional[int] = None, mask=None,
                      name: str = "linear", dtype=torch.float32,
                      device=None) -> ConicConstraint:
    """General affine rows ``Ax x + Au u - rhs in K`` (K = ZERO or NONPOS).
    Ax [p, n] or per knot [N, p, n], Au [p, m] or [N, p, m], rhs [p] or
    [N, p]; the default mask covers knots [start, stop) with stop = N - 1."""
    kw = dict(dtype=dtype, device=device)
    Ax = torch.as_tensor(Ax, **kw)
    Au = torch.as_tensor(Au, **kw)
    rhs = torch.as_tensor(rhs, **kw)
    if Ax.dim() == 2:
        Ax = Ax.expand((N,) + tuple(Ax.shape))
    if Au.dim() == 2:
        Au = Au.expand((N,) + tuple(Au.shape))
    if rhs.dim() == 1:
        rhs = rhs.expand(N, rhs.shape[0])
    if mask is None:
        stop = N - 1 if stop is None else stop
        mask = _range_mask(N, start, stop, dtype, device)
    return ConicConstraint(Cx=Ax.contiguous(), Cu=Au.contiguous(),
                           b=(-rhs).contiguous(), mask=mask, cone=cone,
                           name=name)


def friction_cone(N: int, n: int, m: int, mu, foot_inds,
                  mask=None, dtype=torch.float32,
                  device=None) -> ConicConstraint:
    """||(f_x, f_y)|| <= mu f_z for one contact force in u, as the SOC
    block (f_x, f_y, mu f_z); ``foot_inds`` are the force's 3 control
    indices."""
    ix, iy, iz = foot_inds
    kw = dict(dtype=dtype, device=device)
    A = torch.zeros((2, m), **kw)
    A[0, ix] = 1.0
    A[1, iy] = 1.0
    c = torch.zeros(m, **kw)
    c[iz] = mu
    return norm_constraint2(N, n, m, A, c, on="control", mask=mask,
                            dtype=dtype, device=device)


def linearized_friction(N: int, n: int, m: int, mu, foot_inds,
                        mask=None, dtype=torch.float32,
                        device=None) -> ConicConstraint:
    """The friction pyramid |f_x| <= mu f_z, |f_y| <= mu f_z as 4 NONPOS
    rows."""
    ix, iy, iz = foot_inds
    kw = dict(dtype=dtype, device=device)
    Au = torch.zeros((4, m), **kw)
    for r, (i, s) in enumerate(((ix, 1.0), (ix, -1.0), (iy, 1.0),
                                (iy, -1.0))):
        Au[r, i] = s
        Au[r, iz] -= mu
    if mask is None:
        mask = _range_mask(N, 0, N - 1, dtype, device)
    return ConicConstraint(
        Cx=torch.zeros((N, 4, n), **kw),
        Cu=Au.expand(N, 4, m).contiguous(),
        b=torch.zeros((N, 4), **kw),
        mask=mask, cone=Cone.NONPOS, name="linearized_friction")
