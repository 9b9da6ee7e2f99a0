"""Affine conic constraint blocks (PyTorch counterpart of
``altro_tpu/constraints.py``, for the ZERO/NONPOS slice).

    c_k = Cx_k @ x_k + Cu_k @ u_k + b_k   in  K       (for knots with mask=1)

The stacks carry a leading knot axis and are shared problem data (no batch
axis); trajectories and multipliers carry leading batch axes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from .cones import Cone, project_polar, violation
from .costs import pad_terminal


@dataclass
class ConicConstraint:
    """One block of p-row affine conic constraints applied along the
    horizon."""

    Cx: torch.Tensor    # [N, p, n]
    Cu: torch.Tensor    # [N, p, m]
    b: torch.Tensor     # [N, p]
    mask: torch.Tensor  # [N] float {0,1}: knots where the block is active
    cone: Cone
    name: str = ""

    @property
    def N(self) -> int:
        return self.Cx.shape[0]

    @property
    def p(self) -> int:
        return self.Cx.shape[1]

    def evaluate(self, X, U):
        """Residual stack c [..., N, p]; u at the terminal knot is zero."""
        return (torch.einsum("kpn,...kn->...kp", self.Cx, X)
                + torch.einsum("kpm,...km->...kp", self.Cu, pad_terminal(U))
                + self.b)

    def jacobians(self, X, U):
        """(Cx [N,p,n], Cu [N,p,m]): constant for affine blocks."""
        del X, U
        return self.Cx, self.Cu

    def violations(self, X, U):
        """[..., N, p] infeasibility (c - proj_K(c)), zeroed at inactive
        knots."""
        c = self.evaluate(X, U)
        return violation(self.cone, c) * self.mask[:, None]


@dataclass
class DualState:
    """AL multipliers and penalties for one constraint block."""

    lam: torch.Tensor  # [..., N, p]
    rho: torch.Tensor  # [..., N]  scalar penalty per knot

    @staticmethod
    def init(con: ConicConstraint, penalty_initial, dtype=None,
             batch=()) -> "DualState":
        """Zero multipliers and a constant penalty, with leading axes
        ``batch``."""
        dtype = con.Cx.dtype if dtype is None else dtype
        kw = dict(dtype=dtype, device=con.Cx.device)
        batch = tuple(batch)
        return DualState(
            lam=torch.zeros(batch + (con.N, con.p), **kw),
            rho=torch.full(batch + (con.N,), float(penalty_initial), **kw))

    def shift(self) -> "DualState":
        """Warm-start shift one knot forward, filling the tail with the last
        entry."""
        lam = torch.cat([self.lam[..., 1:, :], self.lam[..., -1:, :]], dim=-2)
        return dataclasses.replace(self, lam=lam)


def al_terms_structured(con: ConicConstraint, dual: DualState, X, U):
    """AL penalty gradient and curvature of one block in the diagonal form.

    With ctilde = proj_polar(lam + rho * c):
      ZERO:   g = ctilde * mask, ('diag', w) with w = rho * mask
      NONPOS: g = ctilde * mask, ('diag', w) with w = rho * active * mask
    The SOC block's diag + rank-2 and dense forms are not ported yet.
    """
    c = con.evaluate(X, U)
    z = dual.lam + dual.rho[..., None] * c
    ct = project_polar(con.cone, z)
    g = ct * con.mask[:, None]
    if con.cone == Cone.ZERO:
        w = (dual.rho * con.mask)[..., None].expand(z.shape)
        return g, ("diag", w)
    if con.cone == Cone.NONPOS:
        active = (z > 0.0).to(z.dtype)
        w = (dual.rho[..., None] * active) * con.mask[:, None]
        return g, ("diag", w)
    raise NotImplementedError(f"{con.cone} AL curvature is not ported yet")


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
