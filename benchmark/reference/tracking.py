"""The plain reference of a tracking MPC step with linear time-invariant
dynamics, a quadratic tracking cost and affine conic constraint rows:

    x_{k+1} = A x_k + B u_k + d
    J = sum_{k < N-1} 0.5 (x_k - xr_k)'Q (x_k - xr_k)
                      + 0.5 (u_k - ur_k)'R (u_k - ur_k)
        + 0.5 (x_{N-1} - xr_{N-1})'Qf (x_{N-1} - xr_{N-1})
    c_k = Cx x_k + Cu u_k + b  in K  at the block's active knots,

K the nonpositive orthant ("nonpos") or the second-order cone ("soc",
||c[:-1]|| <= c[-1]). A step propagates the previous state through the
previous solution's first control, adds process noise by the family's noise
model, moves the tracking window [k, k + N) of the reference trajectory
(clamped at its tail, as a dynamic slice is) and solves the window's
problem. The solve condenses the states away (x = x_bar + Gamma z, z the
stacked controls) and hands the conic QP to :mod:`.ipm`.

Everything is computed here from the configuration's data, in float64, or in
the arithmetic of an :class:`~.ipm.Arith` where a control asks for another.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Sequence

import torch

from . import ipm
from .ipm import F64, Arith


@dataclass
class RowBlock:
    """Affine rows c = Cx x + Cu u + b of one cone kind, active at
    ``knots``."""

    kind: str               # "nonpos" or "soc"
    Cx: torch.Tensor        # [p, n]
    Cu: torch.Tensor        # [p, m]
    b: torch.Tensor         # [p]
    knots: Sequence[int]


@dataclass
class TrackingMPC:
    A: torch.Tensor         # [n, n]
    B: torch.Tensor         # [n, m]
    d: torch.Tensor         # [n]
    Q: torch.Tensor         # [n, n] stage weight (any dt folded in)
    R: torch.Tensor         # [m, m] stage weight
    Qf: torch.Tensor        # [n, n] terminal weight
    X_track: torch.Tensor   # [Nt, n]
    U_track: torch.Tensor   # [Nt-1, m]
    N: int                  # knots of a window
    blocks: List[RowBlock]
    noise_model: Callable   # (x_prop [L, n], noise [L, n], Arith) -> [L, n]

    @property
    def n(self) -> int:
        return self.A.shape[0]

    @property
    def m(self) -> int:
        return self.B.shape[1]

    def to(self, device) -> "TrackingMPC":
        def mv(t):
            return t.to(device) if isinstance(t, torch.Tensor) else t
        return TrackingMPC(
            *(mv(getattr(self, f)) for f in
              ("A", "B", "d", "Q", "R", "Qf", "X_track", "U_track")),
            N=self.N,
            blocks=[RowBlock(b.kind, mv(b.Cx), mv(b.Cu), mv(b.b), b.knots)
                    for b in self.blocks],
            noise_model=self.noise_model)

    # -- the step's own work --------------------------------------------------

    def propagate(self, x0, u0, noise, ar: Arith = F64):
        """The next state of every lane: the noise model applied to
        A x0 + B u0 + d (x0 [L, n], u0 [L, m], noise [L, n])."""
        x = (ar.einsum("ij,lj->li", self.A, x0)
             + ar.einsum("ij,lj->li", self.B, u0) + ar.t(self.d))
        return self.noise_model(x, ar.t(noise), ar)

    def window(self, k):
        """Every lane's tracking window at its index k [L] (int64):
        (X [L, N, n], U [L, N-1, m]), clamped at the reference's tail."""
        N = self.N
        ar_ = torch.arange(N, device=k.device)
        kx = torch.clamp(k, 0, self.X_track.shape[0] - N)
        ku = torch.clamp(k, 0, self.U_track.shape[0] - (N - 1))
        return (self.X_track[kx[:, None] + ar_],
                self.U_track[ku[:, None] + ar_[:-1]])

    # -- the window's problem -------------------------------------------------

    def rollout(self, x0, U):
        """States [L, N, n] of the controls U [L, N-1, m] from x0, float64."""
        A, B, d = self.A.double(), self.B.double(), self.d.double()
        xs = [x0.double()]
        for k in range(U.shape[1]):
            xs.append(xs[-1] @ A.T + U[:, k].double() @ B.T + d)
        return torch.stack(xs, dim=1)

    def cost(self, x0, U, k):
        """The tracking cost J [L] of the controls U [L, N-1, m] from x0
        [L, n] in the windows k [L], float64."""
        Xw, Uw = self.window(k)
        X = self.rollout(x0, U)
        ex, eu = X - Xw.double(), U.double() - Uw.double()
        Q, R, Qf = self.Q.double(), self.R.double(), self.Qf.double()
        stage = (0.5 * torch.einsum("lki,ij,lkj->l", ex[:, :-1], Q, ex[:, :-1])
                 + 0.5 * torch.einsum("lki,ij,lkj->l", eu, R, eu))
        return stage + 0.5 * torch.einsum("li,ij,lj->l", ex[:, -1], Qf,
                                          ex[:, -1])

    def violation(self, x0, U):
        """The largest constraint violation [L] of the controls U from x0:
        the inf-norm of c - proj_K(c) over the active rows, float64."""
        X = self.rollout(x0, U)
        Up = torch.cat([U.double(), torch.zeros_like(U[:, :1]).double()], 1)
        worst = torch.zeros(X.shape[0], dtype=torch.float64, device=X.device)
        for blk in self.blocks:
            ks = torch.as_tensor(list(blk.knots), device=X.device)
            c = (X[:, ks] @ blk.Cx.double().T + Up[:, ks] @ blk.Cu.double().T
                 + blk.b.double())
            if blk.kind == "nonpos":
                v = torch.clamp(c, min=0.0)
            else:
                v = c - _project_soc(c)
            worst = torch.maximum(worst, v.abs().flatten(1).amax(dim=1))
        return worst

    def condensed(self, ar: Arith = F64):
        """(Phi [N, n, n], Gamma [N, n, nz], c [N, n]): x_k = Phi_k x0 +
        Gamma_k z + c_k, z the controls stacked knot by knot."""
        N, n, m = self.N, self.n, self.m
        A, B, d = ar.t(self.A), ar.t(self.B), ar.t(self.d)
        eye = torch.eye(n, dtype=A.dtype, device=A.device)
        Phi, c = [eye], [torch.zeros_like(d)]
        G = [torch.zeros((n, (N - 1) * m), dtype=A.dtype, device=A.device)]
        for k in range(1, N):
            Phi.append(ar.einsum("ij,jk->ik", A, Phi[-1]))
            c.append(ar.einsum("ij,j->i", A, c[-1]) + d)
            g = ar.einsum("ij,jz->iz", A, G[-1])
            g[:, (k - 1) * m:k * m] = g[:, (k - 1) * m:k * m] + B
            G.append(g)
        return torch.stack(Phi), torch.stack(G), torch.stack(c)

    def qp(self, x0, k, ar: Arith = F64):
        """The condensed conic QP of every lane's window (x0 [L, n], k [L]):
        J = f(z) plus a term that does not depend on z."""
        N, m = self.N, self.m
        Phi, G, c = self.condensed(ar)
        Xw, Uw = self.window(k)
        xbar = ar.einsum("kij,lj->lki", Phi, x0) + c          # [L, N, n]
        Qk = torch.stack([ar.t(self.Q)] * (N - 1) + [ar.t(self.Qf)])
        Qk[0] = 0.0                                          # x0 is fixed
        e = xbar - ar.t(Xw)
        nz = (N - 1) * m
        Rbig = torch.kron(torch.eye(N - 1, dtype=ar.dtype,
                                    device=x0.device), ar.t(self.R))
        P = ar.einsum("kaz,kab,kby->zy", G, Qk, G) + Rbig
        ur = ar.t(Uw).reshape(-1, nz)
        p = (ar.einsum("kaz,kab,lkb->lz", G, Qk, e)
             - ar.einsum("zy,ly->lz", Rbig, ur))
        blocks = []
        for blk in self.blocks:
            ks = list(blk.knots)
            Cx, Cu, b = ar.t(blk.Cx), ar.t(blk.Cu), ar.t(blk.b)
            M = ar.einsum("pi,kiz->kpz", Cx, G[ks])
            for j, kk in enumerate(ks):
                if kk < N - 1:
                    M[j, :, kk * m:(kk + 1) * m] += Cu
            h = ar.einsum("pi,lki->lkp", Cx, xbar[:, ks]) + b
            if blk.kind == "nonpos":
                blocks.append(ipm.Block("nonneg", -M, -h))
            else:
                blocks.append(ipm.Block("soc", M, h))
        return ipm.ConicQP(P, p, blocks)

    def solve(self, x0, k, z0, ar: Arith = F64, gap_tol: float = 1e-10):
        """Every lane's window solution U [L, N-1, m] from x0 [L, n] in the
        windows k [L], started from the controls z0 [L, N-1, m]; NaN for a
        lane whose window is infeasible."""
        qp = self.qp(x0, k, ar)
        z = ipm.solve(qp, z0.reshape(z0.shape[0], -1), ar, gap_tol=gap_tol)
        return z.reshape(z0.shape)


def _project_soc(c):
    v, s = c[..., :-1], c[..., -1]
    a = torch.linalg.vector_norm(v, dim=-1)
    scale = (a + s) / (2.0 * torch.where(a > 0, a, torch.ones_like(a)))
    boundary = torch.cat([scale[..., None] * v, (scale * a)[..., None]], -1)
    return torch.where((a <= s)[..., None], c,
                       torch.where((a <= -s)[..., None], torch.zeros_like(c),
                                   boundary))
