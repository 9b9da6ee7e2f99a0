"""Quadratic trajectory objectives (PyTorch counterpart of
``altro_tpu/costs.py``).

Total cost over a trajectory (X: [..., N, n], U: [..., N-1, m]):

    J = sum_k 0.5 x_k'Q_k x_k + q_k'x_k + 0.5 u_k'R_k u_k + r_k'u_k
              + u_k'H_k x_k + c_k            for k < N-1 (stage)
        + 0.5 x_T'Q_T x_T + q_T'x_T + c_T    at k = N-1 (terminal)

The Hessian stacks Q, R, H are shared problem data without a batch axis.
The linear terms q, r, c are shared too, or carry a leading lane axis
([B, N, ...], ``per_lane``: every scenario tracks its own reference window,
as under ``vmap`` of the JAX package's ``retarget_tracking``). Trajectories
carry any number of leading batch axes; with a per-lane cost the first of
them is the lane. Stage-cost ``dt`` scaling is folded into the stored stacks
by the constructors.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


def pad_terminal(U):
    """[..., N-1, m] -> [..., N, m] with a zero control at the terminal
    knot."""
    return torch.cat([U, torch.zeros_like(U[..., :1, :])], dim=-2)


def _lanes(t, X):
    """A per-lane stack ``t`` [B, N, ...] aligned to a trajectory X
    [B, ..., N, n]: singleton axes for X's axes between the lane and the
    knot (the ladder's rungs)."""
    mid = X.dim() - 3
    return t.reshape(t.shape[:1] + (1,) * mid + t.shape[1:])


@dataclass
class QuadCost:
    """Per-knot quadratic cost stacks. R/r/H rows at the terminal knot are
    zero."""

    Q: torch.Tensor  # [N, n, n]
    q: torch.Tensor  # [(B,) N, n]
    R: torch.Tensor  # [N, m, m]   (row N-1 unused/zero)
    r: torch.Tensor  # [(B,) N, m]
    H: torch.Tensor  # [N, m, n]   cross term (zero for every reference problem)
    c: torch.Tensor  # [(B,) N]

    @property
    def per_lane(self) -> bool:
        """Whether the linear terms q, r, c carry a lane axis."""
        return self.q.dim() == 3

    @property
    def N(self) -> int:
        return self.Q.shape[0]

    @property
    def n(self) -> int:
        return self.Q.shape[-1]

    @property
    def m(self) -> int:
        return self.R.shape[-1]

    def stage_terms(self, x, u, k: int):
        """Cost of knot ``k`` at x [..., n], u [..., m] (with a per-lane
        cost the first leading axis is the lane)."""
        Q, R, H = self.Q[k], self.R[k], self.H[k]
        q, r, c = self.q[..., k, :], self.r[..., k, :], self.c[..., k]
        return (0.5 * torch.einsum("...i,ij,...j->...", x, Q, x)
                + torch.sum(q * x, dim=-1)
                + 0.5 * torch.einsum("...i,ij,...j->...", u, R, u)
                + torch.sum(r * u, dim=-1)
                + torch.einsum("...i,ij,...j->...", u, H, x) + c)

    def total(self, X, U):
        """Total trajectory cost [...] for X [..., N, n], U [..., N-1, m];
        with a per-lane cost X is [B, ..., N, n]."""
        Upad = pad_terminal(U)
        xQx = torch.einsum("...ki,kij,...kj->...k", X, self.Q, X)
        uRu = torch.einsum("...ki,kij,...kj->...k", Upad, self.R, Upad)
        uHx = torch.einsum("...ki,kij,...kj->...k", Upad, self.H, X)
        if self.per_lane:
            q, r, c = (_lanes(t, X) for t in (self.q, self.r, self.c))
            lin = torch.sum(X * q, dim=-1) + torch.sum(Upad * r, dim=-1)
        else:
            lin = (torch.einsum("...ki,ki->...k", X, self.q)
                   + torch.einsum("...ki,ki->...k", Upad, self.r))
            c = self.c
        per_knot = 0.5 * xQx + 0.5 * uRu + uHx + lin + c
        return torch.sum(per_knot, dim=-1)

    def expansion(self, X, U):
        """Gradients/Hessians of the cost along (X, U).

        Returns (lx [..., N, n], lu [..., N, m], lxx [N, n, n],
        luu [N, m, m], lux [N, m, n]); the Hessians are the shared stacks.
        Row N-1 of lu/luu/lux is zero by construction.
        """
        Upad = pad_terminal(U)
        q, r = ((_lanes(self.q, X), _lanes(self.r, X)) if self.per_lane
                else (self.q, self.r))
        lx = (torch.einsum("kij,...kj->...ki", self.Q, X) + q
              + torch.einsum("kji,...kj->...ki", self.H, Upad))
        lu = (torch.einsum("kij,...kj->...ki", self.R, Upad) + r
              + torch.einsum("kij,...kj->...ki", self.H, X))
        return lx, lu, self.Q, self.R, self.H


def _stack(mat, N):
    return mat.expand((N,) + tuple(mat.shape)).clone()


def lqr_objective(Q, R, Qf, xf, N: int, dt: float = 1.0,
                  uf=None) -> QuadCost:
    """LQR objective tracking the fixed goal state ``xf`` (stage costs
    scaled by ``dt``)."""
    n, m = Q.shape[0], R.shape[0]
    uf = torch.zeros(m, dtype=Q.dtype, device=Q.device) if uf is None else uf
    Qs = _stack(Q * dt, N)
    Qs[N - 1] = Qf
    Rs = _stack(R * dt, N)
    Rs[N - 1] = 0.0
    qs = _stack(-(Q * dt) @ xf, N)
    qs[N - 1] = -Qf @ xf
    rs = _stack(-(R * dt) @ uf, N)
    rs[N - 1] = 0.0
    cs = _stack(0.5 * xf @ (Q * dt) @ xf + 0.5 * uf @ (R * dt) @ uf, N)
    cs[N - 1] = 0.5 * xf @ Qf @ xf
    Hs = torch.zeros((N, m, n), dtype=Q.dtype, device=Q.device)
    return QuadCost(Q=Qs, q=qs, R=Rs, r=rs, H=Hs, c=cs)


def tracking_objective(Q, R, Qf, X_ref, U_ref, dt: float = 1.0) -> QuadCost:
    """Objective tracking a reference trajectory window X_ref [N, n],
    U_ref [N-1, m]."""
    N, n = X_ref.shape
    m = R.shape[0]
    Qs = _stack(Q * dt, N)
    Qs[N - 1] = Qf
    Rs = _stack(R * dt, N)
    Rs[N - 1] = 0.0
    Upad = pad_terminal(U_ref)
    qs = -torch.einsum("ij,kj->ki", Q * dt, X_ref)
    qs[N - 1] = -Qf @ X_ref[N - 1]
    rs = -torch.einsum("ij,kj->ki", R * dt, Upad)
    rs[N - 1] = 0.0
    cs = (0.5 * torch.einsum("ki,ij,kj->k", X_ref, Q * dt, X_ref)
          + 0.5 * torch.einsum("ki,ij,kj->k", Upad, R * dt, Upad))
    cs[N - 1] = 0.5 * X_ref[N - 1] @ Qf @ X_ref[N - 1]
    Hs = torch.zeros((N, m, n), dtype=Q.dtype, device=Q.device)
    return QuadCost(Q=Qs, q=qs, R=Rs, r=rs, H=Hs, c=cs)


def retarget_tracking(cost: QuadCost, X_ref, U_ref) -> QuadCost:
    """Refresh the linear terms of a tracking objective for a new reference
    window without touching the Q/R stacks (the MPC hot path). Assumes
    H == 0. Per-lane windows X_ref [B, N, n], U_ref [B, N-1, m] give a
    per-lane cost (q, r, c with the lane axis)."""
    Upad = pad_terminal(U_ref)
    if X_ref.dim() == 3:
        qs = -torch.einsum("kij,bkj->bki", cost.Q, X_ref)
        rs = -torch.einsum("kij,bkj->bki", cost.R, Upad)
        cs = (0.5 * torch.einsum("bki,kij,bkj->bk", X_ref, cost.Q, X_ref)
              + 0.5 * torch.einsum("bki,kij,bkj->bk", Upad, cost.R, Upad))
        return dataclasses.replace(cost, q=qs, r=rs, c=cs)
    qs = -torch.einsum("kij,kj->ki", cost.Q, X_ref)
    rs = -torch.einsum("kij,kj->ki", cost.R, Upad)
    cs = (0.5 * torch.einsum("ki,kij,kj->k", X_ref, cost.Q, X_ref)
          + 0.5 * torch.einsum("ki,kij,kj->k", Upad, cost.R, Upad))
    return dataclasses.replace(cost, q=qs, r=rs, c=cs)
