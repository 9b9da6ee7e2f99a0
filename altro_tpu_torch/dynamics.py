"""Discrete-time linear dynamics (PyTorch counterpart of the LTV part of
``altro_tpu/dynamics.py``, with its exact zero-order-hold discretization).

The stacks have a knot axis of length N-1 and are either shared by the
batch ([N-1, ...]) or per scenario ([B, N-1, ...], as when every scenario is
linearized about its own contact schedule); states and controls carry
leading batch axes.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class LTVDynamics:
    """x_{k+1} = A_k x_k + B_k u_k + d_k, k = 0..N-2. LTI models are stored
    broadcast to the horizon."""

    A: torch.Tensor  # [(B,) N-1, n, n]
    B: torch.Tensor  # [(B,) N-1, n, m]
    d: torch.Tensor  # [(B,) N-1, n]

    @property
    def per_lane(self) -> bool:
        """Whether the stacks carry a batch axis."""
        return self.A.dim() == 4

    @property
    def N(self) -> int:
        return self.A.shape[-3] + 1

    @property
    def n(self) -> int:
        return self.A.shape[-1]

    @property
    def m(self) -> int:
        return self.B.shape[-1]

    def step(self, x, u, k: int):
        """x [..., n], u [..., m] -> x+ [..., n] at knot k; with per-lane
        stacks x and u are [B, n] and [B, m]."""
        if self.per_lane:
            return (torch.einsum("bij,bj->bi", self.A[:, k], x)
                    + torch.einsum("bij,bj->bi", self.B[:, k], u)
                    + self.d[:, k])
        return (torch.einsum("ij,...j->...i", self.A[k], x)
                + torch.einsum("ij,...j->...i", self.B[k], u) + self.d[k])

    def linearize(self, X, U):
        """(A, B, d) stacks about a trajectory: exact for linear models."""
        del X, U
        return self.A, self.B, self.d

    def rollout(self, x0, U):
        """Open-loop rollout of U [..., N-1, m] from x0 [..., n]; returns
        X [..., N, n]."""
        xs = [x0]
        for k in range(U.shape[-2]):
            xs.append(self.step(xs[-1], U[..., k, :], k))
        return torch.stack(xs, dim=-2)


def lti_dynamics(Ad, Bd, N: int, dd=None) -> LTVDynamics:
    """Broadcast a discrete LTI model to an N-knot :class:`LTVDynamics`."""
    n = Ad.shape[0]
    dd = torch.zeros(n, dtype=Ad.dtype, device=Ad.device) if dd is None else dd
    return LTVDynamics(
        A=Ad.expand((N - 1,) + tuple(Ad.shape)).contiguous(),
        B=Bd.expand((N - 1,) + tuple(Bd.shape)).contiguous(),
        d=dd.expand(N - 1, n).contiguous(),
    )


def zoh_discretize(A, B, dt, d=None):
    """Exact zero-order-hold discretization of x' = A x + B u (+ d) via one
    matrix exponential of the augmented system [[A, B, d], [0, 0, 0]].
    Returns (Ad, Bd, dd)."""
    n, m = B.shape
    kw = dict(dtype=A.dtype, device=A.device)
    dcol = d[:, None] if d is not None else torch.zeros((n, 0), **kw)
    width = n + m + dcol.shape[1]
    top = torch.cat([A, B, dcol], dim=1)
    M = torch.cat([top, torch.zeros((width - n, width), **kw)], dim=0)
    E = torch.linalg.matrix_exp(M * dt)
    dd = E[:n, n + m] if d is not None else torch.zeros(n, **kw)
    return E[:n, :n], E[:n, n:n + m], dd
