"""Discrete-time dynamics (PyTorch counterpart of ``altro_tpu/dynamics.py``):
linear-time-varying stacks, nonlinear models linearized by forward-mode
autodiff, and the exact zero-order-hold, Euler and RK4 discretizations.

The LTV stacks have a knot axis of length N-1 and are shared by the batch
([N-1, ...]), per scenario ([B, N-1, ...], as when every scenario is
linearized about its own contact schedule) or per group of scenarios
([G, N-1, ...], flagged ``grouped``); states and controls carry leading
batch axes. A nonlinear model is a function of one lane, batched
with ``torch.func.vmap``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import torch
from torch.func import jacfwd, vmap


def lane_mv(M, v):
    """M [..., r, c] times v [..., c] -> [..., r], broadcast over the
    leading axes as one small product per lane, so that every lane's
    result is the same bits whatever the batch it runs in."""
    return (M @ v[..., None])[..., 0]


@dataclass
class LTVDynamics:
    """x_{k+1} = A_k x_k + B_k u_k + d_k, k = 0..N-2. LTI models are stored
    broadcast to the horizon.

    The stacks are shared by the batch ([N-1, ...]), per lane ([B, N-1,
    ...]) or, with ``grouped``, per group of lanes ([G, N-1, ...]): the
    batch is G contiguous groups of B / G lanes, lane b in group
    b // (B / G), each group with its own stacks (the JAX package's nested
    vmap over contact schedules, ``batched_families.py:292-306``). Grouping
    is a flag, not a guess from shapes: a [8, N-1, n, n] stack is per lane
    unless flagged."""

    A: torch.Tensor  # [(B or G,) N-1, n, n]
    B: torch.Tensor  # [(B or G,) N-1, n, m]
    d: torch.Tensor  # [(B or G,) N-1, n]
    grouped: bool = False

    def __post_init__(self):
        if self.grouped and self.A.dim() != 4:
            raise ValueError(f"grouped stacks are [G, N-1, n, n], got A of "
                             f"shape {tuple(self.A.shape)}")

    @property
    def per_lane(self) -> bool:
        """Whether the stacks carry a lane axis (not a group axis)."""
        return self.A.dim() == 4 and not self.grouped

    @property
    def groups(self) -> int:
        """G for grouped stacks, 0 otherwise."""
        return self.A.shape[0] if self.grouped else 0

    @property
    def N(self) -> int:
        return self.A.shape[-3] + 1

    @property
    def n(self) -> int:
        return self.A.shape[-1]

    @property
    def m(self) -> int:
        return self.B.shape[-1]

    def group_index(self, batch: int, device=None) -> torch.Tensor:
        """The group of each lane of a batch of ``batch`` lanes, [batch]."""
        G = self.groups
        if batch % G:
            raise ValueError(f"a batch of {batch} lanes is not {G} equal "
                             f"groups")
        return torch.arange(G, device=device or self.A.device
                            ).repeat_interleave(batch // G)

    def lanes(self, batch: int) -> "LTVDynamics":
        """The per-lane view of the stacks for a batch of ``batch`` lanes
        ([batch, N-1, ...], materialized): each group's stacks repeated to
        its lanes; per-lane and shared dynamics as they are."""
        if not self.grouped:
            return self
        g = self.group_index(batch)
        return LTVDynamics(A=self.A[g], B=self.B[g], d=self.d[g])

    def step(self, x, u, k: int):
        """x [..., n], u [..., m] -> x+ [..., n] at knot k; with per-lane or
        grouped stacks x and u are [B, n] and [B, m] (a grouped step takes
        each lane's group's knot-k rows)."""
        if self.grouped:
            g = self.group_index(x.shape[0], x.device)
            A, B, d = self.A[:, k][g], self.B[:, k][g], self.d[:, k][g]
        elif self.per_lane:
            A, B, d = self.A[:, k], self.B[:, k], self.d[:, k]
        else:
            # one matrix-vector product per lane: a lane's bits do not
            # depend on the batch around it (an einsum folds the batch into
            # the rows of one product, whose rounding follows its size)
            return (lane_mv(self.A[k], x) + lane_mv(self.B[k], u)
                    + self.d[k])
        return (torch.einsum("bij,bj->bi", A, x)
                + torch.einsum("bij,bj->bi", B, u) + d)

    def linearize(self, X, U):
        """(A, B, d) stacks about a trajectory: exact for linear models;
        grouped stacks come per lane (:meth:`lanes`)."""
        dyn = self.lanes(X.shape[0])
        return dyn.A, dyn.B, dyn.d

    def rollout(self, x0, U):
        """Open-loop rollout of U [..., N-1, m] from x0 [..., n]; returns
        X [..., N, n]."""
        xs = [x0]
        for k in range(U.shape[-2]):
            xs.append(self.step(xs[-1], U[..., k, :], k))
        return torch.stack(xs, dim=-2)


@dataclass
class NonlinearDynamics:
    """Discrete nonlinear dynamics ``x+ = f(params, x, u, k)``.

    ``f`` acts on one lane: x [n], u [m] and the knot k (an int, or a 0-d
    integer tensor under ``vmap``), with ``params`` the tuple of tensors of
    that lane; the same contract as the JAX package's, so one model function
    serves both packages. ``lane_axes`` says, per leaf of ``params``,
    whether it carries the lane axis in front ([B, ...]: that lane's data)
    or is shared by every lane (a flag, not a guess from shapes: a [N, 4]
    leaf and a [B, N] leaf look alike at B = N). :meth:`step`,
    :meth:`rollout` and :meth:`linearize` batch ``f`` over the lanes of a
    batch x [B, n] (and over further axes of x, which share their lane's
    params, as the rungs of the line-search ladder do)."""

    f: Callable
    params: Tuple[torch.Tensor, ...]
    n_: int
    m_: int
    N_: int
    lane_axes: Tuple[bool, ...] = ()

    def __post_init__(self):
        self.params = tuple(self.params)
        self.lane_axes = (tuple(self.lane_axes) if self.lane_axes
                          else (False,) * len(self.params))
        if len(self.lane_axes) != len(self.params):
            raise ValueError(f"lane_axes has {len(self.lane_axes)} flags "
                             f"for {len(self.params)} params")

    @property
    def per_lane(self) -> bool:
        """The linearization is per lane, whatever the params are."""
        return True

    @property
    def N(self) -> int:
        return self.N_

    @property
    def n(self) -> int:
        return self.n_

    @property
    def m(self) -> int:
        return self.m_

    def _batched(self, fn, depth: int):
        """``fn(params, *args)`` of one lane, vmapped over the lane axis of
        its tensor arguments (and of the per-lane params), then over
        ``depth`` further leading axes of the tensor arguments that share
        their lane's params. The knot argument (last) is not batched."""
        for _ in range(depth):
            fn = vmap(fn, in_dims=(None, 0, 0, None))
        dims = tuple(0 if lane else None for lane in self.lane_axes)
        return vmap(fn, in_dims=(dims, 0, 0, None))

    def step(self, x, u, k: int):
        """x [B, ..., n], u [B, ..., m] -> x+ [B, ..., n] at knot k: lane b
        steps with its own params."""
        return self._batched(self.f, x.dim() - 2)(self.params, x, u, k)

    def rollout(self, x0, U):
        """Open-loop rollout of U [B, N-1, m] from x0 [B, n]; returns
        X [B, N, n]."""
        step = self._batched(self.f, 0)
        xs = [x0]
        for k in range(U.shape[-2]):
            xs.append(step(self.params, xs[-1], U[:, k], k))
        return torch.stack(xs, dim=-2)

    def linearize(self, X, U):
        """Per-lane, per-knot (A [B, N-1, n, n], B [B, N-1, n, m],
        d [B, N-1, n]) by forward-mode autodiff, vmapped over the lanes and
        the knots: d is the affine residual f(xbar, ubar) - A xbar - B ubar,
        as in the JAX package."""
        f = self.f

        def lin_one(params, x, u, k):
            A = jacfwd(lambda xx: f(params, xx, u, k))(x)
            B = jacfwd(lambda uu: f(params, x, uu, k))(u)
            d = f(params, x, u, k) - A @ x - B @ u
            return A, B, d

        dims = tuple(0 if lane else None for lane in self.lane_axes)
        over_knots = vmap(lin_one, in_dims=(None, 0, 0, 0))
        ks = torch.arange(U.shape[-2], device=U.device)
        A, B, d = vmap(over_knots, in_dims=(dims, 0, 0, None))(
            self.params, X[:, :-1], U, ks)
        return A.contiguous(), B.contiguous(), d.contiguous()


def rk4(f: Callable, x, u, dt, *args):
    """Classic RK4 step of length dt for continuous dynamics
    ``xdot = f(x, u, *args)``."""
    k1 = f(x, u, *args)
    k2 = f(x + 0.5 * dt * k1, u, *args)
    k3 = f(x + 0.5 * dt * k2, u, *args)
    k4 = f(x + dt * k3, u, *args)
    return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


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


def euler_discretize(A, B, dt, d=None):
    """Forward-Euler discretization: Ad = I + A dt, Bd = B dt, dd = d dt
    (zeros without ``d``). Returns (Ad, Bd, dd)."""
    n = A.shape[0]
    Ad = torch.eye(n, dtype=A.dtype, device=A.device) + A * dt
    dd = (d * dt if d is not None
          else torch.zeros(n, dtype=A.dtype, device=A.device))
    return Ad, B * dt, dd
