"""Batch transcription: trajectory Problem -> dense QP / conic program
(PyTorch counterpart of ``altro_tpu/transcribe.py``).

The variable layout is the reference's: z = [x_0, u_0, x_1, u_1, ...,
x_{N-1}], NN = N n + (N-1) m. Rows: the dynamics defects ((N-1) n rows),
the x0 equality (n rows), then each constraint block knot-major. Masked
(inactive) knots contribute all-zero rows with a zero right-hand side,
feasible for every cone, so every shape is static.

Every tensor carries a leading batch axis: one program per scenario of
``prob.x0`` [B, n] (an unbatched x0 [n] is B = 1). The dynamics stacks may
be shared ([N-1, ...]) or per lane ([B, N-1, ...], as the quadruped's
relinearizations are); cost and constraint stacks are shared and
broadcast to the lanes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import torch

from .cones import Cone
from .dynamics import LTVDynamics
from .problem import Problem


@dataclass
class BatchQP:
    """OSQP-form dense QPs: min 0.5 z'Pz + q'z  s.t.  l <= Az <= u, one per
    lane: P [B, NN, NN], q [B, NN], A [B, M, NN], l and u [B, M]."""

    P: torch.Tensor
    q: torch.Tensor
    A: torch.Tensor
    l: torch.Tensor
    u: torch.Tensor
    n: int
    m: int
    N: int

    @property
    def num_vars(self) -> int:
        return self.P.shape[-1]


@dataclass
class BatchConic:
    """SCS/COSMO-form conic programs: min 0.5 z'Pz + q'z  s.t.  Az + s = b,
    s in K, where K is the product of ``segments`` = ((cone, length), ...)
    in row order (zero-cone rows mean Az = b); P [B, NN, NN], q [B, NN],
    A [B, M, NN], b [B, M]."""

    P: torch.Tensor
    q: torch.Tensor
    A: torch.Tensor
    b: torch.Tensor
    segments: Tuple[Tuple[Cone, int], ...]
    n: int
    m: int
    N: int

    @property
    def num_vars(self) -> int:
        return self.P.shape[-1]


# ----------------------------------------------------------------------------
# Shared pieces
# ----------------------------------------------------------------------------

def _batch_x0(prob: Problem) -> torch.Tensor:
    return prob.x0 if prob.x0.dim() == 2 else prob.x0[None]


def _blocks(K: int, N: int, n: int, m: int, rows: int, Bt: int, like):
    """Zeros [Bt, K, rows, N, s] (s = n + m): row block k of ``rows`` rows
    against column block j of one knot; flattened and cut to NN columns by
    :func:`_flat`. (Indexing dims 1 and 3 with one index tensor puts that
    axis first: the block stacks are assigned as [K, Bt, rows, cols].)"""
    return torch.zeros((Bt, K, rows, N, n + m), dtype=like.dtype,
                       device=like.device)


def _flat(M, NN: int):
    Bt, K, r, N, s = M.shape
    return M.reshape(Bt, K * r, N * s)[..., :NN].contiguous()


def _cost_blocks(prob: Problem, Bt: int):
    """(P [B, NN, NN], q [B, NN]) from the (already dt-scaled) cost
    stacks."""
    c = prob.cost
    N, n, m = prob.N, prob.n, prob.m
    NN = N * n + (N - 1) * m
    k = torch.arange(N, device=c.Q.device)
    P = _blocks(N, N, n, m, n + m, 1, c.Q)
    P[:, k, :n, k, :n] = c.Q[:, None]
    P[:, k[:-1], n:, k[:-1], n:] = c.R[:-1, None]
    q = torch.cat([c.q, torch.cat([c.r[:-1], c.r.new_zeros((1, m))])],
                  dim=1).reshape(1, -1)[:, :NN]
    P = P.reshape(1, N * (n + m), N * (n + m))[:, :NN, :NN]
    return P.expand(Bt, NN, NN).contiguous(), q.expand(Bt, NN).contiguous()


def _dynamics_rows(prob: Problem, Bt: int):
    """Dynamics defect rows A_k x_k + B_k u_k - x_{k+1} = -d_k, then the x0
    rows x_0 = x0 (at (N-1) n .. N n, the reference's row order):
    (rows [B, N n, NN], rhs [B, N n])."""
    dyn = prob.dynamics
    if not isinstance(dyn, LTVDynamics):
        raise TypeError("batch transcription requires LTVDynamics; "
                        "relinearize nonlinear models first (the reference "
                        "does the same: OSQP/ECOS always receive the "
                        "linearized model)")
    N, n, m = prob.N, prob.n, prob.m
    NN = N * n + (N - 1) * m
    x0 = _batch_x0(prob)
    A_s = dyn.A.expand(Bt, N - 1, n, n)
    B_s = dyn.B.expand(Bt, N - 1, n, m)
    d_s = dyn.d.expand(Bt, N - 1, n)
    k = torch.arange(N - 1, device=x0.device)
    eye = torch.eye(n, dtype=x0.dtype, device=x0.device)
    M = _blocks(N - 1, N, n, m, n, Bt, x0)
    M[:, k, :, k, :n] = A_s.transpose(0, 1)
    M[:, k, :, k, n:] = B_s.transpose(0, 1)
    M[:, k, :, k + 1, :n] = -eye
    rows0 = torch.zeros((Bt, n, NN), dtype=x0.dtype, device=x0.device)
    rows0[:, :, :n] = eye
    rows = torch.cat([_flat(M, NN), rows0], dim=1)
    rhs = torch.cat([(-d_s).reshape(Bt, -1), x0.expand(Bt, n)], dim=1)
    return rows, rhs


def _constraint_rows(con, N: int, n: int, m: int, Bt: int):
    """One block's rows knot-major: M [B, N p, NN], v [B, N p] such that the
    residual is M z + v, with masked knots zeroed. Control columns exist for
    knots < N-1 only; the mask already zeroes knot N-1 of a control
    constraint."""
    if not getattr(con, "is_affine", True):
        raise TypeError(f"constraint block {con.name!r} is nonlinear; batch "
                        "QP/conic transcription requires affine blocks")
    p = con.p
    NN = N * n + (N - 1) * m
    mask = con.mask
    k = torch.arange(N, device=mask.device)
    M = _blocks(N, N, n, m, p, 1, con.b)
    M[:, k, :, k, :n] = (con.Cx * mask[:, None, None])[:, None]
    M[:, k[:-1], :, k[:-1], n:] = (con.Cu * mask[:, None, None])[:-1, None]
    v = (con.b * mask[:, None]).reshape(1, -1)
    return _flat(M, NN).expand(Bt, N * p, NN), v.expand(Bt, N * p)


# ----------------------------------------------------------------------------
# Transcriptions
# ----------------------------------------------------------------------------

def to_batch_qp(prob: Problem) -> BatchQP:
    """Problem -> OSQP-form QPs. Requires no SOC blocks (use
    :func:`to_batch_conic` for conic problems)."""
    N, n, m = prob.N, prob.n, prob.m
    Bt = _batch_x0(prob).shape[0]
    P, q = _cost_blocks(prob, Bt)
    Adyn, rhs = _dynamics_rows(prob, Bt)
    A_list, l_list, u_list = [Adyn], [rhs], [rhs]
    for con in prob.constraints:
        if con.cone == Cone.SOC:
            raise ValueError("SOC constraint in QP transcription; use "
                             "to_batch_conic")
        M, v = _constraint_rows(con, N, n, m, Bt)
        A_list.append(M)
        u_list.append(-v)
        # NONPOS: M z + v <= 0  ->  M z <= -v
        l_list.append(-v if con.cone == Cone.ZERO
                      else torch.full_like(v, -torch.inf))
    return BatchQP(P=P, q=q, A=torch.cat(A_list, dim=1),
                   l=torch.cat(l_list, dim=1), u=torch.cat(u_list, dim=1),
                   n=n, m=m, N=N)


def to_batch_conic(prob: Problem) -> BatchConic:
    """Problem -> conic programs Az + s = b, s in K.

    Mapping per block residual c = Mz + v:
      ZERO:   A=M, b=-v, zero segment      (Az = b)
      NONPOS: A=M, b=-v, nonneg segment    (Az <= b)
      SOC:    A=-M, b=v, one SOC segment per knot (b - Az in SOC)
    The dynamics and x0 rows form the leading zero segment.
    """
    N, n, m = prob.N, prob.n, prob.m
    Bt = _batch_x0(prob).shape[0]
    P, q = _cost_blocks(prob, Bt)
    Adyn, rhs = _dynamics_rows(prob, Bt)
    A_list, b_list = [Adyn], [rhs]
    segments = [(Cone.ZERO, Adyn.shape[1])]
    for con in prob.constraints:
        M, v = _constraint_rows(con, N, n, m, Bt)
        if con.cone == Cone.SOC:
            A_list.append(-M)
            b_list.append(v)
            segments += [(Cone.SOC, con.p)] * N
        else:
            A_list.append(M)
            b_list.append(-v)
            segments.append((con.cone, N * con.p))
    return BatchConic(P=P, q=q, A=torch.cat(A_list, dim=1),
                      b=torch.cat(b_list, dim=1), segments=tuple(segments),
                      n=n, m=m, N=N)


# ----------------------------------------------------------------------------
# MPC refreshers (shapes constant)
# ----------------------------------------------------------------------------

def _set_rows(v, r0: int, x0):
    return torch.cat([v[:, :r0], x0.expand(v.shape[0], x0.shape[-1]),
                      v[:, r0 + x0.shape[-1]:]], dim=1)


def qp_set_x0(qp: BatchQP, x0) -> BatchQP:
    """Refresh the x0 equality rows with x0 [B, n] (the l/u view updates of
    random_linear_problem.jl:142-143)."""
    r0 = (qp.N - 1) * qp.n
    return dataclasses.replace(qp, l=_set_rows(qp.l, r0, x0),
                               u=_set_rows(qp.u, r0, x0))


def qp_set_cost(qp: BatchQP, prob: Problem) -> BatchQP:
    """Refresh the linear cost after a tracking-window advance (the q
    update of random_linear_problem.jl:144-148)."""
    _, q = _cost_blocks(prob, qp.q.shape[0])
    return dataclasses.replace(qp, q=q)


def conic_set_x0(con: BatchConic, x0) -> BatchConic:
    r0 = (con.N - 1) * con.n
    return dataclasses.replace(con, b=_set_rows(con.b, r0, x0))


def conic_set_cost(con: BatchConic, prob: Problem) -> BatchConic:
    _, q = _cost_blocks(prob, con.q.shape[0])
    return dataclasses.replace(con, q=q)


def extract_traj(prog, x):
    """Split stacked primals x [B, NN] of a :class:`BatchQP` or
    :class:`BatchConic` into (X [B, N, n], U [B, N-1, m])."""
    n, m, N = prog.n, prog.m, prog.N
    full = torch.cat([x, x.new_zeros((x.shape[0], m))], dim=1)
    full = full.reshape(x.shape[0], N, n + m)
    return full[:, :, :n], full[:, :-1, n:]
