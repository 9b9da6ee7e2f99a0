"""MPC-structured ADMM QP solver, the timing-grade OSQP role (PyTorch
counterpart of ``altro_tpu/solver/knot_admm.py``).

The dense ADMM of ``admm_qp`` treats the batch QP as an unstructured
[NN, NN] problem. This solver keeps it in knot form

    variables  w_k = [x_k; u_k]            (u_{N-1} is a sigma-padded dummy)
    rows       dynamics defects [N-1, n]   (equality, rho * 1e3)
               x0 equality [n]             (equality, rho * 1e3)
               constraint blocks [N, p_b]  (equality or inequality per block)

so the KKT matrix P + sigma I + A' R A is block tridiagonal in (n+m)-sized
knot blocks: its factor is a sequence of N block Cholesky steps, O(N
(n+m)^3), and the per-block inverses are materialized once so the two
sweeps of every banded solve are small matrix-vector products. Same
algorithm family as ``admm_qp``: modified Ruiz equilibration on the
structured data, over-relaxed splitting with per-row-group penalties,
unscaled-residual termination every CHUNK iterations and OSQP-style
adaptive rho with a banded refactor; a refactor whose factor is not finite
keeps the old one and the old rho.

Batched: every tensor carries a leading lane axis, and a converged lane
freezes while the others run (``vmap`` of the JAX solver). The banded
factor and solve are Python loops of N batched steps; on a CUDA device each
chunk of CHUNK iterations is one CUDA graph (``solver/admm_loop.py``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

from ..cones import Cone, project_soc
from ..dynamics import LTVDynamics
from ..problem import Problem
from . import admm_loop
from .admm_qp import amax, chol_nan
from .graph import use_graphs

RHO_EQ_SCALE = 1e3
SIGMA = 1e-6
ALPHA = 1.6
CHUNK = 25


@dataclass
class KnotQP:
    """Knot-structured QP data (unscaled), every tensor with a leading lane
    axis B: Q [B,N,n,n], q [B,N,n], R [B,N-1,m,m], r [B,N-1,m]; dynamics
    A [B,N-1,n,n], B [B,N-1,n,m], d [B,N-1,n]; x0 [B,n]; per constraint
    block Cx [B,N,p,n], Cu [B,N,p,m], l and u [B,N,p] (rows ``Cx x + Cu u``
    with bounds [l, u]; masked knots have all-zero rows and l = u = 0)."""

    Q: torch.Tensor
    q: torch.Tensor
    R: torch.Tensor
    r: torch.Tensor
    A: torch.Tensor
    B: torch.Tensor
    d: torch.Tensor
    x0: torch.Tensor
    Cx: Tuple[torch.Tensor, ...]
    Cu: Tuple[torch.Tensor, ...]
    l: Tuple[torch.Tensor, ...]
    u: Tuple[torch.Tensor, ...]
    cones: Tuple[Cone, ...] = ()

    @property
    def dims(self):
        return self.Q.shape[1], self.Q.shape[2], self.R.shape[3]


def to_knot_qp(prob: Problem) -> KnotQP:
    """Problem -> knot-structured programs, one per lane of ``prob.x0``
    (the same math as ``transcribe.to_batch_qp`` / ``to_batch_conic``,
    without the dense operators). SOC blocks are stored in conic form: the
    row maps are negated so that the slack s = b - (Cx x + Cu u) must lie in
    the SOC."""
    if not isinstance(prob.dynamics, LTVDynamics):
        raise TypeError("knot ADMM requires LTVDynamics (relinearize first)")
    N, n, m = prob.N, prob.n, prob.m
    c = prob.cost
    x0 = prob.x0 if prob.x0.dim() == 2 else prob.x0[None]
    Bt = x0.shape[0]

    def lanes(a):  # a shared stack to every lane
        return a.expand((Bt,) + tuple(a.shape)).contiguous()

    def lanes_dyn(a, rank):  # a shared or per-lane dynamics stack
        return a.expand((Bt,) + tuple(a.shape[-rank:])).contiguous()

    Cx, Cu, l, u, cones = [], [], [], [], []
    for con in prob.constraints:
        if not getattr(con, "is_affine", True):
            raise TypeError(f"nonlinear block {con.name!r}")
        mask = con.mask
        Cx_b = con.Cx * mask[:, None, None]
        Cu_b = con.Cu * mask[:, None, None]
        Cu_b = torch.cat([Cu_b[:-1], torch.zeros_like(Cu_b[-1:])])
        v = con.b * mask[:, None]
        if con.cone == Cone.ZERO:
            l_b, u_b = -v, -v
        elif con.cone == Cone.NONPOS:  # rows: Cx x + Cu u <= -v
            l_b, u_b = torch.full_like(v, -torch.inf), -v
        else:  # SOC: b - rows in SOC, rows = -(residual map)
            Cx_b, Cu_b = -Cx_b, -Cu_b
            l_b, u_b = v, v
        # masked knots: l = u = 0 so the all-zero rows read as satisfied
        l_b = torch.where(mask[:, None] > 0, l_b, 0.0)
        u_b = torch.where(mask[:, None] > 0, u_b, 0.0)
        Cx.append(lanes(Cx_b))
        Cu.append(lanes(Cu_b))
        l.append(lanes(l_b))
        u.append(lanes(u_b))
        cones.append(con.cone)
    dyn = prob.dynamics
    return KnotQP(Q=lanes(c.Q), q=lanes(c.q), R=lanes(c.R[:-1]),
                  r=lanes(c.r[:-1]), A=lanes_dyn(dyn.A, 3),
                  B=lanes_dyn(dyn.B, 3), d=lanes_dyn(dyn.d, 2),
                  x0=x0.contiguous(), Cx=tuple(Cx), Cu=tuple(Cu),
                  l=tuple(l), u=tuple(u), cones=tuple(cones))


# ---------------------------------------------------------------------------
# batched helpers
# ---------------------------------------------------------------------------

def _bmv(M, x):
    """[..., r, c] @ [..., c] -> [..., r]."""
    return (M @ x[..., None])[..., 0]


def _bmtv(M, y):
    """[..., r, c]' @ [..., r] -> [..., c]."""
    return (M.transpose(-1, -2) @ y[..., None])[..., 0]


def _lane(v, nd: int):
    """A per-lane [B] value shaped to broadcast against rank-``nd``
    stacks."""
    return v.reshape((-1,) + (1,) * (nd - 1))


# ---------------------------------------------------------------------------
# Ruiz equilibration on structured data
# ---------------------------------------------------------------------------

def _dscale(nrm):
    return torch.where(nrm > 1e-12,
                       1.0 / torch.sqrt(torch.clamp(nrm, 1e-8, 1e8)), 1.0)


def _ruiz(qp: KnotQP, iters: int = 10):
    N, n, m = qp.dims
    Bt = qp.Q.shape[0]
    kw = dict(dtype=qp.Q.dtype, device=qp.Q.device)
    Dx = torch.ones((Bt, N, n), **kw)
    Du = torch.ones((Bt, N, m), **kw)
    E_dyn = torch.ones((Bt, N - 1, n), **kw)
    E_x0 = torch.ones((Bt, n), **kw)
    E_blk = tuple(torch.ones_like(lb) for lb in qp.l)
    csc = torch.ones(Bt, **kw)
    cones = qp.cones or tuple(None for _ in qp.l)

    for _ in range(iters):
        cs = _lane(csc, 4)
        Qs = torch.abs(cs * Dx[..., :, None] * qp.Q * Dx[..., None, :])
        Rs = torch.abs(cs * Du[:, :-1, :, None] * qp.R
                       * Du[:, :-1, None, :])
        colx = torch.amax(Qs, dim=2)
        colu = torch.cat([torch.amax(Rs, dim=2),
                          torch.zeros((Bt, 1, m), **kw)], dim=1)
        Adyn = torch.abs(E_dyn[..., :, None] * qp.A * Dx[:, :-1, None, :])
        Bdyn = torch.abs(E_dyn[..., :, None] * qp.B * Du[:, :-1, None, :])
        Sdyn = torch.abs(E_dyn * Dx[:, 1:])
        ax = torch.amax(Adyn, dim=2)
        colx = torch.cat([torch.maximum(colx[:, :-1], ax), colx[:, -1:]], 1)
        colx = torch.cat([colx[:, :1], torch.maximum(colx[:, 1:], Sdyn)], 1)
        bu = torch.amax(Bdyn, dim=2)
        colu = torch.cat([torch.maximum(colu[:, :-1], bu), colu[:, -1:]], 1)
        row_x0 = torch.abs(E_x0 * Dx[:, 0])
        colx = torch.cat([torch.maximum(colx[:, :1], row_x0[:, None]),
                          colx[:, 1:]], 1)
        rows_dyn = torch.maximum(torch.amax(Adyn, dim=3),
                                 torch.maximum(torch.amax(Bdyn, dim=3), Sdyn))

        rows_blk = []
        for Cx, Cu, E, cn in zip(qp.Cx, qp.Cu, E_blk, cones):
            Cxs = torch.abs(E[..., :, None] * Cx * Dx[:, :, None, :])
            Cus = torch.abs(E[..., :, None] * Cu * Du[:, :, None, :])
            colx = torch.maximum(colx, torch.amax(Cxs, dim=2))
            colu = torch.maximum(colu, torch.amax(Cus, dim=2))
            rb = torch.maximum(torch.amax(Cxs, dim=3),
                               torch.amax(Cus, dim=3))
            if cn == Cone.SOC:
                # a SOC is only invariant under uniform scaling: share one
                # row scale per knot (the max keeps dscale conservative)
                rb = torch.amax(rb, dim=2, keepdim=True).expand(rb.shape)
            rows_blk.append(rb)

        Dx = torch.clamp(Dx * _dscale(colx), 1e-6, 1e6)
        Du = torch.clamp(Du * _dscale(colu), 1e-6, 1e6)
        E_dyn = torch.clamp(E_dyn * _dscale(rows_dyn), 1e-6, 1e6)
        E_x0 = torch.clamp(E_x0 * _dscale(row_x0), 1e-6, 1e6)
        E_blk = tuple(torch.clamp(E * _dscale(rb), 1e-6, 1e6)
                      for E, rb in zip(E_blk, rows_blk))

        Qs = torch.abs(cs * Dx[..., :, None] * qp.Q * Dx[..., None, :])
        qs = torch.abs(_lane(csc, 3) * Dx * qp.q)
        rs = torch.abs(_lane(csc, 3) * Du[:, :-1] * qp.r)
        pmean = torch.mean(torch.amax(Qs, dim=2).reshape(Bt, -1), dim=1)
        qmax = torch.maximum(amax(qs), amax(rs))
        gamma = 1.0 / torch.clamp(torch.maximum(pmean, qmax), 1e-8, 1e8)
        csc = csc * gamma
    return Dx, Du, E_dyn, E_x0, E_blk, csc


# ---------------------------------------------------------------------------
# Banded KKT
# ---------------------------------------------------------------------------

@dataclass
class _Stacks:
    """The scaled operator stacks of assembly, matvecs and solves."""

    Qs: torch.Tensor
    Rs: torch.Tensor
    A_s: torch.Tensor
    B_s: torch.Tensor
    S_s: torch.Tensor    # row k's -x_{k+1} coefficient
    x0_s: torch.Tensor
    Cx_s: tuple
    Cu_s: tuple


def _scaled_stacks(qp: KnotQP, Dx, Du, E_dyn, E_x0, E_blk, csc) -> _Stacks:
    cs = _lane(csc, 4)
    return _Stacks(
        Qs=cs * (Dx[..., :, None] * qp.Q * Dx[..., None, :]),
        Rs=cs * (Du[:, :-1, :, None] * qp.R * Du[:, :-1, None, :]),
        A_s=E_dyn[..., :, None] * qp.A * Dx[:, :-1, None, :],
        B_s=E_dyn[..., :, None] * qp.B * Du[:, :-1, None, :],
        S_s=E_dyn * Dx[:, 1:],
        x0_s=E_x0 * Dx[:, 0],
        Cx_s=tuple(E[..., :, None] * Cx * Dx[:, :, None, :]
                   for E, Cx in zip(E_blk, qp.Cx)),
        Cu_s=tuple(E[..., :, None] * Cu * Du[:, :, None, :]
                   for E, Cu in zip(E_blk, qp.Cu)))


def _assemble_banded(st: _Stacks, N: int, n: int, m: int, rho, eq_blk):
    """Scaled K = P + sigma I + A' R A as block-tridiagonal stacks: diag
    [B, N, s, s] and lower couplings [B, N-1, s, s] (block k+1 rows, block k
    cols), s = n + m, for per-lane rho [B]. The dummy terminal control gets
    sigma only."""
    s = n + m
    Bt = rho.shape[0]
    kw = dict(dtype=st.Qs.dtype, device=st.Qs.device)
    rho_eq = _lane(rho * RHO_EQ_SCALE, 4)
    diag = torch.zeros((Bt, N, s, s), **kw)
    diag[:, :, :n, :n] = st.Qs
    diag[:, :-1, n:, n:] = st.Rs
    diag = diag + SIGMA * torch.eye(s, **kw)
    J = torch.cat([st.A_s, st.B_s], dim=3)                   # [B, N-1, n, s]
    diag[:, :-1] += rho_eq * (J.transpose(-1, -2) @ J)
    diag[:, 1:, :n, :n] += rho_eq * torch.diag_embed(st.S_s * st.S_s)
    lower = torch.zeros((Bt, N - 1, s, s), **kw)
    lower[:, :, :n, :] = -rho_eq * st.S_s[..., None] * J
    diag[:, 0, :n, :n] += (_lane(rho * RHO_EQ_SCALE, 3)
                           * torch.diag_embed(st.x0_s * st.x0_s))

    for Cx, Cu, eq in zip(st.Cx_s, st.Cu_s, eq_blk):
        rho_b = rho_eq if eq else _lane(rho, 4)
        C = torch.cat([Cx, Cu], dim=3)                       # [B, N, p, s]
        diag = diag + rho_b * (C.transpose(-1, -2) @ C)
    return diag, lower


def _banded_cholesky(diag, lower):
    """Block-tridiagonal Cholesky K = L L' with L block-bidiagonal. Returns
    (Linv [B,N,s,s], the per-block L_k^{-1}, F [B,N-1,s,s]); the inverses
    are materialized once so the banded solves inside the ADMM loop are
    matrix-vector products, not triangular solves. A block whose
    factorization fails is NaN, and so is every block after it."""
    s = diag.shape[-1]
    eye = torch.eye(s, dtype=diag.dtype, device=diag.device)
    L = chol_nan(diag[:, 0])
    Linv = [torch.linalg.solve_triangular(L, eye, upper=False)]
    F = []
    for k in range(1, diag.shape[1]):
        F_k = lower[:, k - 1] @ Linv[-1].transpose(-1, -2)
        L = chol_nan(diag[:, k] - F_k @ F_k.transpose(-1, -2))
        Linv.append(torch.linalg.solve_triangular(L, eye, upper=False))
        F.append(F_k)
    return torch.stack(Linv, dim=1), torch.stack(F, dim=1)


def _banded_solve(Linv, F, b):
    """Solve K w = b with the inverted band factor; b, w are [B, N, s]."""
    N = b.shape[1]
    z = [_bmv(Linv[:, 0], b[:, 0])]
    for k in range(1, N):
        z.append(_bmv(Linv[:, k], b[:, k] - _bmv(F[:, k - 1], z[-1])))
    w = [_bmtv(Linv[:, -1], z[-1])]
    for k in range(N - 2, -1, -1):
        w.append(_bmtv(Linv[:, k], z[k] - _bmtv(F[:, k], w[-1])))
    return torch.stack(w[::-1], dim=1)


# ---------------------------------------------------------------------------
# Workspace / solve
# ---------------------------------------------------------------------------

@dataclass
class KnotADMMWork:
    qp: KnotQP
    Linv: torch.Tensor          # [B, N, s, s] per-block L^{-1} of the factor
    F: torch.Tensor             # [B, N-1, s, s]
    Dx: torch.Tensor
    Du: torch.Tensor
    E_dyn: torch.Tensor
    E_x0: torch.Tensor
    E_blk: Tuple[torch.Tensor, ...]
    csc: torch.Tensor
    rho: torch.Tensor           # [B]
    eq_blk: Tuple[bool, ...]
    graphs: dict = field(default_factory=dict, repr=False, compare=False)


@dataclass
class KnotADMMSolution:
    X: torch.Tensor             # [B, N, n]
    U: torch.Tensor             # [B, N-1, m]
    iterations: torch.Tensor    # [B]
    r_prim: torch.Tensor
    r_dual: torch.Tensor
    status: torch.Tensor
    chunks: int = 0             # chunks the loop ran (host syncs)


def _is_eq_blk(qp: KnotQP):
    if qp.cones:
        return tuple(cn == Cone.ZERO for cn in qp.cones)
    return tuple(bool(torch.isfinite(lb).all()) for lb in qp.l)


def _factor(st: _Stacks, dims, rho, eq_blk):
    N, n, m = dims
    return _banded_cholesky(*_assemble_banded(st, N, n, m, rho, eq_blk))


@torch.no_grad()
def setup(qp: KnotQP, rho: float = 0.1, scaling_iters: int = 10,
          graphs: Optional[dict] = None) -> KnotADMMWork:
    """Scalings and the banded factor at ``rho``. ``graphs`` as in
    ``admm_qp.setup``."""
    Dx, Du, E_dyn, E_x0, E_blk, csc = _ruiz(qp, scaling_iters)
    eq_blk = _is_eq_blk(qp)
    rho_v = torch.full_like(csc, rho)
    Linv, F = _factor(_scaled_stacks(qp, Dx, Du, E_dyn, E_x0, E_blk, csc),
                      qp.dims, rho_v, eq_blk)
    return KnotADMMWork(qp=qp, Linv=Linv, F=F, Dx=Dx, Du=Du, E_dyn=E_dyn,
                        E_x0=E_x0, E_blk=E_blk, csc=csc, rho=rho_v,
                        eq_blk=eq_blk,
                        graphs={} if graphs is None else graphs)


@torch.no_grad()
def refactor(work: KnotADMMWork, qp: KnotQP) -> KnotADMMWork:
    """New P/A values of the same structure: reuse the scalings, refactor
    the band at the workspace's rho, O(N (n+m)^3) (the structured OSQP
    setup-once + update! pattern)."""
    st = _scaled_stacks(qp, work.Dx, work.Du, work.E_dyn, work.E_x0,
                        work.E_blk, work.csc)
    Linv, F = _factor(st, qp.dims, work.rho, work.eq_blk)
    return dataclasses.replace(work, qp=qp, Linv=Linv, F=F)


@dataclass
class _Data:
    qp: KnotQP
    st: _Stacks
    Dx: torch.Tensor
    Du: torch.Tensor
    E_dyn: torch.Tensor
    E_x0: torch.Tensor
    E_blk: tuple
    csc: torch.Tensor
    qs: torch.Tensor
    rs: torch.Tensor
    ld: torch.Tensor
    lx0: torch.Tensor
    lb: tuple
    ub: tuple
    eps_abs: torch.Tensor
    eps_rel: torch.Tensor
    max_iter: torch.Tensor


def _proj_block(cn, v, lo, up):
    if cn == Cone.SOC:
        # slack s = up - v must lie in the SOC
        return up - project_soc(up - v)
    return torch.minimum(torch.maximum(v, lo), up)


def _matvec(st: _Stacks, X, U):
    dyn = (_bmv(st.A_s, X[:, :-1]) + _bmv(st.B_s, U[:, :-1])
           - st.S_s * X[:, 1:])
    x0r = st.x0_s * X[:, 0]
    blocks = tuple(_bmv(Cx, X) + _bmv(Cu, U)
                   for Cx, Cu in zip(st.Cx_s, st.Cu_s))
    return dyn, x0r, blocks


def _pad(v, first: bool):
    """[B, K, c] -> [B, K+1, c] with a zero knot after (first) or before."""
    z = torch.zeros_like(v[:, :1])
    return torch.cat([v, z] if first else [z, v], dim=1)


def _at_first(v, K: int):
    """[B, c] -> [B, K, c], v at knot 0 and zeros after."""
    return torch.cat([v[:, None], v.new_zeros((v.shape[0], K - 1,
                                               v.shape[1]))], dim=1)


def _rmatvec(st: _Stacks, dyn, x0r, blocks):
    N = dyn.shape[1] + 1
    X = _pad(_bmtv(st.A_s, dyn), True) + _pad(-st.S_s * dyn, False)
    U = _pad(_bmtv(st.B_s, dyn), True)
    X = X + _at_first(st.x0_s * x0r, N)
    for Cx, Cu, gb in zip(st.Cx_s, st.Cu_s, blocks):
        X = X + _bmtv(Cx, gb)
        U = U + _bmtv(Cu, gb)
    return X, U


def _tmax(ts, like):
    out = torch.zeros(like.shape[0], dtype=like.dtype, device=like.device)
    for t in ts:
        out = torch.maximum(out, amax(t))
    return out


def _unscaled_residuals(d: _Data, X, U, z, y):
    qp = d.qp
    Xu = d.Dx * X
    Uu = d.Du * U
    # primal: max |A w - z| over the row groups, with OSQP's relative scale
    dyn_u = (_bmv(qp.A, Xu[:, :-1]) + _bmv(qp.B, Uu[:, :-1]) - Xu[:, 1:])
    zu0 = z[0] / d.E_dyn
    rp = amax(dyn_u - zu0)
    sp = torch.maximum(amax(dyn_u), amax(zu0))
    zux = z[1] / d.E_x0
    rp = torch.maximum(rp, amax(Xu[:, 0] - zux))
    sp = torch.maximum(sp, torch.maximum(amax(Xu[:, 0]), amax(zux)))
    for Cx, Cu, E, g in zip(qp.Cx, qp.Cu, d.E_blk, z[2]):
        row_u = _bmv(Cx, Xu) + _bmv(Cu, Uu)
        gu = g / E
        rp = torch.maximum(rp, amax(row_u - gu))
        sp = torch.maximum(sp, torch.maximum(amax(row_u), amax(gu)))
    # dual: max |P w + q + A' y| unscaled
    Px = _bmv(qp.Q, Xu) + qp.q
    Pu = _bmv(qp.R, Uu[:, :-1]) + qp.r
    yd = (d.E_dyn / _lane(d.csc, 3)) * y[0]
    yx0 = (d.E_x0 / d.csc[:, None]) * y[1]
    N = X.shape[1]
    AtX = _pad(_bmtv(qp.A, yd), True) + _pad(-yd, False)
    AtU = _pad(_bmtv(qp.B, yd), True)
    AtX = AtX + _at_first(yx0 * 0 + yx0, N)
    for Cx, Cu, E, g in zip(qp.Cx, qp.Cu, d.E_blk, y[2]):
        gs = (E / _lane(d.csc, 3)) * g
        AtX = AtX + _bmtv(Cx, gs)
        AtU = AtU + _bmtv(Cu, gs)
    rd = torch.maximum(amax(Px + AtX), amax(Pu + AtU[:, :-1]))
    sd = torch.maximum(amax(Px), torch.maximum(amax(AtX), amax(AtU)))
    ok = (rp < d.eps_abs + d.eps_rel * sp) & (rd < d.eps_abs + d.eps_rel * sd)
    return rp, rd, ok


def _scaled_rel_residuals(d: _Data, X, U, z, y):
    """Relative primal and dual residuals in scaled space (the OSQP
    adaptive-rho signal)."""
    st = d.st
    Az = _matvec(st, X, U)
    num_p = torch.maximum(
        amax(Az[0] - z[0]),
        torch.maximum(amax(Az[1] - z[1]),
                      _tmax(tuple(g - gz for g, gz in zip(Az[2], z[2])),
                            X)))
    den_p = torch.maximum(_tmax(Az[2], X),
                          torch.maximum(amax(Az[0]), amax(Az[1])))
    den_p = torch.maximum(den_p, _tmax(z[2], X))
    den_p = torch.maximum(den_p, torch.maximum(amax(z[0]), amax(z[1])))
    Px = _bmv(st.Qs, X) + d.qs
    Pu = _bmv(st.Rs, U[:, :-1]) + d.rs[:, :-1]
    AtX, AtU = _rmatvec(st, *y)
    num_d = torch.maximum(amax(Px + AtX), amax(Pu + AtU[:, :-1]))
    den_d = torch.maximum(amax(Px), torch.maximum(amax(AtX), amax(AtU)))
    return (num_p / torch.clamp(den_p, min=1e-10),
            num_d / torch.clamp(den_d, min=1e-10))


def _where(c, a, b):
    """Per-lane select over a tree of tuples of tensors."""
    if isinstance(a, tuple):
        return tuple(_where(c, x, y) for x, y in zip(a, b))
    return torch.where(_lane(c, a.dim()), a, b)


def _chunk(static, d: _Data, s):
    cones, eq_blk = static
    X, U, z, y, rho, Linv, F, it, rp, rd, done = s
    n = X.shape[2]
    live = ~done & (it < d.max_iter)
    st = d.st
    rho_eq = rho * RHO_EQ_SCALE
    rho_blk = tuple(_lane(rho_eq if eq else rho, 3) for eq in eq_blk)
    r2, r3 = _lane(rho_eq, 2), _lane(rho_eq, 3)
    Xn, Un, zn, yn = X, U, z, y
    for _ in range(CHUNK):
        rz = (r3 * zn[0] - yn[0], r2 * zn[1] - yn[1],
              tuple(r_ * g - yb for r_, g, yb in zip(rho_blk, zn[2], yn[2])))
        AtX, AtU = _rmatvec(st, *rz)
        b = torch.cat([SIGMA * Xn - d.qs + AtX, SIGMA * Un - d.rs + AtU],
                      dim=2)
        w = _banded_solve(Linv, F, b)
        Xt, Ut = w[..., :n], w[..., n:]
        X_new = ALPHA * Xt + (1 - ALPHA) * Xn
        U_new = ALPHA * Ut + (1 - ALPHA) * Un
        Az = _matvec(st, Xt, Ut)
        zh = (ALPHA * Az[0] + (1 - ALPHA) * zn[0],
              ALPHA * Az[1] + (1 - ALPHA) * zn[1],
              tuple(ALPHA * g + (1 - ALPHA) * gz
                    for g, gz in zip(Az[2], zn[2])))
        z_new = (d.ld, d.lx0,                       # equality rows: z = b
                 tuple(_proj_block(cn, g + yb / r_, lo, up)
                       for cn, g, yb, r_, lo, up in
                       zip(cones, zh[2], yn[2], rho_blk, d.lb, d.ub)))
        yn = (yn[0] + r3 * (zh[0] - z_new[0]),
              yn[1] + r2 * (zh[1] - z_new[1]),
              tuple(yb + r_ * (g - gn) for yb, r_, g, gn in
                    zip(yn[2], rho_blk, zh[2], z_new[2])))
        Xn, Un, zn = X_new, U_new, z_new
    rp_n, rd_n, done_n = _unscaled_residuals(d, Xn, Un, zn, yn)

    # OSQP-style adaptive rho; the banded refactor is O(N (n+m)^3)
    rp_rel, rd_rel = _scaled_rel_residuals(d, Xn, Un, zn, yn)
    rho_prop = torch.clamp(
        rho * torch.sqrt(rp_rel / torch.clamp(rd_rel, min=1e-16)), 1e-6, 1e6)
    adapt = live & ~done_n & ((rho_prop > 5.0 * rho)
                              | (rho_prop < rho / 5.0))
    out = (_where(live, Xn, X), _where(live, Un, U), _where(live, zn, z),
           _where(live, yn, y), rho, Linv, F,
           torch.where(live, it + CHUNK, it), torch.where(live, rp_n, rp),
           torch.where(live, rd_n, rd), torch.where(live, done_n, done))
    flags = torch.stack([(~out[10] & (out[7] < d.max_iter)).any(),
                         adapt.any()])
    return out, (rho_prop, adapt), flags


def _refactor(static, d: _Data, s, prop):
    """Refactor every lane at its proposed rho; keep the new band and rho
    where the lane adapts and the factor is finite."""
    _, eq_blk = static
    X, U, z, y, rho, Linv, F, it, rp, rd, done = s
    rho_prop, adapt = prop
    N, n, m = d.qp.dims
    L_n, F_n = _factor(d.st, (N, n, m), rho_prop, eq_blk)
    take = adapt & torch.isfinite(L_n).flatten(1).all(1)
    return (X, U, z, y, torch.where(take, rho_prop, rho),
            _where(take, L_n, Linv), _where(take, F_n, F), it, rp, rd, done)


@torch.no_grad()
def solve(work: KnotADMMWork, eps_abs: float = 1e-5,
          eps_rel: Optional[float] = None, max_iter: int = 4000,
          graphed: Optional[bool] = None) -> KnotADMMSolution:
    """Solve every lane from zero. ``graphed`` as in ``admm_qp.solve``."""
    qp = work.qp
    N, n, m = qp.dims
    Bt = qp.Q.shape[0]
    kw = dict(dtype=qp.Q.dtype, device=qp.Q.device)
    cones = qp.cones or tuple(None for _ in qp.l)
    st = _scaled_stacks(qp, work.Dx, work.Du, work.E_dyn, work.E_x0,
                        work.E_blk, work.csc)
    c3 = _lane(work.csc, 3)
    d = _Data(
        qp=qp, st=st, Dx=work.Dx, Du=work.Du, E_dyn=work.E_dyn,
        E_x0=work.E_x0, E_blk=work.E_blk, csc=work.csc,
        qs=c3 * (work.Dx * qp.q),
        rs=torch.cat([c3 * (work.Du[:, :-1] * qp.r),
                      torch.zeros((Bt, 1, m), **kw)], dim=1),
        ld=work.E_dyn * (-qp.d), lx0=work.E_x0 * qp.x0,
        lb=tuple(E * lo for E, lo in zip(work.E_blk, qp.l)),
        ub=tuple(E * up for E, up in zip(work.E_blk, qp.u)),
        eps_abs=torch.tensor(eps_abs, **kw),
        eps_rel=torch.tensor(eps_abs if eps_rel is None else eps_rel, **kw),
        max_iter=torch.tensor(max_iter, dtype=torch.int32,
                              device=kw["device"]))
    X = torch.zeros((Bt, N, n), **kw)
    U = torch.zeros((Bt, N, m), **kw)
    z = (d.ld, d.lx0, tuple(_proj_block(cn, g, lo, up) for cn, g, lo, up
                            in zip(cones, _matvec(st, X, U)[2], d.lb,
                                   d.ub)))
    y = (torch.zeros_like(z[0]), torch.zeros_like(z[1]),
         tuple(torch.zeros_like(g) for g in z[2]))
    inf = torch.full((Bt,), torch.inf, **kw)
    s0 = (X, U, z, y, work.rho, work.Linv, work.F,
          torch.zeros(Bt, dtype=torch.int32, device=kw["device"]), inf,
          inf.clone(), torch.zeros(Bt, dtype=torch.bool, device=kw["device"]))
    static = (cones, work.eq_blk)
    s, chunks = admm_loop.solve_loop(
        work.graphs, ("knot_admm",) + static,
        lambda d_, s_: _chunk(static, d_, s_),
        lambda d_, s_, p_: _refactor(static, d_, s_, p_), d, s0,
        use_graphs(graphed, kw["device"]))
    X, U, z, y, rho, Linv, F, it, rp, rd, done = s
    return KnotADMMSolution(X=work.Dx * X, U=(work.Du * U)[:, :-1],
                            iterations=it, r_prim=rp, r_dual=rd,
                            status=done.to(torch.int32), chunks=chunks)
