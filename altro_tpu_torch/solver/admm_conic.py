"""Dense ADMM conic solver, the in-framework ECOS/COSMO role (PyTorch
counterpart of ``altro_tpu/solver/admm_conic.py``): the cross-check oracle
of the conic problems (rocket, grasp, the quadruped's friction cones).
COSMO-style ADMM on

    min 0.5 z'Pz + q'z   s.t.  Az + s = b,  s in K
    (K = product of zero cones, the nonnegative orthant and SOCs)

with the splitting variable w = s:

    (P + rho A'A) z+ = -q + rho A'(b - w - y/rho)
    w+ = proj_K(b - A z+ - y / rho)
    y+ = y + rho (A z+ + w+ - b)

Zero-cone rows (equalities) use rho * RHO_EQ_SCALE. The KKT matrix is
factored once by a dense Cholesky. Termination is tested every iteration,
as in the JAX package, so the iteration counts are its; the loop runs
CHUNK iterations per host check (each lane freezing on its own test), on a
CUDA device as one CUDA graph (``solver/admm_loop.py``). Batched over a
leading lane axis like ``admm_qp``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import torch

from ..cones import Cone, project_soc
from ..transcribe import BatchConic, extract_traj  # noqa: F401  (re-export)
from . import admm_loop
from .admm_qp import amax, cho_solve, chol_nan, mv
from .graph import use_graphs

RHO_EQ_SCALE = 1e3
CHUNK = 25  # iterations per host check of the live flag


def _plan(segments):
    """The cone product as index sets: (zero rows, nonneg rows, ((p, rows
    [count, p]), ...) per SOC size), so one projection is a few gathers
    and one ``project_soc`` per SOC size, whatever the segment count."""
    zero, nonneg, soc = [], [], {}
    off = 0
    for cone, length in segments:
        rows = list(range(off, off + length))
        if cone == Cone.ZERO:
            zero += rows
        elif cone == Cone.NONPOS:
            nonneg += rows
        elif cone == Cone.SOC:
            soc.setdefault(length, []).append(rows)
        else:  # pragma: no cover
            raise ValueError(cone)
        off += length
    return (tuple(zero), tuple(nonneg),
            tuple((p, tuple(map(tuple, r))) for p, r in sorted(soc.items())))


def _indices(plan, device):
    """The row index tensors of ``plan`` on ``device``, built once per solve
    outside the loop (a host-to-device copy cannot sit in a CUDA graph)."""
    zero, nonneg, soc = plan
    return (torch.tensor(zero, dtype=torch.long, device=device),
            torch.tensor(nonneg, dtype=torch.long, device=device),
            tuple(torch.tensor(rows, dtype=torch.long, device=device)
                  for _, rows in soc))


def _project_K(idx, v):
    """Project v [B, M] onto the cone product whose rows are ``idx``
    (:func:`_indices`)."""
    zero, nonneg, soc = idx
    out = v.index_fill(1, zero, 0.0)
    out.index_copy_(1, nonneg, torch.clamp(v[:, nonneg], min=0.0))
    for rows in soc:
        out.index_copy_(1, rows.flatten(), project_soc(v[:, rows]).flatten(1))
    return out


@dataclass
class ADMMConicWork:
    prob: BatchConic
    chol: torch.Tensor     # [B, NN, NN]
    rho_vec: torch.Tensor  # [B, M]
    graphs: dict = field(default_factory=dict, repr=False, compare=False)


@dataclass
class ADMMConicSolution:
    x: torch.Tensor           # [B, NN]
    s: torch.Tensor           # [B, M]
    y: torch.Tensor           # [B, M]
    iterations: torch.Tensor  # [B]
    r_prim: torch.Tensor      # [B]
    r_dual: torch.Tensor      # [B]
    status: torch.Tensor      # [B]
    chunks: int = 0           # host checks of the live flag


def _kkt(prob: BatchConic, rho_vec):
    eye = torch.eye(prob.num_vars, dtype=prob.P.dtype, device=prob.P.device)
    return (prob.P + prob.A.transpose(-1, -2) @ (rho_vec[..., None] * prob.A)
            + 1e-8 * eye)


@torch.no_grad()
def setup(prob: BatchConic, rho: float = 0.1,
          graphs: Optional[dict] = None) -> ADMMConicWork:
    """Penalties per segment and the factored KKT matrix. ``graphs`` as in
    ``admm_qp.setup``."""
    kw = dict(dtype=prob.P.dtype, device=prob.P.device)
    rows = [torch.full((length,), rho * (RHO_EQ_SCALE if cone == Cone.ZERO
                                         else 1.0), **kw)
            for cone, length in prob.segments]
    rho_vec = torch.cat(rows).expand(prob.A.shape[0], -1).contiguous()
    return ADMMConicWork(prob=prob, chol=chol_nan(_kkt(prob, rho_vec)),
                         rho_vec=rho_vec,
                         graphs={} if graphs is None else graphs)


def update(work: ADMMConicWork, q=None, b=None) -> ADMMConicWork:
    p = work.prob
    p = dataclasses.replace(p, q=p.q if q is None else q,
                            b=p.b if b is None else b)
    return dataclasses.replace(work, prob=p)


@torch.no_grad()
def refactor(work: ADMMConicWork, prob: BatchConic) -> ADMMConicWork:
    """Swap in a conic program with new P/A values but the same segment
    structure, reusing the penalty vector and refactoring only the KKT
    matrix (the setup-once + in-place-update baseline pattern)."""
    return dataclasses.replace(work, prob=prob,
                               chol=chol_nan(_kkt(prob, work.rho_vec)))


@dataclass
class _Data:
    q: torch.Tensor
    A: torch.Tensor
    b: torch.Tensor
    rho: torch.Tensor
    chol: torch.Tensor
    idx: tuple
    eps_abs: torch.Tensor
    eps_rel: torch.Tensor
    max_iter: torch.Tensor


def _chunk(d: _Data, s):
    x, w, y, it, rp, rd, done = s
    AT = d.A.transpose(-1, -2)
    for _ in range(CHUNK):
        live = ~done & (it < d.max_iter)
        rhs = -d.q + mv(AT, d.rho * (d.b - w) - y)
        x_n = cho_solve(d.chol, rhs)
        Ax = mv(d.A, x_n)
        w_n = _project_K(d.idx, d.b - Ax - y / d.rho)
        y_n = y + d.rho * (Ax + w_n - d.b)
        rp_n = amax(Ax + w_n - d.b)
        rd_n = amax(mv(AT, d.rho * (w_n - w)))
        sp = torch.maximum(amax(Ax), torch.maximum(amax(w_n), amax(d.b)))
        tol = d.eps_abs + d.eps_rel * sp
        done_n = (rp_n < tol) & (rd_n < tol)
        l1 = live[:, None]
        x, w, y = (torch.where(l1, x_n, x), torch.where(l1, w_n, w),
                   torch.where(l1, y_n, y))
        it = torch.where(live, it + 1, it)
        rp = torch.where(live, rp_n, rp)
        rd = torch.where(live, rd_n, rd)
        done = torch.where(live, done_n, done)
    flags = torch.stack([(~done & (it < d.max_iter)).any(),
                         torch.zeros((), dtype=torch.bool, device=it.device)])
    return (x, w, y, it, rp, rd, done), None, flags


def _no_refactor(d, s, prop):  # pragma: no cover - rho is fixed
    return s


@torch.no_grad()
def solve(work: ADMMConicWork, x0: Optional[torch.Tensor] = None,
          y0: Optional[torch.Tensor] = None, eps_abs: float = 1e-6,
          eps_rel: Optional[float] = None, max_iter: int = 20000,
          graphed: Optional[bool] = None) -> ADMMConicSolution:
    """Solve every lane, warm-started from x0 [B, NN] and y0 [B, M] (zeros
    when None); ``graphed`` as in ``admm_qp.solve``."""
    p = work.prob
    kw = dict(dtype=p.P.dtype, device=p.P.device)
    Bt, NN, M = p.P.shape[0], p.num_vars, p.A.shape[1]
    plan = _plan(p.segments)
    idx = _indices(plan, kw["device"])
    x = torch.zeros((Bt, NN), **kw) if x0 is None else x0
    y = torch.zeros((Bt, M), **kw) if y0 is None else y0
    w = _project_K(idx, p.b - mv(p.A, x))
    d = _Data(q=p.q, A=p.A, b=p.b, rho=work.rho_vec, chol=work.chol,
              idx=idx,
              eps_abs=torch.tensor(eps_abs, **kw),
              eps_rel=torch.tensor(eps_abs if eps_rel is None else eps_rel,
                                   **kw),
              max_iter=torch.tensor(max_iter, dtype=torch.int32,
                                    device=kw["device"]))
    inf = torch.full((Bt,), torch.inf, **kw)
    s0 = (x, w, y, torch.zeros(Bt, dtype=torch.int32, device=kw["device"]),
          inf, inf.clone(),
          torch.zeros(Bt, dtype=torch.bool, device=kw["device"]))
    s, chunks = admm_loop.solve_loop(
        work.graphs, ("admm_conic", plan), _chunk, _no_refactor, d, s0,
        use_graphs(graphed, kw["device"]))
    x, w, y, it, rp, rd, done = s
    return ADMMConicSolution(x=x, s=w, y=y, iterations=it, r_prim=rp,
                             r_dual=rd, status=done.to(torch.int32),
                             chunks=chunks)
