"""Dense ADMM QP solver, the in-framework OSQP role (PyTorch counterpart of
``altro_tpu/solver/admm_qp.py``): the lockstep cross-check oracle and
baseline timing target of the random-linear, flexible-satellite and
quadruped QPs. The algorithm is OSQP's family:

- modified Ruiz equilibration (D/E diagonal scalings and a cost scaling c),
  which the badly scaled quadruped QP needs (state weights 5e3 against
  control weights 1e-3);
- the splitting iteration with a per-row penalty R (equality rows, l == u,
  get rho * RHO_EQ_SCALE as in OSQP):

    (P + sigma I + A' R A) xt = sigma x - q + A'(R z - y)
    z+ = clip(alpha A xt + (1-alpha) z + y / R, l, u)
    y+ = y + R (alpha A xt + (1-alpha) z - z+)

- termination on the UNSCALED residuals, tested every CHUNK iterations,
  where OSQP-style adaptive rho refactors the KKT matrix when rho moves by
  more than 5x; a chunk that produced non-finite iterates is reverted and
  pulls rho down; a refactor whose Cholesky factor fails keeps the old
  factor and rho.

Batched: every tensor of a :class:`~altro_tpu_torch.transcribe.BatchQP`
carries a leading lane axis, each lane is its own QP, and a lane that has
converged (or reached ``max_iter``) freezes while the others run, as the
JAX package's ``vmap`` of its ``lax.while_loop``. The KKT matrix is factored
by a dense Cholesky (fine at the reference's sizes, NN <= ~2k) and reused
across iterations and MPC steps. On a CUDA device (``graphed``) each chunk
is one CUDA graph (``solver/admm_loop.py``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import torch

from ..transcribe import BatchQP, extract_traj  # noqa: F401  (re-export)
from . import admm_loop
from .graph import use_graphs

RHO_EQ_SCALE = 1e3
CHUNK = 25  # ADMM iterations between residual checks / rho adaptations


def chol_nan(K):
    """Lower Cholesky factor of each matrix of K [..., n, n], NaN where the
    factorization fails (as JAX's ``cholesky``: ``torch.linalg.cholesky``
    raises instead, and ``cholesky_ex`` returns a finite partial factor),
    row-major (LAPACK's is column-major: a buffer clone of it would take
    another triangular-solve path, with other rounding)."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info == 0)[..., None, None], L,
                       torch.nan).contiguous()


def cho_solve(L, b):
    """Solve (L L') x = b for lower factors L [B, n, n], b [B, n]."""
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y,
                                         upper=True)[..., 0]


def mv(A, x):
    """A [B, r, c] @ x [B, c] -> [B, r]."""
    return (A @ x[..., None])[..., 0]


def amax(x):
    """max |x| over all but the lane axis."""
    return torch.amax(torch.abs(x).reshape(x.shape[0], -1), dim=1)


def isclose(a, b):
    """numpy's and JAX's defaults, explicit."""
    return torch.isclose(a, b, rtol=1e-5, atol=1e-8)


@dataclass
class ADMMQPWork:
    """Factored workspace (reusable across solves while P, A and rho stay
    fixed). ``graphs`` holds the chunk graphs of :func:`solve`; workspaces
    made from one another by :func:`update` and :func:`refactor` share it."""

    qp: BatchQP            # original (unscaled) problem
    chol: torch.Tensor     # [B, NN, NN] Cholesky of scaled P + sigma I + A'RA
    rho_vec: torch.Tensor  # [B, M] penalties (scaled space)
    sigma: torch.Tensor    # 0-d
    alpha: torch.Tensor    # 0-d
    D: torch.Tensor        # [B, NN] variable scaling
    E: torch.Tensor        # [B, M] constraint scaling
    c: torch.Tensor        # [B] cost scaling
    graphs: dict = field(default_factory=dict, repr=False, compare=False)


@dataclass
class ADMMQPSolution:
    x: torch.Tensor           # [B, NN] primal (unscaled)
    z: torch.Tensor           # [B, M] Ax at the solution
    y: torch.Tensor           # [B, M] duals
    iterations: torch.Tensor  # [B]
    r_prim: torch.Tensor      # [B]
    r_dual: torch.Tensor      # [B]
    status: torch.Tensor      # [B] 1 converged
    chunks: int = 0           # chunks the loop ran (host syncs)


def _ruiz(P, q, A, iters: int = 10):
    """Modified Ruiz equilibration (the OSQP scaling strategy), per lane."""
    Bt, NN = P.shape[0], P.shape[-1]
    kw = dict(dtype=P.dtype, device=P.device)
    D = torch.ones((Bt, NN), **kw)
    E = torch.ones((Bt, A.shape[1]), **kw)
    c = torch.ones(Bt, **kw)

    def dscale(nrm):
        # leave identically-zero rows/cols alone (masked constraint rows):
        # repeatedly "normalizing" them blows E up geometrically
        return torch.where(nrm > 1e-12,
                           1.0 / torch.sqrt(torch.clamp(nrm, 1e-8, 1e8)),
                           1.0)

    for _ in range(iters):
        Ps = c[:, None, None] * (D[:, :, None] * P * D[:, None, :])
        As = E[:, :, None] * A * D[:, None, :]
        col_norm = torch.maximum(torch.amax(torch.abs(Ps), dim=1),
                                 torch.amax(torch.abs(As), dim=1))
        row_norm = torch.amax(torch.abs(As), dim=2)
        D = torch.clamp(D * dscale(col_norm), 1e-6, 1e6)
        E = torch.clamp(E * dscale(row_norm), 1e-6, 1e6)
        # cost normalization
        Ps = c[:, None, None] * (D[:, :, None] * P * D[:, None, :])
        qs = c[:, None] * (D * q)
        gamma = 1.0 / torch.clamp(torch.maximum(
            torch.mean(torch.amax(torch.abs(Ps), dim=1), dim=1), amax(qs)),
            1e-8, 1e8)
        c = c * gamma
    return D, E, c


def _scaled(qp: BatchQP, D, E, c):
    Ps = c[:, None, None] * (D[:, :, None] * qp.P * D[:, None, :])
    As = E[:, :, None] * qp.A * D[:, None, :]
    return Ps, As


def _kkt(Ps, As, sigma, rho_vec):
    eye = torch.eye(Ps.shape[-1], dtype=Ps.dtype, device=Ps.device)
    return Ps + sigma * eye + As.transpose(-1, -2) @ (rho_vec[..., None] * As)


def _rho_vec(eq, rho):
    """Per-row penalties [B, M] from per-lane rho [B]."""
    return torch.where(eq, rho[:, None] * RHO_EQ_SCALE, rho[:, None])


@torch.no_grad()
def setup(qp: BatchQP, rho: float = 0.1, sigma: float = 1e-6,
          alpha: float = 1.6, scaling_iters: int = 10,
          graphs: Optional[dict] = None) -> ADMMQPWork:
    """Scale and factor ``qp``. ``graphs``: the chunk-graph cache to share
    (as a lockstep that sets up a new QP of the same shapes every step
    does); None starts a new one."""
    kw = dict(dtype=qp.P.dtype, device=qp.P.device)
    D, E, c = _ruiz(qp.P, qp.q, qp.A, scaling_iters)
    Ps, As = _scaled(qp, D, E, c)
    eq = isclose(qp.l, qp.u)
    rho_vec = torch.where(eq, torch.tensor(rho * RHO_EQ_SCALE, **kw),
                          torch.tensor(rho, **kw))
    sig = torch.tensor(sigma, **kw)
    return ADMMQPWork(qp=qp, chol=chol_nan(_kkt(Ps, As, sig, rho_vec)),
                      rho_vec=rho_vec, sigma=sig,
                      alpha=torch.tensor(alpha, **kw), D=D, E=E, c=c,
                      graphs={} if graphs is None else graphs)


def update(work: ADMMQPWork, q=None, l=None, u=None) -> ADMMQPWork:
    """Refresh linear data without refactoring (OSQP.update!)."""
    qp = work.qp
    qp = dataclasses.replace(qp, q=qp.q if q is None else q,
                             l=qp.l if l is None else l,
                             u=qp.u if u is None else u)
    return dataclasses.replace(work, qp=qp)


@torch.no_grad()
def refactor(work: ADMMQPWork, qp: BatchQP) -> ADMMQPWork:
    """Swap in a QP with new P/A values but the SAME structure, reusing the
    cached Ruiz scalings and penalty pattern and refactoring only the KKT
    matrix (the reference's setup-once + in-place ``OSQP.update!(Ax=...)``,
    OSQPParams.jl:127-162). The scalings are a preconditioner, so reusing
    them across mild relinearizations is safe."""
    Ps, As = _scaled(qp, work.D, work.E, work.c)
    return dataclasses.replace(
        work, qp=qp, chol=chol_nan(_kkt(Ps, As, work.sigma, work.rho_vec)))


@dataclass
class _Data:
    """What the loop reads: the scaled and unscaled problem, the scalings
    and the tolerances (0-d tensors, so one graph serves every value)."""

    Ps: torch.Tensor
    qs: torch.Tensor
    As: torch.Tensor
    ls: torch.Tensor
    us: torch.Tensor
    eq: torch.Tensor
    P: torch.Tensor
    q: torch.Tensor
    A: torch.Tensor
    D: torch.Tensor
    E: torch.Tensor
    c: torch.Tensor
    sigma: torch.Tensor
    alpha: torch.Tensor
    eps_abs: torch.Tensor
    eps_rel: torch.Tensor
    max_iter: torch.Tensor


def _unscaled_residuals(d: _Data, x, z, y):
    xu = d.D * x
    zu = z / d.E
    yu = (d.E / d.c[:, None]) * y
    Ax = mv(d.A, xu)
    Px = mv(d.P, xu)
    Aty = mv(d.A.transpose(-1, -2), yu)
    rp = amax(Ax - zu)
    rd = amax(Px + d.q + Aty)
    sp = torch.maximum(amax(Ax), amax(zu))
    sd = torch.maximum(amax(Px), torch.maximum(amax(Aty), amax(d.q)))
    ok = (rp < d.eps_abs + d.eps_rel * sp) & (rd < d.eps_abs + d.eps_rel * sd)
    return rp, rd, ok


def _chunk(d: _Data, s):
    """CHUNK iterations of every live lane, its residuals and its rho
    proposal (see ``solver/admm_loop.py``)."""
    x, z, y, rho, chol, it, rp, rd, done = s
    live = ~done & (it < d.max_iter)
    rv = _rho_vec(d.eq, rho)
    AsT = d.As.transpose(-1, -2)
    xn, zn, yn = x, z, y
    for _ in range(CHUNK):
        rhs = d.sigma * xn - d.qs + mv(AsT, rv * zn - yn)
        xt = cho_solve(chol, rhs)
        Axt = mv(d.As, xt)
        x_hat = d.alpha * xt + (1 - d.alpha) * xn
        z_hat = d.alpha * Axt + (1 - d.alpha) * zn
        z_new = torch.minimum(torch.maximum(z_hat + yn / rv, d.ls), d.us)
        yn = yn + rv * (z_hat - z_new)
        xn, zn = x_hat, z_new

    # non-finite guard (seen in float32 with aggressive rho): revert the
    # chunk and pull rho toward a safer value before refactoring
    finite = (torch.isfinite(xn).all(1) & torch.isfinite(yn).all(1)
              & torch.isfinite(zn).all(1))
    f1 = finite[:, None]
    xn = torch.where(f1, xn, x)
    zn = torch.where(f1, zn, z)
    yn = torch.where(f1, yn, y)
    rp_n, rd_n, done_n = _unscaled_residuals(d, xn, zn, yn)
    done_n = done_n & finite

    # OSQP-style adaptive rho on relative scaled residuals
    Ax = mv(d.As, xn)
    rp_rel = amax(Ax - zn) / torch.clamp(
        torch.maximum(amax(Ax), amax(zn)), min=1e-10)
    Px = mv(d.Ps, xn)
    Aty = mv(AsT, yn)
    rd_rel = amax(Px + d.qs + Aty) / torch.clamp(
        torch.maximum(amax(Px), torch.maximum(amax(Aty), amax(d.qs))),
        min=1e-10)
    ratio = torch.sqrt(rp_rel / torch.clamp(rd_rel, min=1e-16))
    rho_prop = torch.clamp(rho * ratio, 1e-4, 1e4)
    rho_prop = torch.where(finite, rho_prop,
                           torch.clamp(rho * 0.1, min=1e-4))
    adapt = live & ~done_n & (~finite | (rho_prop > 5.0 * rho)
                              | (rho_prop < rho / 5.0))

    l1 = live[:, None]
    out = (torch.where(l1, xn, x), torch.where(l1, zn, z),
           torch.where(l1, yn, y), rho, chol,
           torch.where(live, it + CHUNK, it), torch.where(live, rp_n, rp),
           torch.where(live, rd_n, rd), torch.where(live, done_n, done))
    flags = torch.stack([(~out[8] & (out[5] < d.max_iter)).any(),
                         adapt.any()])
    return out, (rho_prop, adapt), flags


def _refactor(d: _Data, s, prop):
    """Refactor every lane at its proposed rho; keep the new factor and rho
    where the lane adapts and the factor is finite."""
    x, z, y, rho, chol, it, rp, rd, done = s
    rho_prop, adapt = prop
    L = chol_nan(_kkt(d.Ps, d.As, d.sigma, _rho_vec(d.eq, rho_prop)))
    take = adapt & torch.isfinite(L).flatten(1).all(1)
    return (x, z, y, torch.where(take, rho_prop, rho),
            torch.where(take[:, None, None], L, chol), it, rp, rd, done)


@torch.no_grad()
def solve(work: ADMMQPWork, x0: Optional[torch.Tensor] = None,
          y0: Optional[torch.Tensor] = None, eps_abs: float = 1e-5,
          eps_rel: Optional[float] = None, max_iter: int = 4000,
          graphed: Optional[bool] = None) -> ADMMQPSolution:
    """Solve every lane of ``work.qp``, warm-started from primal x0 [B, NN]
    and dual y0 [B, M] (unscaled; zeros when None). Termination: OSQP's
    eps_abs + eps_rel * scale on the unscaled residuals (the reference
    configures OSQP with eps_abs = eps_rel = cost_tolerance,
    random_linear_problem.jl:71-74; ``eps_rel`` None is eps_abs).
    ``graphed`` (None: on a CUDA device): the loop runs its chunks as CUDA
    graphs cached in ``work.graphs``; else eagerly."""
    qp = work.qp
    D, E, c = work.D, work.E, work.c
    kw = dict(dtype=qp.P.dtype, device=qp.P.device)
    Ps, As = _scaled(qp, D, E, c)
    eq = isclose(qp.l, qp.u)
    d = _Data(Ps=Ps, qs=c[:, None] * (D * qp.q), As=As, ls=E * qp.l,
              us=E * qp.u, eq=eq, P=qp.P, q=qp.q, A=qp.A, D=D, E=E, c=c,
              sigma=work.sigma, alpha=work.alpha,
              eps_abs=torch.tensor(eps_abs, **kw),
              eps_rel=torch.tensor(eps_abs if eps_rel is None else eps_rel,
                                   **kw),
              max_iter=torch.tensor(max_iter, dtype=torch.int32,
                                    device=kw["device"]))
    Bt, NN, M = qp.P.shape[0], qp.num_vars, qp.A.shape[1]
    # warm starts map into scaled space
    x = torch.zeros((Bt, NN), **kw) if x0 is None else x0 / D
    y = torch.zeros((Bt, M), **kw) if y0 is None else (c[:, None] / E) * y0
    z = torch.minimum(torch.maximum(mv(As, x), d.ls), d.us)
    first = torch.argmin(eq.to(torch.int32), dim=1)
    rho0 = work.rho_vec.gather(1, first[:, None])[:, 0]
    rho0 = torch.where(eq.all(1), work.rho_vec[:, 0] / RHO_EQ_SCALE, rho0)
    inf = torch.full((Bt,), torch.inf, **kw)
    s0 = (x, z, y, rho0, work.chol,
          torch.zeros(Bt, dtype=torch.int32, device=kw["device"]), inf,
          inf.clone(), torch.zeros(Bt, dtype=torch.bool, device=kw["device"]))
    s, chunks = admm_loop.solve_loop(
        work.graphs, ("admm_qp",), _chunk, _refactor, d, s0,
        use_graphs(graphed, kw["device"]))
    x, z, y, rho, chol, it, rp, rd, done = s
    return ADMMQPSolution(x=D * x, z=z / E, y=(E / c[:, None]) * y,
                          iterations=it, r_prim=rp, r_dual=rd,
                          status=done.to(torch.int32), chunks=chunks)
