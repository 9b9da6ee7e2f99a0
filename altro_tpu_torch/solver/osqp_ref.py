"""Reference implementation of the published OSQP algorithm (host/NumPy):
the port's copy of ``altro_tpu/solver/osqp_ref.py``, a host oracle as in the
JAX package.

Why this exists: the reference benchmarks time stock OSQP
(benchmarks/quadruped/Woofer/MPCControl/Structs/OSQPParams.jl:127-128 —
eps_abs = eps_rel = 1e-4, warm_start = true,
defaults otherwise), and the round-4 verdict asked for the transcribed
trot QP to be run through stock OSQP once to pin the warm-iteration floor
of the native knot ADMM (14 iters / 0.67 ms). Stock OSQP is NOT
installable here (no network egress, no bundled wheel), so this module
reimplements the published algorithm — Stellato, Banjac, Goulart,
Bemporad & Boyd, "OSQP: an operator splitting solver for quadratic
programs" (Math. Prog. Comp. 2020) — mechanism-for-mechanism with the
v0.6 C-implementation defaults:

- modified Ruiz equilibration on the [[P, A'], [A, 0]] KKT with cost
  normalization (``scaling`` = 10 passes), applied at setup only;
- constraint-type rho vector: rho_eq = 1e3 * rho for rows with l == u,
  clamped to [1e-6, 1e6] (RHO_MIN/RHO_MAX, RHO_EQ_OVER_RHO_INEQ);
- the sigma-regularized quasi-definite KKT [[P + sigma I, A'],
  [A, -diag(1/rho)]], factored sparsely (scipy splu in the QDLDL role),
  alpha-over-relaxed ADMM iteration (sigma = 1e-6, alpha = 1.6);
- UNSCALED residual termination every ``check_termination`` = 25
  iterations: r_p <= eps_abs + eps_rel max(|Ax|, |z|),
  r_d <= eps_abs + eps_rel max(|Px|, |A'y|, |q|) (inf norms);
- adaptive rho: rho *= sqrt(rel r_p / rel r_d), re-factoring when the
  estimate moves by more than 5x. Stock OSQP picks the adaptation
  interval from measured setup/iteration timing; that is machine-
  dependent, so for reproducibility the check runs at every termination
  check (interval 25) — the one documented deviation;
- ``update(q, A, l, u)`` re-factors but RETAINS scaling, rho, and the
  warm iterate (OSQP.update! + warm_start = true semantics);
- polish: OFF (the stock default, and the reference never enables it).

This is an oracle, not a production path: it exists so the repo's
OSQP-role numbers can be checked against the real algorithm's iteration
counts on identical problem sequences (tools/exp_osqp_oracle.py).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

RHO_MIN, RHO_MAX = 1e-6, 1e6
RHO_EQ_OVER_RHO_INEQ = 1e3
ADAPTIVE_RHO_TOL = 5.0
MIN_SCALING, MAX_SCALING = 1e-4, 1e4


@dataclass
class OSQPRefResult:
    x: np.ndarray
    y: np.ndarray
    iterations: int
    status: int              # 1 = solved, 0 = max_iter
    r_prim: float
    r_dual: float
    solve_time: float        # seconds, the info.solve_time analog
    rho_updates: int


def _ruiz_equilibrate(P, q, A, scaling_iters):
    """Modified Ruiz equilibration with cost scaling (OSQP paper alg. 2).
    Returns (D, E, c): x-scaling diag, row-scaling diag, cost scalar."""
    n = P.shape[0]
    m = A.shape[0]
    D = np.ones(n)
    E = np.ones(m)
    c = 1.0
    Ps, qs, As = P.copy(), q.copy(), A.copy()
    for _ in range(scaling_iters):
        # column inf-norms of the scaled KKT [[c P, A'], [A, 0]]
        np_cols = np.maximum(np.abs(Ps).max(axis=0, initial=0.0),
                             np.abs(As).max(axis=0, initial=0.0))
        na_rows = np.abs(As).max(axis=1, initial=0.0)
        delta = 1.0 / np.sqrt(np.clip(np.concatenate([np_cols, na_rows]),
                                      MIN_SCALING, MAX_SCALING))
        d, e = delta[:n], delta[n:]
        Ps = Ps * d[:, None] * d[None, :]
        qs = qs * d
        As = As * e[:, None] * d[None, :]
        D *= d
        E *= e
        # cost normalization
        pcol_means = np.mean(np.abs(Ps).max(axis=0, initial=0.0))
        gamma = 1.0 / np.clip(max(pcol_means, np.abs(qs).max(initial=0.0)),
                              MIN_SCALING, MAX_SCALING)
        Ps *= gamma
        qs *= gamma
        c *= gamma
    return D, E, c


class OSQPRef:
    """Setup-once / update / warm solve, mirroring the OSQP C API subset
    the reference uses (setup!, update!(q, Ax, l, u), warm_start, solve!)."""

    def __init__(self, P, q, A, l, u, eps_abs=1e-4, eps_rel=1e-4,
                 rho=0.1, sigma=1e-6, alpha=1.6, max_iter=4000,
                 check_termination=25, scaling=10, adaptive_rho=True):
        self.P = np.asarray(P, np.float64)
        self.q = np.asarray(q, np.float64)
        self.A = np.asarray(A, np.float64)
        self.l = np.asarray(l, np.float64)
        self.u = np.asarray(u, np.float64)
        self.n, self.m = self.P.shape[0], self.A.shape[0]
        self.eps_abs, self.eps_rel = eps_abs, eps_rel
        self.sigma, self.alpha = sigma, alpha
        self.max_iter = max_iter
        self.check_termination = check_termination
        self.adaptive_rho = adaptive_rho

        # scaling: computed ONCE at setup (OSQP behavior)
        self.D, self.E, self.c = _ruiz_equilibrate(
            self.P, self.q, self.A, scaling)
        self._scale_problem()

        # constraint-type rho vector on the SCALED problem
        self.rho_bar = float(rho)
        self._build_rho()
        self._factor()

        self.x = np.zeros(self.n)   # scaled iterates
        self.z = np.zeros(self.m)
        self.y = np.zeros(self.m)

    # -- internals ---------------------------------------------------------
    def _scale_problem(self):
        D, E, c = self.D, self.E, self.c
        self.Ps = c * (self.P * D[:, None] * D[None, :])
        self.qs = c * (self.q * D)
        self.As = self.A * E[:, None] * D[None, :]
        self.ls = np.where(np.isfinite(self.l), self.l * E, self.l)
        self.us = np.where(np.isfinite(self.u), self.u * E, self.u)

    def _build_rho(self):
        eq = np.isfinite(self.ls) & np.isfinite(self.us) \
            & (self.us - self.ls < 1e-10)
        loose = ~np.isfinite(self.ls) & ~np.isfinite(self.us)
        r = np.clip(self.rho_bar, RHO_MIN, RHO_MAX)
        self.rho_vec = np.full(self.m, r)
        self.rho_vec[eq] = np.clip(r * RHO_EQ_OVER_RHO_INEQ,
                                   RHO_MIN, RHO_MAX)
        self.rho_vec[loose] = RHO_MIN

    def _factor(self):
        K = sp.bmat(
            [[sp.csc_matrix(self.Ps) + self.sigma * sp.eye(self.n),
              sp.csc_matrix(self.As).T],
             [sp.csc_matrix(self.As),
              -sp.diags(1.0 / self.rho_vec)]], format="csc")
        self._lu = spla.splu(K)

    # -- API ---------------------------------------------------------------
    def warm_start(self, x=None, y=None):
        if x is not None:
            self.x = np.asarray(x, np.float64) / self.D
        if y is not None:
            self.y = np.asarray(y, np.float64) * self.E / self.c
        self.z = self.As @ self.x

    def update(self, q=None, A=None, l=None, u=None, P=None):
        """OSQP.update! semantics: new values, same sparsity/structure;
        scaling, rho, factor-when-possible, and the warm iterate are all
        retained (factor is rebuilt only when P or A change)."""
        refactor = False
        if q is not None:
            self.q = np.asarray(q, np.float64)
        if l is not None:
            self.l = np.asarray(l, np.float64)
        if u is not None:
            self.u = np.asarray(u, np.float64)
        if A is not None:
            self.A = np.asarray(A, np.float64)
            refactor = True
        if P is not None:
            self.P = np.asarray(P, np.float64)
            refactor = True
        self._scale_problem()
        if refactor:
            self._factor()

    def solve(self) -> OSQPRefResult:
        t0 = time.perf_counter()
        n, m = self.n, self.m
        sig, al = self.sigma, self.alpha
        rho = self.rho_vec
        x, z, y = self.x, self.z, self.y
        Ps, qs, As = self.Ps, self.qs, self.As
        rho_updates = 0
        it_done = self.max_iter
        status = 0
        r_prim = r_dual = np.inf
        for it in range(1, self.max_iter + 1):
            rhs = np.concatenate([sig * x - qs, z - y / rho])
            sol = self._lu.solve(rhs)
            x_t = sol[:n]
            z_t = z + (sol[n:] - y) / rho
            x = al * x_t + (1 - al) * x
            z_pre = al * z_t + (1 - al) * z + y / rho
            z_new = np.clip(z_pre, self.ls, self.us)
            y = rho * (z_pre - z_new)  # y + rho(z_pre - y/rho... ) folded
            z = z_new
            if it % self.check_termination == 0 or it == self.max_iter:
                # UNSCALED residuals and tolerances
                xu = self.D * x
                yu = (self.E / self.c) * y
                Ax = self.A @ xu
                zu = z / self.E
                Px = self.P @ xu
                Aty = self.A.T @ yu
                r_prim = np.abs(Ax - zu).max(initial=0.0)
                r_dual = np.abs(Px + self.q + Aty).max(initial=0.0) / 1.0
                ep = self.eps_abs + self.eps_rel * max(
                    np.abs(Ax).max(initial=0.0), np.abs(zu).max(initial=0.0))
                ed = self.eps_abs + self.eps_rel * max(
                    np.abs(Px).max(initial=0.0),
                    np.abs(Aty).max(initial=0.0),
                    np.abs(self.q).max(initial=0.0))
                if r_prim <= ep and r_dual <= ed:
                    status, it_done = 1, it
                    break
                if self.adaptive_rho:
                    rp_rel = r_prim / max(ep - self.eps_abs, 1e-30)
                    rd_rel = r_dual / max(ed - self.eps_abs, 1e-30)
                    est = self.rho_bar * np.sqrt(
                        max(rp_rel, 1e-30) / max(rd_rel, 1e-30))
                    est = float(np.clip(est, RHO_MIN, RHO_MAX))
                    if (est > self.rho_bar * ADAPTIVE_RHO_TOL
                            or est < self.rho_bar / ADAPTIVE_RHO_TOL):
                        self.rho_bar = est
                        self._build_rho()
                        self._factor()
                        rho = self.rho_vec
                        rho_updates += 1
        self.x, self.z, self.y = x, z, y
        return OSQPRefResult(
            x=self.D * x, y=(self.E / self.c) * y,
            iterations=it_done, status=status,
            r_prim=float(r_prim), r_dual=float(r_dual),
            solve_time=time.perf_counter() - t0, rho_updates=rho_updates)
