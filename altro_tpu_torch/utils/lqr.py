"""Classical LQR references used as test oracles (the port's copy of
``altro_tpu/utils/lqr.py``: numpy in float64, the discrete algebraic
Riccati equation by fixed-point iteration, the finite-horizon recursion
exact)."""
from __future__ import annotations

import numpy as np


def dare(A, B, Q, R, iters: int = 1000, tol: float = 1e-12):
    """Discrete algebraic Riccati equation solution by iteration."""
    A, B, Q, R = (np.asarray(x, np.float64) for x in (A, B, Q, R))
    P = Q.copy()
    for _ in range(iters):
        BtP = B.T @ P
        K = np.linalg.solve(R + BtP @ B, BtP @ A)
        Pn = Q + A.T @ P @ (A - B @ K)
        Pn = 0.5 * (Pn + Pn.T)
        if np.max(np.abs(Pn - P)) < tol:
            P = Pn
            break
        P = Pn
    return P


def dlqr(A, B, Q, R, **kw):
    """Infinite-horizon discrete LQR gain K with u = -K x."""
    P = dare(A, B, Q, R, **kw)
    A, B, R = (np.asarray(x, np.float64) for x in (A, B, R))
    return np.linalg.solve(R + B.T @ P @ B, B.T @ P @ A)


def finite_lqr(A, B, Q, R, Qf, q, r, qf, N: int):
    """Finite-horizon time-invariant LQR with affine cost terms, by exact
    backward recursion. Returns (Ks [N-1, m, n], ds [N-1, m]): the optimal
    controls are u_k = Ks[k] x_k + ds[k].

    Cost: sum_{k<N-1} 0.5 x'Qx + q'x + 0.5 u'Ru + r'u  +  0.5 x'Qf x + qf'x.
    """
    A, B, Q, R, Qf = (np.asarray(x, np.float64) for x in (A, B, Q, R, Qf))
    q, r, qf = (np.asarray(x, np.float64) for x in (q, r, qf))
    n, m = B.shape
    P = Qf.copy()
    p = qf.copy()
    Ks, ds = np.zeros((N - 1, m, n)), np.zeros((N - 1, m))
    for k in range(N - 2, -1, -1):
        Qxx = Q + A.T @ P @ A
        Quu = R + B.T @ P @ B
        Qux = B.T @ P @ A
        Qx = q + A.T @ p
        Qu = r + B.T @ p
        K = np.linalg.solve(Quu, Qux)
        d = np.linalg.solve(Quu, Qu)
        Ks[k] = -K
        ds[k] = -d
        P = Qxx - K.T @ Quu @ K
        P = 0.5 * (P + P.T)
        p = Qx - K.T @ Quu @ d
    return Ks, ds
