"""The yardstick of the kernels' roofline shares: the least time an NVIDIA
H100 could take for a launch, from the bytes the launch must move (each
input read once, each output written once) and the FLOPs its inputs need,
at the data sheet's peaks (SXM part: 3.35 TB/s of HBM; 67 TFLOP/s in
float32 and 34 in float64 outside the tensor cores, which the kernels do
not use).

A frozen copy of the port's ``bench/kernels.py`` (``rollout_work``,
``fused_work``, ``rollout_al_work``, ``riccati_work``, ``bound_ms``), so
that a change to the program cannot move the yardstick. Each function
returns (bytes, FLOPs) of one launch over Bt lanes.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {4: 67e12, 8: 34e12}


def bound_ms(nbytes: float, flops: float, itemsize: int) -> tuple:
    """(bound in ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[itemsize] * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations"))


def rollout_work(Bt, N, n, m, L, per_lane, itemsize, groups: int = 1
                 ) -> tuple:
    """Kernel A: A/B/dd (shared, per lane or per group of ``groups``),
    Xbar, Ubar, K, d read; Xs, Us written; per (scenario, rung, knot)
    u = ubar + alpha d + K dx and x+ = A x + B u + dd."""
    N1 = N - 1
    dyn = N1 * (n * n + n * m + n) * (Bt if per_lane else groups)
    elems = (dyn + Bt * N * n + Bt * N1 * (2 * m + m * n)
             + Bt * L * (N * n + N1 * m))
    flops = Bt * L * N1 * (n + 2 * m * n + 2 * m + 2 * n * n + 2 * n * m
                           + n)
    return elems * itemsize, flops


def fused_work(Bt, N, n, m, P, soc_p, itemsize, groups: int = 1) -> tuple:
    """Kernel B. Read: the shared cost, dynamics (one stack per group of
    ``groups``) and packed constraint stacks, X, U, the multipliers, rho,
    reg; written: K, d, dV1, dV2. FLOPs per scenario-knot: the rows'
    residuals, V A and V B, the expansion entries (upper triangles of Qxx
    and Quu), one m x m Cholesky, the n + 1 solves, Quu K, and V; an SOC
    block adds its norm, its projections and two rank-1 terms per expansion
    entry."""
    N1 = N - 1
    shared = (N * (n * n + n + m * m + m + m * n + 1)
              + groups * N1 * (n * n + n * m) + N * P * (n + m + 2))
    elems = (shared + Bt * (N * n + N1 * m + N * P + N + 1)
             + Bt * (N1 * (m * n + m) + 2))
    tri_n, tri_m = n * (n + 1) // 2, m * (m + 1) // 2
    nsoc = len(soc_p)
    entry = 3 * P + 2 * n + 4 * nsoc
    knot = (2 * P * (n + m) + 2 * n * n * (n + m)
            + 2 * n * (2 * n + m + P) + 2 * m * (2 * m + n + P)
            + (tri_n + tri_m + m * n) * entry
            + 2 * m ** 3 // 3 + 4 * (n + 1) * m * m
            + 6 * m * tri_n + 4 * m * n
            + sum(2 * p + 4 * p * (n + m) for p in soc_p))
    return elems * itemsize, Bt * N * knot


def rollout_al_work(Bt, N, n, m, P, L, itemsize, groups: int = 1) -> tuple:
    """Kernel C: kernel A's rollout plus, per (scenario, rung, knot), the
    quadratic cost and each constraint row's residual and AL merit term;
    reads the shared cost and packed constraint stacks, the multipliers and
    rho, writes Xs, Us and J."""
    nbytes, flops = rollout_work(Bt, N, n, m, L, False, itemsize, groups)
    shared = N * (n * n + n + m * m + m + m * n + 1) + N * P * (n + m + 2)
    nbytes += (shared + Bt * N * (P + 1) + Bt * L) * itemsize
    flops += Bt * L * N * (2 * (n * n + m * m + m * n + n + m)
                           + 2 * P * (n + m) + 8 * P)
    return nbytes, flops


def riccati_work(Bt, N, n, m, per_lane, itemsize) -> tuple:
    """Kernel D: per-lane (or shared) A/B and the per-lane expansion read,
    K, d, dV1, dV2 written; per knot V A, V B, the Q blocks (upper
    triangles of Qxx and Quu, as ``fused_work`` counts them), one Cholesky,
    the n + 1 solves and V."""
    N1 = N - 1
    dyn = N1 * (n * n + n * m) * (Bt if per_lane else 1)
    elems = (dyn + Bt * N * (n + m + n * n + m * m + m * n) + Bt
             + Bt * (N1 * (m * n + m) + 2))
    tri_n, tri_m = n * (n + 1) // 2, m * (m + 1) // 2
    knot = (2 * n * n * (n + m) + (tri_n + tri_m + m * n) * 2 * n
            + 2 * n * (n + m) + 2 * m ** 3 // 3
            + 4 * (n + 1) * m * m + 3 * m * n * (n + 1) + 4 * m * n)
    return elems * itemsize, Bt * N1 * knot


WORK = {"kernel_a": rollout_work, "kernel_b": fused_work,
        "kernel_c": rollout_al_work, "kernel_d": riccati_work}
