"""Kernels A (ladder rollout), B (fused AL expansion + Riccati), C (ladder +
AL merit) and D (Riccati pass from an expansion) alone, at the main paths'
shapes, timed on one card beside their bounds.

    python -m altro_tpu_torch.bench.kernels [--against DIR] [--wide]

Prints one line per (kernel, shape, dtype): the kernel's device time (see
:func:`time_ms`: CUDA events around REPS back-to-back launches queued behind
a sleep on the stream, divided by REPS) and its bound, the least time the
card could take: the larger of the bytes the function must move (each input
read once, each output written once) over 3.35 TB/s and its FLOPs over the
card's peak for their type, 67 TFLOP/s in float32 (outside the tensor
cores: the port keeps float32 at full precision, so TF32 is barred) and 67
TFLOP/s in float64 (through the tensor cores' DMMA; 34 outside them) (H100
SXM data sheet). A runs at the flagship's L=3 and L=1 and the quadruped's
per-lane L=11, B on the flagship and the rocket window, C on the rocket
window at L=6, D on the quadruped's per-lane expansion; B also on grasp's
window (13 rows in 4 blocks) and cold problem (19 rows in 5) and on the
flexsat regulator (N=80, one NONPOS block of 6 rows), C on grasp's window
at L=3 and on flexsat at L=6; B, C at L=11 and A's init form at the
quadruped closed loop's one robot (B=1, N=15, 24 NONPOS rows or 4 cones
and 8 NONPOS rows in 5 blocks). Kernels B and D are also timed on the flagship's
random-linear model (shared dynamics; D on the solver's AL expansion of the
inputs B expands itself) at the flagship's widths and at (n, m) = (13, 6)
and (7, 3), which no main path uses. The wide bodies (n or m above 32) run
at ``WIDE_SHAPES`` (the state_dim sweep's n = 35, 45, 55 with m = 2, and
n = m = 64), N=21, at one lane and at B=1024: A at L=11 and L=1, B, C at
L=11 and D (``wide_cases``). The naive rocket (N=301, n=6, m=3: the goal
ZERO block and three quadratic norm blocks, which take the split route)
runs D with shared A/B on its per-lane expansion and A at its L=11 ladder,
at B=1024 and at one lane (``naive_rocket_inputs``); ``--wide`` times the
wide bodies' rows alone. ``--against DIR`` names the root
of another checkout of this repository (for example the parent commit,
unpacked with ``git archive`` into ``build/``): each turn runs in a process
of its own, in the order other, this, this, other, on the same inputs
(numpy seeds), so two versions of the kernels compare on one card. The
last line is the whole result as JSON.

The input builders also serve ``chip_smoke.py``'s parity phase.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

FLAG_B, ROCKET_B, QUAD_B, GRASP_B, FLEX_B = 1024, 1024, 1024, 1024, 1024
FLAG_N = 30
FLAG_LADDER = (1.0, 0.5, 0.0)
QUAD_LADDER = tuple(0.5 ** i for i in range(10)) + (0.0,)
ROCKET_LADDER = (1.0, 0.5, 0.25, 0.125, 0.0625, 0.0)
GRASP_LADDER = (1.0, 0.5, 0.0)
FLEX_LADDER = (1.0, 0.5, 0.25, 0.125, 0.0625, 0.0)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {4: 67e12, 8: 67e12}   # by element size: f32, f64
# launches per timing, and the sleep they queue behind (cycles at the
# H100's 1.98 GHz boost clock; a lower clock sleeps longer)
REPS = 20
HEAD_START_MS = 20
HEAD_START_CYCLES = int(HEAD_START_MS * 1.98e6)
# widths of kernels B and D that no main path uses, on the flagship's model
OTHER_WIDTHS = ((13, 6), (7, 3))
# the wide bodies' shapes (n, m): the state_dim sweep's points above 32
# (m = 2, N = 21) and the TPU kernels' widest problem
WIDE_SHAPES = ((35, 2), (45, 2), (55, 2), (64, 64))
WIDE_N = 21
# the batch at which the wide bodies are timed beside one lane
WIDE_BATCH = 1024
# the naive rocket: the cold solve's iteration whose iterate feeds the
# kernels, and its batches
NAIVE_IT = 30
NAIVE_BATCHES = (1024, 1)


def time_ms(fn, kernel: bool = False, reps: int = REPS) -> float:
    """Time of one call of ``fn``: CUDA events around ``reps`` (REPS)
    back-to-back calls after a warm-up, divided by ``reps``. The calls queue behind a
    HEAD_START_MS sleep on the stream, so when the host enqueues them faster
    than that, the events time the device alone: a kernel's wrapper (about
    0.07 ms of host time per call) no longer hides a shorter kernel. A plain
    PyTorch version whose calls take longer to enqueue is timed with its
    host time. ``kernel``: raise if the sleep ended before the last call was
    queued, so that a kernel's time never includes the host's."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HEAD_START_CYCLES)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    queued = not a.query()
    b.synchronize()
    if kernel and not queued:
        raise RuntimeError(f"the host took longer than {HEAD_START_MS} ms to "
                           f"queue {reps} launches: the kernel's time would "
                           "include the host's")
    return a.elapsed_time(b) / reps


def bound_ms(nbytes: float, flops: float, itemsize: int) -> tuple:
    """(bound in ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[itemsize] * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations"))


def rollout_work(Bt, N, n, m, L, per_lane, itemsize, groups: int = 1
                 ) -> tuple:
    """(bytes, FLOPs) of kernel A: A/B/dd (shared, per lane or per group of
    ``groups``), Xbar, Ubar, K, d read; Xs, Us written; per (scenario,
    rung, knot) u = ubar + alpha d + K dx and x+ = A x + B u + dd."""
    N1 = N - 1
    dyn = N1 * (n * n + n * m + n) * (Bt if per_lane else groups)
    elems = (dyn + Bt * N * n + Bt * N1 * (2 * m + m * n)
             + Bt * L * (N * n + N1 * m))
    flops = Bt * L * N1 * (n + 2 * m * n + 2 * m + 2 * n * n + 2 * n * m
                           + n)
    return elems * itemsize, flops


def fused_work(Bt, N, n, m, P, soc_p, itemsize, groups: int = 1) -> tuple:
    """(bytes, FLOPs) of kernel B. Read: the shared cost, dynamics (one
    stack per group of ``groups``) and packed constraint stacks, X, U, the
    multipliers, rho, reg; written: K, d, dV1, dV2. FLOPs per
    scenario-knot: the rows' residuals, V A and V B, the expansion entries
    (upper triangles of Qxx and Quu), one m x m Cholesky, the n + 1 solves,
    Quu K, and V; an SOC block adds its norm, its projections and two
    rank-1 terms per expansion entry."""
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
    """(bytes, FLOPs) of kernel C: kernel A's rollout plus, per (scenario,
    rung, knot), the quadratic cost and each constraint row's residual and
    AL merit term; reads the shared cost and packed constraint stacks, the
    multipliers and rho, writes Xs, Us and J."""
    nbytes, flops = rollout_work(Bt, N, n, m, L, False, itemsize, groups)
    shared = N * (n * n + n + m * m + m + m * n + 1) + N * P * (n + m + 2)
    nbytes += (shared + Bt * N * (P + 1) + Bt * L) * itemsize
    flops += Bt * L * N * (2 * (n * n + m * m + m * n + n + m)
                           + 2 * P * (n + m) + 8 * P)
    return nbytes, flops


def riccati_work(Bt, N, n, m, per_lane, itemsize) -> tuple:
    """(bytes, FLOPs) of kernel D: per-lane (or shared) A/B and the per-lane
    expansion read, K, d, dV1, dV2 written; per knot V A, V B, the Q blocks
    (upper triangles of Qxx and Quu, as ``fused_work`` counts them), one
    Cholesky, the n + 1 solves and V."""
    N1 = N - 1
    dyn = N1 * (n * n + n * m) * (Bt if per_lane else 1)
    elems = (dyn + Bt * N * (n + m + n * n + m * m + m * n) + Bt
             + Bt * (N1 * (m * n + m) + 2))
    tri_n, tri_m = n * (n + 1) // 2, m * (m + 1) // 2
    knot = (2 * n * n * (n + m) + (tri_n + tri_m + m * n) * 2 * n
            + 2 * n * (n + m) + 2 * m ** 3 // 3
            + 4 * (n + 1) * m * m + 3 * m * n * (n + 1) + 4 * m * n)
    return elems * itemsize, Bt * N1 * knot


def _split_args(pm, X, U, lams, rhos, reg) -> dict:
    """Kernel D's arguments on the split route at the fused kernel's
    inputs: the shared dynamics and the solver's AL expansion of X, U and
    the multipliers (``riccati``), and their work (``riccati_work``)."""
    from altro_tpu_torch.constraints import DualState
    from altro_tpu_torch.solver.altro import _al_expansion_cd

    expansion = (a.contiguous() for a in _al_expansion_cd(
        pm.cost, pm.constraints,
        tuple(DualState(lam=lam, rho=rho) for lam, rho in zip(lams, rhos)),
        X, U))
    return dict(riccati=(pm.dynamics.A, pm.dynamics.B, *expansion, reg),
                riccati_work=riccati_work(X.shape[0], pm.N, pm.n, pm.m,
                                          False, X.element_size()))


def flagship_inputs(dtype, dev, B: int = FLAG_B, widths=(12, 6),
                    N: int = FLAG_N) -> dict:
    """Kernel B's and kernel A's arguments at the flagship shapes (B=1024,
    n=12, m=6, N=30, one NONPOS block of 2m rows; seed 7): X, U off any
    solve, |u| > 3 on a third of the entries (active and inactive rows),
    half the lanes regularised; the ladder at L=3 on the plain version's
    gains, and the L=1 init form (K = d = 0, alpha = 1); and kernel D's, the
    shared dynamics with the solver's AL expansion of the same X, U and
    multipliers. ``widths`` and ``N``: the same random-linear model at
    another (n, m) and horizon."""
    import torch
    from altro_tpu_torch.models import random_linear as rl
    from altro_tpu_torch.ops import riccati_fused
    from altro_tpu_torch.ops.blocks import pack_blocks

    # the window as flagship_setup builds it (its seed, one step of track)
    n_track = N + 3
    rng = np.random.default_rng(1)
    full = rl.gen_random_linear(rng, *widths, n_track, dtype=dtype,
                                device=dev)
    prob = rl.gen_tracking_mpc(full, *rl.gen_trajectory(rng, full, n_track),
                               N)
    (con,) = prob.constraints
    dyn = prob.dynamics
    N, n, m, p = prob.N, prob.n, prob.m, con.p
    rng = np.random.default_rng(7)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    X = t(rng.standard_normal((B, N, n)))
    U = t(3.0 * rng.standard_normal((B, N - 1, m)))
    lam = t(np.abs(rng.standard_normal((B, N, p))))
    rho = torch.full((B, N), 1e3, dtype=dtype, device=dev)
    reg = t(np.where(rng.random(B) < 0.5, 0.0, 1e-2))
    fused = (prob.cost, dyn.A, dyn.B, prob.constraints, X, U, (lam,),
             (rho,), reg)
    ref = riccati_fused.fused_expand_backward_reference(*fused)
    K, d = ref[0].contiguous(), ref[1].contiguous()
    return dict(
        fused=fused, fused_ref=ref,
        packed=pack_blocks(prob.constraints, N, n, m, X),
        fused_work=fused_work(B, N, n, m, p, (), X.element_size()),
        **_split_args(prob, X, U, (lam,), (rho,), reg),
        ladder=(dyn.A, dyn.B, dyn.d, X, U, K, d, FLAG_LADDER),
        ladder_work=rollout_work(B, N, n, m, len(FLAG_LADDER), False,
                                 X.element_size()),
        init=(dyn.A, dyn.B, dyn.d, X, U, torch.zeros_like(K),
              torch.zeros_like(d), (1.0,)),
        init_work=rollout_work(B, N, n, m, 1, False, X.element_size()))


def wide_inputs(dtype, dev, B: int, n: int, m: int, N: int = WIDE_N
                ) -> dict:
    """All four kernels' arguments at a width above the group bodies'
    (n or m > 32: the wide bodies): the random-linear tracking model of the
    state_dim sweep at (n, m), N knots, with its NONPOS control bounds
    (2m rows) while m <= 4, and above that 8 NONPOS rows (bounds on the
    first four controls) and one SOC block of 4 rows (|u[4:7]| <= 2).
    Seed 13: states and controls off any solve, multipliers
    rho (|c| + 1) N(0, 1) with rho 1e3, so that lam + rho c takes both signs
    on the NONPOS rows and the cone lands inside, on the polar side and
    between; half the lanes regularised. B's arguments, D's (shared dynamics,
    the solver's AL expansion of the same point), A's at the drivers' L=11
    ladder on the plain version's gains and its init form (L=1), C's at
    L=11."""
    import dataclasses

    import torch
    from altro_tpu_torch.constraints import bound_constraint, norm_constraint2
    from altro_tpu_torch.models import random_linear as rl
    from altro_tpu_torch.ops import riccati_fused
    from altro_tpu_torch.ops.blocks import pack_blocks

    rng = np.random.default_rng(13)
    full = rl.gen_random_linear(rng, n, m, N + 3, dtype=dtype, device=dev)
    prob = rl.gen_tracking_mpc(full, *rl.gen_trajectory(rng, full, N + 3),
                               N)
    if m > 4:
        kw = dict(dtype=dtype, device=dev)
        bound = np.full(m, np.inf)
        bound[:4] = 3.0
        sel = torch.zeros((3, m), **kw)
        sel[:, 4:7] = torch.eye(3, **kw)
        prob = dataclasses.replace(prob, constraints=(
            bound_constraint(N, n, m, u_min=-bound, u_max=bound, **kw),
            norm_constraint2(N, n, m, sel, torch.zeros(m, **kw), offset=2.0,
                             **kw)))
    blocks, dyn = prob.constraints, prob.dynamics

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    X = t(rng.standard_normal((B, N, n)))
    U = t(3.0 * rng.standard_normal((B, N - 1, m)))
    rho = torch.full((B, N), 1e3, dtype=dtype, device=dev)
    lams = tuple(rho[..., None] * (c.evaluate(X, U).abs() + 1.0)
                 * t(rng.standard_normal((B, N, c.p))) for c in blocks)
    rhos = (rho,) * len(blocks)
    reg = t(np.where(rng.random(B) < 0.5, 0.0, 1e-2))
    packed = pack_blocks(blocks, N, n, m, X)
    fused = (prob.cost, dyn.A, dyn.B, blocks, X, U, lams, rhos, reg)
    ref = riccati_fused.fused_expand_backward_reference(*fused)
    K, d = ref[0].contiguous(), ref[1].contiguous()
    soc_p = tuple(c.p for c in blocks if c.cone.name == "SOC")
    item = X.element_size()
    L = len(QUAD_LADDER)
    return dict(
        prob=prob, fused=fused, fused_ref=ref, packed=packed,
        fused_work=fused_work(B, N, n, m, packed.P, soc_p, item),
        **_split_args(prob, X, U, lams, rhos, reg),
        ladder=(dyn.A, dyn.B, dyn.d, X, U, K, d, QUAD_LADDER),
        ladder_work=rollout_work(B, N, n, m, L, False, item),
        init=(dyn.A, dyn.B, dyn.d, X, U, torch.zeros_like(K),
              torch.zeros_like(d), (1.0,)),
        init_work=rollout_work(B, N, n, m, 1, False, item),
        ladder_al=(prob.cost, dyn.A, dyn.B, dyn.d, blocks, X, U, K, d, lams,
                   rho, QUAD_LADDER),
        ladder_al_work=rollout_al_work(B, N, n, m, packed.P, L, item))


def rocket_inputs(dtype, dev, B: int = ROCKET_B) -> dict:
    """Kernel B's arguments on the rocket MPC window (B=1024, n=6, m=3,
    N=21, three SOC blocks of 4, 4 and 7 rows; seed 8): states 1 m and
    controls 60 N off the hover rollout, multipliers on the scale of rho c
    so that every cone case occurs, and the glideslope cone's apex at lane
    0, knot N-3 (x = y = 0, lambda_v = 0); and kernel C's at the solver's
    L=6 ladder on the plain version's gains; kernel D's on the split route
    (:func:`_split_args`)."""
    import torch
    from altro_tpu_torch.bench.conic import rocket_setup
    from altro_tpu_torch.models import rocket
    from altro_tpu_torch.ops import riccati_fused
    from altro_tpu_torch.ops.blocks import pack_blocks

    # the window's blocks and shapes do not depend on the tracked
    # trajectory: track the hover rollout (no cold solve here)
    prob = rocket.rocket_problem(dtype=dtype, device=dev)
    U_tr = rocket.hover_controls(prob)
    X_tr = prob.dynamics.rollout(prob.x0, U_tr)
    pm = rocket_setup(dtype, track=(X_tr, U_tr), device=dev).prob_mpc
    blocks, dyn = pm.constraints, pm.dynamics
    N, n, m = pm.N, pm.n, pm.m
    rng = np.random.default_rng(8)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    X = X_tr[None, :N] + t(rng.standard_normal((B, N, n)))
    U = U_tr[None, :N - 1] + t(60.0 * rng.standard_normal((B, N - 1, m)))
    lams = [3e4 * rng.standard_normal((B, N, c.p)) for c in blocks]
    X[0, N - 3, :2] = 0.0
    lams[2][0, N - 3, :-1] = 0.0
    lams = tuple(t(lam) for lam in lams)
    rhos = tuple(torch.full((B, N), 1e3, dtype=dtype, device=dev)
                 for _ in blocks)
    reg = t(np.where(rng.random(B) < 0.5, 0.0, 1e-2))
    packed = pack_blocks(blocks, N, n, m, X)
    fused = (pm.cost, dyn.A, dyn.B, blocks, X, U, lams, rhos, reg)
    ref = riccati_fused.fused_expand_backward_reference(*fused)
    return dict(
        prob=pm, fused=fused, fused_ref=ref, packed=packed,
        **_split_args(pm, X, U, lams, rhos, reg),
        ladder_al=(pm.cost, dyn.A, dyn.B, dyn.d, blocks, X, U,
                   ref[0].contiguous(), ref[1].contiguous(), lams, rhos[0],
                   ROCKET_LADDER),
        fused_work=fused_work(B, N, n, m, packed.P,
                              tuple(c.p for c in blocks), X.element_size()),
        ladder_al_work=rollout_al_work(B, N, n, m, packed.P,
                                       len(ROCKET_LADDER), X.element_size()))


def grasp_inputs(dtype, dev, B: int = GRASP_B, cold: bool = False,
                 N: int = None) -> dict:
    """Kernel B's arguments on the grasp MPC window (B=1024, n = m = 6,
    N=21; torque balance ZERO p=3, max force NONPOS p=2 and two SOC friction
    cones p=4: 13 rows in 4 blocks) or, with ``cold``, on the cold problem
    (N=61, a goal ZERO block p=6 in front: 19 rows in 5 blocks); seed 10.
    States 0.1 and forces 0.5 N off the hover rollout, multipliers on the
    scale of rho c so that every cone case occurs, and one apex lane-knot
    (lane 0, knot 1: the first contact force zero and lambda's vector part
    zero, so z = (0, lambda_s) with lambda_s = 500); and kernel C's at the
    warm solves' L=3 ladder on the plain version's gains; kernel D's on the
    split route (:func:`_split_args`). ``N``: the same form at a shorter
    horizon."""
    import torch
    from altro_tpu_torch.bench.conic import GRASP_N, GRASP_TF, grasp_setup
    from altro_tpu_torch.models import grasp
    from altro_tpu_torch.ops import riccati_fused
    from altro_tpu_torch.ops.blocks import pack_blocks

    N = (GRASP_N if cold else 21) if N is None else N
    if cold:
        o = grasp.make_grasp_object(N, GRASP_TF * (N - 1) / (GRASP_N - 1),
                                    dtype=dtype, device=dev)
        pm = grasp.grasp_problem(o, N, GRASP_TF * (N - 1) / (GRASP_N - 1))
        U_tr = grasp.hover_controls(o, N)
        X_tr = pm.dynamics.rollout(pm.x0, U_tr)
    else:
        # the window's blocks and shapes do not depend on the tracked
        # trajectory: track the hover rollout (no cold solve here)
        o = grasp.make_grasp_object(GRASP_N, GRASP_TF, dtype=dtype,
                                    device=dev)
        prob = grasp.grasp_problem(o, GRASP_N, GRASP_TF)
        U_tr = grasp.hover_controls(o, GRASP_N)
        X_tr = prob.dynamics.rollout(prob.x0, U_tr)
        pm = grasp_setup(dtype, N, track=(X_tr, U_tr), device=dev).prob_mpc
    blocks, dyn = pm.constraints, pm.dynamics
    n, m = pm.n, pm.m
    rng = np.random.default_rng(10)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    X = X_tr[None, :N] + t(0.1 * rng.standard_normal((B, N, n)))
    U = U_tr[None, :N - 1] + t(0.5 * rng.standard_normal((B, N - 1, m)))
    lams = [1e3 * rng.standard_normal((B, N, c.p)) for c in blocks]
    first_cone = len(blocks) - 2
    U[0, 1, :3] = 0.0
    lams[first_cone][0, 1, :-1] = 0.0
    lams[first_cone][0, 1, -1] = 500.0
    lams = tuple(t(lam) for lam in lams)
    rhos = tuple(torch.full((B, N), 1e3, dtype=dtype, device=dev)
                 for _ in blocks)
    reg = t(np.where(rng.random(B) < 0.5, 0.0, 1.0))
    packed = pack_blocks(blocks, N, n, m, X)
    fused = (pm.cost, dyn.A, dyn.B, blocks, X, U, lams, rhos, reg)
    ref = riccati_fused.fused_expand_backward_reference(*fused)
    soc_p = tuple(c.p for c in blocks if c.cone.name == "SOC")
    return dict(
        prob=pm, fused=fused, fused_ref=ref, packed=packed,
        **_split_args(pm, X, U, lams, rhos, reg),
        ladder_al=(pm.cost, dyn.A, dyn.B, dyn.d, blocks, X, U,
                   ref[0].contiguous(), ref[1].contiguous(), lams, rhos[0],
                   GRASP_LADDER),
        fused_work=fused_work(B, N, n, m, packed.P, soc_p, X.element_size()),
        ladder_al_work=rollout_al_work(B, N, n, m, packed.P,
                                       len(GRASP_LADDER), X.element_size()))


def flexsat_inputs(dtype, dev, B: int = FLEX_B, N: int = 80) -> dict:
    """Kernel B's arguments on the flexsat regulator (B=1024, n=12, m=3,
    N=80, one NONPOS block of 6 control-bound rows at +-0.01; seed 11):
    states 0.05 and controls 0.015 around the origin, so that about half of
    the rows are violated, multipliers |N(0, 5)| and rho 1e3, so that
    lam + rho c is positive on some rows and negative on others, half the
    lanes regularised; and kernel C's at the solver's L=6 ladder on the
    plain version's gains. ``N``: the same form at a shorter horizon."""
    import torch
    from altro_tpu_torch.models import flexible_satellite as fs
    from altro_tpu_torch.ops import riccati_fused
    from altro_tpu_torch.ops.blocks import pack_blocks

    pm = fs.flexsat_problem(N=N, dtype=dtype, device=dev)
    (con,) = pm.constraints
    dyn = pm.dynamics
    n, m, p = pm.n, pm.m, con.p
    rng = np.random.default_rng(11)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    X = t(0.05 * rng.standard_normal((B, N, n)))
    U = t(0.015 * rng.standard_normal((B, N - 1, m)))
    lams = (t(5.0 * np.abs(rng.standard_normal((B, N, p)))),)
    rhos = (torch.full((B, N), 1e3, dtype=dtype, device=dev),)
    reg = t(np.where(rng.random(B) < 0.5, 0.0, 1e-2))
    packed = pack_blocks(pm.constraints, N, n, m, X)
    fused = (pm.cost, dyn.A, dyn.B, pm.constraints, X, U, lams, rhos, reg)
    ref = riccati_fused.fused_expand_backward_reference(*fused)
    return dict(
        prob=pm, fused=fused, fused_ref=ref, packed=packed,
        ladder_al=(pm.cost, dyn.A, dyn.B, dyn.d, pm.constraints, X, U,
                   ref[0].contiguous(), ref[1].contiguous(), lams, rhos[0],
                   FLEX_LADDER),
        fused_work=fused_work(B, N, n, m, p, (), X.element_size()),
        ladder_al_work=rollout_al_work(B, N, n, m, p, len(FLEX_LADDER),
                                       X.element_size()))


def quadruped_inputs(dtype, dev, B: int = QUAD_B,
                     nonlinear: bool = False) -> dict:
    """Kernel D's arguments on the flat quadruped batch (B=1024, n=m=12,
    N=15, per-lane dynamics of 8 contact schedules; seed 9): the solver's own
    AL expansion at forces 10 N around the stance forces, states off the
    rollout and multipliers on the scale of rho c; and kernel A's at the
    solver's L=11 ladder with per-lane A/B on the plain Riccati gains.
    ``nonlinear``: the RK4 SRB model's batch (``quadruped_setup(...,
    nonlinear=True)``), D on its per-lane linearization
    (``NonlinearDynamics.linearize``) at states off the reference states
    (the model's open-loop rollout of perturbed forces can overflow)."""
    import torch
    from altro_tpu_torch.bench.families import quadruped_setup
    from altro_tpu_torch.constraints import DualState
    from altro_tpu_torch.ops import riccati
    from altro_tpu_torch.solver.altro import _al_expansion_cd

    su = quadruped_setup(B, False, dtype, dev, nonlinear)
    prob, dyn = su.prob, su.prob.dynamics
    N, n, m = prob.N, prob.n, prob.m
    rng = np.random.default_rng(9)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    x0 = su.draw_x0().to(device=dev, dtype=dtype)
    U = su.U0 + t(10.0 * rng.standard_normal((B, N - 1, m)))
    if nonlinear:
        X = su.X0 + t(0.05 * rng.standard_normal((B, N, n)))
        X[:, 0] = x0
        A, Bd, dd = dyn.linearize(X, U)
    else:
        X = dyn.rollout(x0, U) + t(0.05 * rng.standard_normal((B, N, n)))
        A, Bd, dd = dyn.A, dyn.B, dyn.d
    duals = tuple(DualState(lam=t(5.0 * rng.standard_normal((B, N, c.p))),
                            rho=torch.full((B, N), 1e2, dtype=dtype,
                                           device=dev))
                  for c in prob.constraints)
    lx, lu, lxx, luu, lux = (a.contiguous() for a in _al_expansion_cd(
        prob.cost, prob.constraints, duals, X, U))
    reg = t(np.where(rng.random(B) < 0.5, 0.0, 1e-2))
    riccati_args = (A, Bd, lx, lu, lxx, luu, lux, reg)
    ref = riccati.batched_riccati_reference(*riccati_args)
    K, d = ref[0].contiguous(), ref[1].contiguous()
    return dict(
        riccati=riccati_args, riccati_ref=ref,
        riccati_work=riccati_work(B, N, n, m, True, X.element_size()),
        ladder=(A, Bd, dd, X, U, K, d, QUAD_LADDER),
        ladder_work=rollout_work(B, N, n, m, len(QUAD_LADDER), True,
                                 X.element_size()))


def grouped_inputs(dtype, dev, B: int = QUAD_B,
                   linearized_friction: bool = False) -> dict:
    """Kernels B, C and A with a group axis at the grouped quadruped's
    shapes (``families.quadruped_setup(grouped=True)``: G = 8 contact
    schedules of B/8 lanes, n = m = 12, N=15; the friction cones, 4 SOC
    blocks and a NONPOS block, or the pyramids; seed 10): forces 10 N
    around the stance forces, states off the grouped rollout, rho 100 and
    multipliers of rho (|c| + 1) times a normal draw (both signs of
    lam + rho c on the NONPOS rows, cones inside, polar and between), half
    the lanes regularised. B's arguments (with ``grouped=True``), C's at
    the solver's L=11 ladder on the plain version's gains, A's init form
    (L=1, K = d = 0: the grouped solve's one use of A) and its L=11 ladder;
    and, beside them, B's and C's arguments with group 0's stacks shared
    by the whole batch (``shared_fused``, ``shared_ladder_al``: the shared
    launch at the same B)."""
    import torch
    from altro_tpu_torch.bench.families import quadruped_setup
    from altro_tpu_torch.ops import riccati_fused
    from altro_tpu_torch.ops.blocks import pack_blocks

    su = quadruped_setup(B, linearized_friction, dtype, dev, grouped=True)
    prob, dyn = su.prob, su.prob.dynamics
    blocks, G = prob.constraints, dyn.groups
    N, n, m = prob.N, prob.n, prob.m
    rng = np.random.default_rng(10)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    x0 = su.draw_x0().to(device=dev, dtype=dtype)
    U = su.U0 + t(10.0 * rng.standard_normal((B, N - 1, m)))
    X = dyn.rollout(x0, U) + t(0.05 * rng.standard_normal((B, N, n)))
    rho = torch.full((B, N), 1e2, dtype=dtype, device=dev)
    lams = tuple(rho[..., None] * (c.evaluate(X, U).abs() + 1.0)
                 * t(rng.standard_normal((B, N, c.p))) for c in blocks)
    rhos = (rho,) * len(blocks)
    reg = t(np.where(rng.random(B) < 0.5, 0.0, 1e-2))
    packed = pack_blocks(blocks, N, n, m, X)
    fused = (prob.cost, dyn.A, dyn.B, blocks, X, U, lams, rhos, reg)
    ref = riccati_fused.fused_expand_backward_reference(*fused, grouped=True)
    K, d = ref[0].contiguous(), ref[1].contiguous()
    soc_p = tuple(c.p for c in blocks if c.cone.name == "SOC")
    item, L = X.element_size(), len(QUAD_LADDER)
    return dict(
        prob=prob, fused=fused, fused_ref=ref, packed=packed,
        fused_work=fused_work(B, N, n, m, packed.P, soc_p, item, G),
        shared_fused=(prob.cost, dyn.A[0], dyn.B[0]) + fused[3:],
        shared_fused_work=fused_work(B, N, n, m, packed.P, soc_p, item),
        ladder_al=(prob.cost, dyn.A, dyn.B, dyn.d, blocks, X, U, K, d, lams,
                   rho, QUAD_LADDER),
        ladder_al_work=rollout_al_work(B, N, n, m, packed.P, L, item, G),
        shared_ladder_al=(prob.cost, dyn.A[0], dyn.B[0], dyn.d[0], blocks,
                          X, U, K, d, lams, rho, QUAD_LADDER),
        shared_ladder_al_work=rollout_al_work(B, N, n, m, packed.P, L, item),
        ladder=(dyn.A, dyn.B, dyn.d, X, U, K, d, QUAD_LADDER),
        ladder_work=rollout_work(B, N, n, m, L, False, item, G),
        init=(dyn.A, dyn.B, dyn.d, X, U, torch.zeros_like(K),
              torch.zeros_like(d), (1.0,)),
        init_work=rollout_work(B, N, n, m, 1, False, item, G))


# the places of the per-lane tensors and of the grouped stacks among the
# positional arguments of each kernel wrapper that takes a group axis
GROUPED_ARGS = {"fused_expand_backward": ((4, 5, 6, 7, 8), (1, 2)),
                "batched_ls_rollout_al": ((5, 6, 7, 8, 9, 10), (1, 2, 3)),
                "batched_ls_rollout": ((3, 4, 5, 6), (0, 1, 2))}


def per_group_launches(fn, args, G: int, **kw) -> tuple:
    """The shared kernel wrapper ``fn`` (B, C or A) called once per group
    of ``args`` (a grouped call's positional arguments, G groups of equal
    size) on the group's lanes and stacks, its outputs concatenated: what
    the group-indexed call must give bit for bit, since a scenario's
    arithmetic does not depend on the other scenarios of its block."""
    import torch
    lane_at, group_at = GROUPED_ARGS[fn.__name__]
    reps = args[lane_at[0]].shape[0] // G
    outs = []
    for g in range(G):
        sl = slice(g * reps, (g + 1) * reps)
        outs.append(fn(*(
            (tuple(t[sl] for t in a) if isinstance(a, tuple) else a[sl])
            if i in lane_at else a[g] if i in group_at else a
            for i, a in enumerate(args)), **kw))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def quadloop_inputs(dtype, dev, linearized_friction: bool = True) -> dict:
    """Kernels B, C and A at the quadruped closed loop's shapes: one robot
    (B=1), n = m = 12, N=15, the MPC problem linearized about the contact
    schedule at t = 0.25 s (legs 1 and 2 in swing), built in float64 on the
    CPU and cast (as ``families.quadruped_setup``); the friction pyramids
    (24 rows in 5 blocks) or cones (20 rows in 5). Seed 12: forces 10 N
    around the stance forces, states off their rollout, rho 100 and
    multipliers of rho (|c| + 1) times a normal draw, so that lam + rho c
    takes both signs on the NONPOS rows and the cones land inside, on the
    polar side and between. B's arguments, C's at the solver's L=11 ladder
    on the plain version's gains, and A's init form (L=1, K = d = 0)."""
    import torch
    from altro_tpu_torch.convert import tree_to
    from altro_tpu_torch.models.quadruped import config, controller, planner
    from altro_tpu_torch.models.quadruped.gait import GAITS
    from altro_tpu_torch.ops import riccati_fused
    from altro_tpu_torch.ops.blocks import pack_blocks

    f64 = torch.float64
    cfg = config.MPCConfig(linearized_friction=linearized_friction)
    gait = GAITS[cfg.gait_type](cfg.stance_time, cfg.swing_time)
    prob, x_des = controller.build_mpc_problem(cfg, f64)
    N, n, m, dt = cfg.N, 12, 12, cfg.dynamics_discretization
    feet0 = x_des[0:3][None, :] + planner.nominal_foot_locations()
    feet0[:, 2] = config.woofer.geometry.foot_radius
    x_ref = x_des.expand(N, 12)
    contacts, foot_locs, _ = planner.foot_history(
        torch.tensor(0.25, dtype=f64), x_ref, feet0, feet0, gait, x_des, N,
        dt)
    pm = controller._linearized_problem(prob, x_des[None], x_ref, contacts,
                                        foot_locs, dt)
    rng = np.random.default_rng(12)
    U = torch.zeros((1, N - 1, m), dtype=f64)
    U[:, :, 2::3] = controller.SPRUNG_MASS * 9.81 / 4.0
    U = U + torch.as_tensor(10.0 * rng.standard_normal((1, N - 1, m)))
    X = pm.dynamics.rollout(pm.x0, U) + torch.as_tensor(
        0.05 * rng.standard_normal((1, N, n)))
    rho = torch.full((1, N), 100.0, dtype=f64)
    lams = tuple(
        rho[..., None] * (c.evaluate(X, U).abs() + 1.0)
        * torch.as_tensor(rng.standard_normal((1, N, c.p)))
        for c in pm.constraints)
    pm, X, U, lams, rho = tree_to((pm, X, U, lams, rho), dev, dtype)
    blocks, dyn = pm.constraints, pm.dynamics
    rhos = (rho,) * len(blocks)
    reg = torch.zeros(1, dtype=dtype, device=dev)
    packed = pack_blocks(blocks, N, n, m, X)
    fused = (pm.cost, dyn.A, dyn.B, blocks, X, U, lams, rhos, reg)
    ref = riccati_fused.fused_expand_backward_reference(*fused)
    K, d = ref[0].contiguous(), ref[1].contiguous()
    soc_p = tuple(c.p for c in blocks if c.cone.name == "SOC")
    item = X.element_size()
    return dict(
        prob=pm, fused=fused, fused_ref=ref, packed=packed,
        ladder_al=(pm.cost, dyn.A, dyn.B, dyn.d, blocks, X, U, K, d, lams,
                   rho, QUAD_LADDER),
        init=(dyn.A, dyn.B, dyn.d, X, U, torch.zeros_like(K),
              torch.zeros_like(d), (1.0,)),
        fused_work=fused_work(1, N, n, m, packed.P, soc_p, item),
        ladder_al_work=rollout_al_work(1, N, n, m, packed.P,
                                       len(QUAD_LADDER), item),
        init_work=rollout_work(1, N, n, m, 1, False, item))


@functools.lru_cache(maxsize=1)
def _naive_rocket_iterate():
    """(problem, X, U, lams, rhos, reg) of one lane of the naive rocket's
    cold solve (``bench/conic.py: naive_rocket_setup`` at one lane) after
    NAIVE_IT iterations (the port's plain version, float64 on the CPU)."""
    import torch
    from altro_tpu_torch.bench.conic import naive_rocket_setup
    from altro_tpu_torch.solver import altro

    su = naive_rocket_setup(1, torch.float64, "cpu")
    prob = su.prob
    X, U, _, duals, reg = altro.solve_partial(prob, su.opts, U0=su.U0,
                                              it_cap=NAIVE_IT)[:5]
    return (prob, X[0], U[0], tuple(d.lam[0] for d in duals),
            tuple(d.rho[0] for d in duals), reg[0])


def naive_rocket_inputs(dtype, dev, B: int = 1024) -> dict:
    """Kernel D's and kernel A's arguments on the naive rocket (N=301, n=6,
    m=3; the goal ZERO block and the max-thrust, thrust-angle and
    glideslope quadratic norm blocks): lane 0 is the cold solve's iterate
    after NAIVE_IT iterations (:func:`_naive_rocket_iterate`), the other
    lanes (seed 15) that iterate with states 5 cm and controls 0.5 N off it
    and multipliers scaled by 1 + 0.1 N(0, 1). D: the shared dynamics and
    the solver's AL expansion there (per-lane Jacobians and the blocks'
    exact, indefinite curvature: per-lane Hessians), the iterate's
    regularization; A: the solver's L=11 ladder on the plain version's
    gains."""
    import torch
    from altro_tpu_torch.convert import tree_to
    from altro_tpu_torch.ops import riccati

    prob, X1, U1, lams1, rhos1, reg1 = _naive_rocket_iterate()
    rng = np.random.default_rng(15)
    N, n, m = prob.N, prob.n, prob.m
    X = X1[None] + torch.as_tensor(0.05 * rng.standard_normal((B, N, n)))
    U = U1[None] + torch.as_tensor(0.5 * rng.standard_normal((B, N - 1,
                                                               m)))
    lams = tuple(lam[None] * (1.0 + torch.as_tensor(
        0.1 * rng.standard_normal((B,) + tuple(lam.shape)))) for lam in lams1)
    X[0], U[0] = X1, U1
    for lam, lam1 in zip(lams, lams1):
        lam[0] = lam1
    rhos = tuple(rho[None].expand(B, -1).contiguous() for rho in rhos1)
    reg = reg1.expand(B).contiguous()
    prob, X, U, lams, rhos, reg = tree_to((prob, X, U, lams, rhos, reg),
                                          dev, dtype)
    split = _split_args(prob, X, U, lams, rhos, reg)
    ref = riccati.batched_riccati_reference(*split["riccati"])
    dyn = prob.dynamics
    return dict(
        prob=prob, riccati_ref=ref, lams=lams, rhos=rhos, **split,
        ladder=(dyn.A, dyn.B, dyn.d, X, U, ref[0].contiguous(),
                ref[1].contiguous(), QUAD_LADDER),
        ladder_work=rollout_work(B, N, n, m, len(QUAD_LADDER), False,
                                 X.element_size()))


def wide_cases(dtype, dev) -> list:
    """(kernel, shape, call, work) of the wide bodies: A at the drivers'
    L=11 ladder and its init form (L=1), B, C (L=11) and D at every
    WIDE_SHAPES point, at one lane and at WIDE_BATCH lanes."""
    from altro_tpu_torch.ops import riccati, riccati_fused, rollout, rollout_al

    cases = []
    for B in (1, WIDE_BATCH):
        for n, m in WIDE_SHAPES:
            w = wide_inputs(dtype, dev, B, n, m)
            tag = f"wide n={n} m={m} B={B}"
            cases += [
                ("A", f"{tag} L=11",
                 (lambda w=w: rollout.batched_ls_rollout(*w["ladder"])),
                 w["ladder_work"]),
                ("A", f"{tag} L=1",
                 (lambda w=w: rollout.batched_ls_rollout(*w["init"])),
                 w["init_work"]),
                ("B", tag,
                 (lambda w=w: riccati_fused.fused_expand_backward(
                     *w["fused"], packed=w["packed"])), w["fused_work"]),
                ("C", f"{tag} L=11",
                 (lambda w=w: rollout_al.batched_ls_rollout_al(
                     *w["ladder_al"], packed=w["packed"])),
                 w["ladder_al_work"]),
                ("D", tag,
                 (lambda w=w: riccati.batched_riccati(*w["riccati"])),
                 w["riccati_work"])]
    return cases


def _all_cases(dtype, dev) -> list:
    """(kernel, shape, call, work) at every shape of the main paths, then
    ``wide_cases`` and the naive rocket's."""
    from altro_tpu_torch.ops import riccati, riccati_fused, rollout, rollout_al

    fb, ls = riccati_fused.fused_expand_backward, rollout.batched_ls_rollout
    la, bp = rollout_al.batched_ls_rollout_al, riccati.batched_riccati
    fl = flagship_inputs(dtype, dev)
    rk = rocket_inputs(dtype, dev)
    gw = grasp_inputs(dtype, dev)
    gc = grasp_inputs(dtype, dev, cold=True)
    fx = flexsat_inputs(dtype, dev)
    qd = quadruped_inputs(dtype, dev)
    sn = quadruped_inputs(dtype, dev, nonlinear=True)
    lq = quadloop_inputs(dtype, dev, True)
    ls_ = quadloop_inputs(dtype, dev, False)
    other = [(w, flagship_inputs(dtype, dev, widths=w))
             for w in OTHER_WIDTHS]

    def fused(inp):
        return lambda: fb(*inp["fused"], packed=inp["packed"])

    def pass_d(inp):
        return lambda: bp(*inp["riccati"])
    cases = [
        ("B", "flagship", fused(fl), fl["fused_work"]),
        ("B", "rocket", fused(rk), rk["fused_work"]),
        ("B", "grasp window", fused(gw), gw["fused_work"]),
        ("B", "grasp cold", fused(gc), gc["fused_work"]),
        ("B", "flexsat", fused(fx), fx["fused_work"]),
        ("B", "closed loop qp B=1", fused(lq), lq["fused_work"]),
        ("B", "closed loop socp B=1", fused(ls_), ls_["fused_work"]),
        *(("B", f"random-linear n={n} m={m}", fused(inp),
           inp["fused_work"]) for (n, m), inp in other),
        ("A", "flagship L=3", lambda: ls(*fl["ladder"]), fl["ladder_work"]),
        ("A", "init L=1", lambda: ls(*fl["init"]), fl["init_work"]),
        ("A", "quadruped L=11 per-lane", lambda: ls(*qd["ladder"]),
         qd["ladder_work"]),
        ("A", "closed loop init L=1 B=1", lambda: ls(*lq["init"]),
         lq["init_work"]),
        ("C", "rocket L=6",
         lambda: la(*rk["ladder_al"], packed=rk["packed"]),
         rk["ladder_al_work"]),
        ("C", "grasp L=3",
         lambda: la(*gw["ladder_al"], packed=gw["packed"]),
         gw["ladder_al_work"]),
        ("C", "flexsat L=6",
         lambda: la(*fx["ladder_al"], packed=fx["packed"]),
         fx["ladder_al_work"]),
        *(("C", f"closed loop {mode} L=11 B=1",
           (lambda q=q: la(*q["ladder_al"], packed=q["packed"])),
           q["ladder_al_work"]) for mode, q in (("qp", lq), ("socp", ls_))),
        ("D", "quadruped per-lane", pass_d(qd), qd["riccati_work"]),
        ("D", "nonlinear SRB per-lane", pass_d(sn), sn["riccati_work"]),
        ("D", "flagship shared", pass_d(fl), fl["riccati_work"]),
        *(("D", f"random-linear shared n={n} m={m}", pass_d(inp),
           inp["riccati_work"]) for (n, m), inp in other)]
    cases += wide_cases(dtype, dev)
    for B in NAIVE_BATCHES:
        nr = naive_rocket_inputs(dtype, dev, B)
        cases += [("D", f"naive rocket N=301 B={B}", pass_d(nr),
                   nr["riccati_work"]),
                  ("A", f"naive rocket N=301 L=11 B={B}",
                   (lambda nr=nr: ls(*nr["ladder"])), nr["ladder_work"])]
    return cases


def measure(wide_only: bool = False) -> list:
    """Time kernels A, B, C and D at every shape (``wide_only``: the wide
    bodies' shapes, ``wide_cases``), f32 and f64, in the checkout whose
    ``altro_tpu_torch`` is imported."""
    import torch
    from altro_tpu_torch.ops import _build

    _build.library()
    dev = torch.device("cuda")
    rows = []
    for dtype in (torch.float32, torch.float64):
        label = "f32" if dtype == torch.float32 else "f64"
        item = torch.empty((), dtype=dtype).element_size()
        cases = (wide_cases if wide_only else _all_cases)(dtype, dev)
        for kernel, shape, fn, (nbytes, flops) in cases:
            bnd, by = bound_ms(nbytes, flops, item)
            rows.append(dict(kernel=kernel, shape=shape, dtype=label,
                             ms=time_ms(fn, kernel=True), bound_ms=bnd,
                             bound_by=by, bytes=nbytes, flops=flops))
        del cases
        torch.cuda.empty_cache()
    return rows


def _worker(root: str, out: str, wide_only: bool) -> None:
    # the checkout's root in place of this script's directory
    sys.path[0] = os.path.abspath(root)
    from altro_tpu_torch.ops import _build
    rows = measure(wide_only)
    ptxas = [line.split("ptxas info    :")[-1].strip()
             for line in _build.build_log().splitlines()
             if "Used" in line or "spill" in line or "Compiling entry" in line]
    with open(out, "w") as f:
        json.dump({"root": os.path.abspath(root), "rows": rows,
                   "ptxas": ptxas}, f)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="root of another checkout to time in "
                    "turns with this one")
    ap.add_argument("--wide", action="store_true",
                    help="time the wide bodies' rows alone")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        _worker(args.worker, args.out, args.wide)
        return
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("the kernel benchmark measures a CUDA device; none "
                         "is available")
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, here)
    from altro_tpu_torch.bench.flagship import power_limit
    turns = ([args.against, here, here, args.against] if args.against
             else [here])
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, root in enumerate(turns):
            out = os.path.join(tmp, f"turn{i}.json")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--worker", root, "--out", out]
                           + (["--wide"] if args.wide else []), check=True)
            with open(out) as f:
                results.append(json.load(f))
    card = power_limit()
    for r in results:
        if r is results[0] or r["root"] != results[0]["root"]:
            for line in r["ptxas"]:
                print(f"ptxas [{r['root']}]: {line}")
    def key(row):
        return row["kernel"], row["shape"], row["dtype"]
    by_key = [{key(row): row for row in r["rows"]} for r in results]
    mine = next(r for r in results if r["root"] == here)
    for row in mine["rows"]:
        # a shape that one checkout does not time (added later) is n/a
        times = " ".join(
            f"{'this' if r['root'] == here else 'other'}="
            + (f"{rows[key(row)]['ms']:.4f}" if key(row) in rows else "n/a")
            for r, rows in zip(results, by_key))
        print(f"{row['kernel']} {row['shape']} {row['dtype']}: ms {times}; "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
              f"{row['bytes'] / 1e6:.2f} MB, {row['flops'] / 1e9:.4f} "
              f"GFLOP) [{card}]")
    print(json.dumps({"card": card, "turns": results}))


if __name__ == "__main__":
    main()
