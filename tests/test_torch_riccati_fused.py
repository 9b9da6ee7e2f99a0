"""Fused AL expansion + Riccati backward pass: the port's plain
``fused_expand_backward_reference`` against the JAX package in float64

- its Pallas kernel in interpret mode at n=5, m=3, N=7, B=4 (atol 1e-10),
- its composed plain path ``jax.vmap(_expand_backward_base)`` at the
  flagship's widths n=12, m=6 on N=11 with NONPOS multipliers |lambda| and a
  nonzero per-lane regularization (atol 1e-9), and with a second, ZERO block;
- its Pallas kernel in interpret mode on the rocket MPC window's three SOC
  blocks at N=13, B=4, and on grasp's ZERO + NONPOS + two SOC blocks at
  n = m = 6 in the cold problem's form (a goal block in front) at N=7, B=3
  (1e-10 of each output's scale);

the wrapper's CPU dispatch; and, on a CUDA device, the kernel against the
plain version, on ZERO/NONPOS blocks, on the rocket's SOC blocks, on
grasp's mix and on the flexsat regulator's single NONPOS block at N=80.

JAX is imported only by the tests that compare with it, so the kernel tests
also run where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_riccati_fused.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import altro_tpu_torch as tt  # noqa: E402
from altro_tpu_torch import convert  # noqa: E402
from altro_tpu_torch.models import random_linear as trl  # noqa: E402
from altro_tpu_torch.ops import riccati_fused  # noqa: E402

torch.set_num_threads(1)


def _lane_data(rng, N, n, m, ps, Bt, reg_scale, u_scale):
    return (rng.standard_normal((Bt, N, n)),
            u_scale * rng.standard_normal((Bt, N - 1, m)),
            tuple(np.abs(rng.standard_normal((Bt, N, p))) for p in ps),
            tuple(np.full((Bt, N), 10.0) for _ in ps),
            reg_scale * rng.random(Bt))


def _case(n, m, N, Bt, seed, goal=False, reg_scale=0.0, u_scale=1.0,
          with_jax=False):
    """A random-linear tracking window (plus a terminal ZERO goal block if
    ``goal``) and per-lane X, U, |lambda|, rho, reg: the port's arguments
    and, if ``with_jax``, the same arrays as the JAX package's arguments
    (one seed builds the same problem in both packages)."""
    def window(rl, pkg, rng):
        prob = rl.gen_random_linear(rng, n, m, N + 2)
        X_track, U_track = rl.gen_trajectory(rng, prob, N + 2)
        pm = rl.gen_tracking_mpc(prob, X_track, U_track, N)
        xf = rng.standard_normal(n)
        if goal:
            gc = pkg.goal_constraint(N, n, m, xf, dtype=X_track.dtype)
            pm = pkg.Problem(dynamics=pm.dynamics, cost=pm.cost,
                             constraints=pm.constraints + (gc,), x0=pm.x0)
        return pm

    tp = window(trl, tt, np.random.default_rng(seed))
    lane = _lane_data(np.random.default_rng(seed + 100), N, n, m,
                      [c.p for c in tp.constraints], Bt, reg_scale, u_scale)
    X, U, lams, rhos, reg = lane
    t = torch.as_tensor
    targs = (tp.cost, tp.dynamics.A, tp.dynamics.B, tp.constraints, t(X),
             t(U), tuple(map(t, lams)), tuple(map(t, rhos)), t(reg))
    if not with_jax:
        return targs
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import altro_tpu as at
    from altro_tpu.models import random_linear as jrl
    jp = window(jrl, at, np.random.default_rng(seed))
    a = jnp.asarray
    jargs = (jp.cost, jp.dynamics.A, jp.dynamics.B, jp.constraints, a(X),
             a(U), tuple(map(a, lams)), tuple(map(a, rhos)), a(reg))
    return targs, jargs


def _assert_close(got, want, atol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=atol,
                                   rtol=0)


@pytest.fixture(scope="module")
def interpret_case():
    """One interpret-mode run of the JAX Pallas kernel (slow on the CPU)."""
    targs, jargs = _case(5, 3, 7, 4, seed=0, reg_scale=0.5, with_jax=True)
    from altro_tpu.ops.riccati_fused import fused_expand_backward
    return targs, fused_expand_backward(*jargs, interpret=True)


def test_reference_matches_jax_pallas_interpret(interpret_case):
    targs, want = interpret_case
    _assert_close(riccati_fused.fused_expand_backward_reference(*targs), want,
                  atol=1e-10)


def test_wrapper_takes_plain_version_on_cpu(interpret_case):
    targs, want = interpret_case
    before = riccati_fused.launch_count
    got = riccati_fused.fused_expand_backward(*targs)
    assert riccati_fused.launch_count == before
    _assert_close(got, want, atol=1e-10)
    with pytest.raises(ValueError):
        riccati_fused.fused_expand_backward(*targs[:4], targs[4][:, :-1],
                                            *targs[5:])


@pytest.mark.parametrize("goal", [False, True], ids=["nonpos", "nonpos+zero"])
def test_reference_matches_jax_base_flagship_widths(goal):
    targs, jargs = _case(12, 6, 11, 3, seed=1, goal=goal, reg_scale=1e-2,
                         u_scale=3.0, with_jax=True)
    import jax

    from altro_tpu.solver.altro import _expand_backward_base
    want = jax.vmap(_expand_backward_base,
                    in_axes=(None, None, None, None, 0, 0, 0, 0, 0))(*jargs)
    _assert_close(riccati_fused.fused_expand_backward_reference(*targs), want,
                  atol=1e-9)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to run the hand-written kernel")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.float64, 1e-9)])
@pytest.mark.parametrize("widths,goal", [((5, 3, 7, 5), False),
                                         ((12, 6, 11, 9), False),
                                         ((12, 6, 11, 9), True),
                                         ((20, 9, 6, 3), False),
                                         ((12, 6, 30, 1023), False),
                                         ((7, 1, 6, 5), False),
                                         ((9, 2, 6, 5), False),
                                         ((8, 4, 6, 5), False),
                                         ((10, 5, 6, 5), False),
                                         ((13, 7, 6, 5), False),
                                         ((11, 8, 6, 5), False)])
def test_kernel_matches_plain_version(cuda, widths, goal, dtype, tol):
    """Relative tolerance: float32 rounding through the recursion (the dV
    terms reach 1e3-1e4); float64 only summation order. m = 9 takes the
    kernel's shared-memory Cholesky and its generic instantiation, every
    m <= 8 the shuffle Cholesky and an instantiation of its own with m
    constant; Bt = 1023 leaves the last block's second group without a
    scenario."""
    targs = convert.tree_to(_case(*widths, seed=2, goal=goal, reg_scale=1e-2,
                                  u_scale=3.0), cuda, dtype)
    before = riccati_fused.launch_count
    got = riccati_fused.fused_expand_backward(*targs)
    torch.cuda.synchronize()
    assert riccati_fused.launch_count == before + 1
    for g, r in zip(got, riccati_fused.fused_expand_backward_reference(*targs)):
        assert float((g - r).abs().max()) <= tol * max(1.0,
                                                      float(r.abs().max()))


def _rocket_case(N, Bt, seed, jax_too=False):
    """The rocket MPC window (three SOC blocks, tracking the hover rollout)
    and per-lane inputs that put the cone residuals in all three cases,
    with one lane-knot at the glideslope cone's apex (v = 0): the
    port's arguments and, if ``jax_too``, the JAX package's."""
    from altro_tpu_torch.models import rocket
    from altro_tpu_torch.mpc import gen_tracking_mpc

    tp = rocket.rocket_problem(N=N + 2, tf=(N + 1) * 0.05)
    U_tr = rocket.hover_controls(tp)
    X_tr = tp.dynamics.rollout(tp.x0, U_tr)
    pm = gen_tracking_mpc(tp, X_tr, U_tr, N, dt=0.05)
    rng = np.random.default_rng(seed)
    n, m = pm.n, pm.m
    X = X_tr[None, :N].numpy() + rng.standard_normal((Bt, N, n))
    U = U_tr[None, :N - 1].numpy() + 60.0 * rng.standard_normal((Bt, N - 1,
                                                                 m))
    lams = [300.0 * rng.standard_normal((Bt, N, c.p))
            for c in pm.constraints]
    # glideslope apex at lane 0, knot N-3: x = y = 0 and lambda_v = 0
    X[0, N - 3, :2] = 0.0
    lams[2][0, N - 3, :-1] = 0.0
    rhos = [np.full((Bt, N), 10.0) for _ in pm.constraints]
    reg = np.full(Bt, 1.0)
    t = torch.as_tensor
    targs = (pm.cost, pm.dynamics.A, pm.dynamics.B, pm.constraints, t(X),
             t(U), tuple(map(t, lams)), tuple(map(t, rhos)), t(reg))
    if not jax_too:
        return targs
    import jax.numpy as jnp

    from altro_tpu.constraints import ConicConstraint
    from altro_tpu.costs import QuadCost
    from altro_tpu.cones import Cone
    a = jnp.asarray
    jcost = QuadCost(**{k: a(v.numpy()) for k, v in vars(pm.cost).items()})
    jblocks = tuple(ConicConstraint(Cx=a(c.Cx.numpy()), Cu=a(c.Cu.numpy()),
                                    b=a(c.b.numpy()), mask=a(c.mask.numpy()),
                                    cone=Cone(c.cone.value), name=c.name)
                    for c in pm.constraints)
    jargs = (jcost, a(pm.dynamics.A.numpy()), a(pm.dynamics.B.numpy()),
             jblocks, a(X), a(U), tuple(map(a, lams)), tuple(map(a, rhos)),
             a(reg))
    return targs, jargs


def soc_case_counts(blocks, X, U, lams, rhos):
    """(inside, polar, boundary) counts of the masked SOC residuals z."""
    counts = np.zeros(3, int)
    for c, lam, rho in zip(blocks, lams, rhos):
        z = lam + rho[..., None] * c.evaluate(X, U)
        a = torch.linalg.vector_norm(z[..., :-1], dim=-1)
        s = z[..., -1]
        act = c.mask > 0
        inside, polar = (a <= s) & act, (a <= -s) & act
        counts += [int(inside.sum()), int(polar.sum()),
                   int((act & ~((a <= s) | (a <= -s))).sum())]
    return counts


def test_soc_reference_matches_jax_pallas_interpret():
    """The rocket window's SOC blocks: the port's plain version (dense SOC
    curvature) against the Pallas kernel (diagonal + two rank-1 terms) in
    interpret mode. Tolerance 1e-10 of each output's largest entry: the two
    forms differ only in summation order, and the inputs put entries of
    K, d and dV far above 1."""
    from altro_tpu.ops.riccati_fused import fused_expand_backward as j_fused

    targs, jargs = _rocket_case(13, 4, seed=5, jax_too=True)
    assert min(soc_case_counts(*(targs[i] for i in (3, 4, 5, 6, 7)))) > 0
    want = j_fused(*jargs, interpret=True)
    got = riccati_fused.fused_expand_backward_reference(*targs)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-10 * max(1.0, np.abs(w).max()))


def _jax_fused_args(targs):
    """The JAX package's arguments of kernel B from the port's."""
    import jax.numpy as jnp

    from altro_tpu.constraints import ConicConstraint
    from altro_tpu.costs import QuadCost
    from altro_tpu.cones import Cone
    cost, A, B, blocks, X, U, lams, rhos, reg = targs
    a = lambda v: jnp.asarray(v.numpy())            # noqa: E731
    jcost = QuadCost(**{k: a(v) for k, v in vars(cost).items()})
    jblocks = tuple(ConicConstraint(Cx=a(c.Cx), Cu=a(c.Cu), b=a(c.b),
                                    mask=a(c.mask), cone=Cone(c.cone.value),
                                    name=c.name) for c in blocks)
    return (jcost, a(A), a(B), jblocks, a(X), a(U), tuple(map(a, lams)),
            tuple(map(a, rhos)), a(reg))


def test_grasp_reference_matches_jax_pallas_interpret():
    """Grasp's mix at n = m = 6 in the cold problem's form: a goal ZERO
    block, torque balance ZERO, max force NONPOS and two SOC friction cones
    (19 rows in 5 blocks; the MPC window's are the last four), at N=7, B=3
    with every cone case and an apex lane-knot whose s is not 0: the port's
    plain version against the Pallas kernel in interpret mode, 1e-10 of
    each output's largest entry. (One interpret run of this kernel takes
    ~90 s on the CPU, whatever N.)"""
    from altro_tpu.ops.riccati_fused import fused_expand_backward as j_fused
    from altro_tpu_torch.bench.kernels import grasp_inputs

    g = grasp_inputs(torch.float64, torch.device("cpu"), B=3, cold=True, N=7)
    targs = g["fused"]
    assert g["packed"].P == 19
    assert min(soc_case_counts(*(targs[i] for i in (3, 4, 5, 6, 7)))) > 0
    want = j_fused(*_jax_fused_args(targs), interpret=True)
    for got, w in zip(riccati_fused.fused_expand_backward_reference(*targs),
                      want):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                   atol=1e-10 * max(1.0, np.abs(w).max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.float64, 1e-9)])
@pytest.mark.parametrize("cold,Bt", [(False, 1024), (False, 131),
                                     (True, 1024)],
                         ids=["window", "window-131", "cold"])
def test_kernel_matches_plain_version_grasp(cuda, cold, Bt, dtype, tol):
    """Grasp's window (N=21, 13 rows in 4 blocks) and cold form (N=61, 19
    rows in 5 blocks) at the bench's batch and at an odd one."""
    from altro_tpu_torch.bench.kernels import grasp_inputs

    g = grasp_inputs(dtype, cuda, B=Bt, cold=cold)
    before = riccati_fused.launch_count
    got = riccati_fused.fused_expand_backward(*g["fused"], packed=g["packed"])
    torch.cuda.synchronize()
    assert riccati_fused.launch_count == before + 1
    for o, r in zip(got, g["fused_ref"]):
        assert torch.isfinite(o).all()
        assert float((o - r).abs().max()) <= tol * max(1.0,
                                                      float(r.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.float64, 1e-9)])
@pytest.mark.parametrize("Bt", [1024, 131])
def test_kernel_matches_plain_version_flexsat(cuda, Bt, dtype, tol):
    """The flexsat regulator (n=12, m=3, N=80, one NONPOS block of 6
    control-bound rows, both signs of lam + rho c) at the bench's batch and
    at an odd one."""
    from altro_tpu_torch.bench.kernels import flexsat_inputs

    f = flexsat_inputs(dtype, cuda, B=Bt)
    before = riccati_fused.launch_count
    got = riccati_fused.fused_expand_backward(*f["fused"], packed=f["packed"])
    torch.cuda.synchronize()
    assert riccati_fused.launch_count == before + 1
    for o, r in zip(got, f["fused_ref"]):
        assert torch.isfinite(o).all()
        assert float((o - r).abs().max()) <= tol * max(1.0,
                                                      float(r.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.float64, 1e-9)])
def test_kernel_matches_plain_version_soc(cuda, dtype, tol):
    """The rocket window's three SOC blocks (all three cone cases and an
    apex lane-knot), with and without a ZERO block in front."""
    targs = convert.tree_to(_rocket_case(21, 67, seed=6), cuda, dtype)
    goal = tt.goal_constraint(21, 6, 3, torch.zeros(6), dtype=dtype,
                              device=cuda)
    lam_goal = torch.ones((67, 21, 6), dtype=dtype, device=cuda)
    with_goal = (*targs[:3], (goal,) + targs[3], *targs[4:6],
                 (lam_goal,) + targs[6], (targs[7][0],) + targs[7],
                 targs[8])
    for args in (targs, with_goal):
        before = riccati_fused.launch_count
        got = riccati_fused.fused_expand_backward(*args)
        torch.cuda.synchronize()
        assert riccati_fused.launch_count == before + 1
        for g, r in zip(got,
                        riccati_fused.fused_expand_backward_reference(*args)):
            assert torch.isfinite(g).all()
            assert float((g - r).abs().max()) <= tol * max(
                1.0, float(r.abs().max()))


def _limits_case(n, m, N, Bt, seed, p=4, nblocks=16):
    """A random problem at the kernel's limits: n x m widths, nblocks blocks
    of p rows (ZERO, NONPOS and SOC in turn; 64 rows at the defaults), each
    active on a random 80% of the knots, with multipliers that put the SOC
    residuals in all three cases. SPD cost Hessians with R >= 10 I keep
    Quu + reg I positive definite for the plain version's Cholesky."""
    from altro_tpu_torch.cones import Cone
    from altro_tpu_torch.constraints import ConicConstraint
    from altro_tpu_torch.costs import QuadCost

    rng = np.random.default_rng(seed)
    t = torch.as_tensor
    Gq = rng.standard_normal((N, n, n)) / np.sqrt(n)
    Gr = rng.standard_normal((N, m, m)) / np.sqrt(m)
    cost = QuadCost(Q=t(Gq @ Gq.transpose(0, 2, 1) + np.eye(n)),
                    q=t(rng.standard_normal((N, n))),
                    R=t(Gr @ Gr.transpose(0, 2, 1) + 10.0 * np.eye(m)),
                    r=t(rng.standard_normal((N, m))),
                    H=t(0.1 * rng.standard_normal((N, m, n))),
                    c=t(np.zeros(N)))
    A = t(0.9 * np.eye(n) + 0.1 * rng.standard_normal((N - 1, n, n))
          / np.sqrt(n))
    B = t(rng.standard_normal((N - 1, n, m)) / np.sqrt(n))
    cones = (Cone.ZERO, Cone.NONPOS, Cone.SOC)
    blocks = tuple(ConicConstraint(
        Cx=t(rng.standard_normal((N, p, n)) / np.sqrt(n)),
        Cu=t(rng.standard_normal((N, p, m)) / np.sqrt(m)),
        b=t(rng.standard_normal((N, p))),
        mask=t((rng.random(N) < 0.8).astype(float)), cone=cones[i % 3])
        for i in range(nblocks))
    X = t(rng.standard_normal((Bt, N, n)))
    U = t(rng.standard_normal((Bt, N - 1, m)))
    lams = tuple(t(3.0 * rng.standard_normal((Bt, N, p)))
                 for _ in blocks)
    rhos = tuple(t(np.full((Bt, N), 10.0)) for _ in blocks)
    reg = t(1e-2 * rng.random(Bt))
    return cost, A, B, blocks, X, U, lams, rhos, reg


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.float64, 1e-9)])
@pytest.mark.parametrize("widths", [(32, 32, 6, 5), (32, 6, 6, 5),
                                    (12, 6, 7, 9)],
                         ids=["n=m=32", "n=32", "flagship-widths"])
def test_kernel_at_width_limits(cuda, widths, dtype, tol):
    """64 constraint rows in 16 blocks that mix ZERO, NONPOS and SOC; at
    n = m = 32 also the widest state and control (the shared-memory
    Cholesky), at n = 32, m = 6 the shuffle Cholesky with 33 solving
    threads, past the first warp."""
    targs = convert.tree_to(_limits_case(*widths, seed=11), cuda, dtype)
    assert min(soc_case_counts(*(targs[i] for i in (3, 4, 5, 6, 7)))) > 0
    got = riccati_fused.fused_expand_backward(*targs)
    ref = riccati_fused.fused_expand_backward_reference(*targs)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.isfinite(r).all()
        assert float((g - r).abs().max()) <= tol * max(1.0,
                                                      float(r.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.float64, 1e-9)])
def test_kernel_nan_lane_stays_in_its_lane(cuda, dtype, tol):
    """A NaN state of one lane makes that lane's outputs NaN; every other
    lane, including the lanes that share its block, matches the plain
    version."""
    cost, A, B, blocks, X, U, lams, rhos, reg = _limits_case(12, 6, 7, 9,
                                                             seed=12)
    X[4, 3, 0] = float("nan")
    targs = convert.tree_to((cost, A, B, blocks, X, U, lams, rhos, reg),
                            cuda, dtype)
    got = riccati_fused.fused_expand_backward(*targs)
    ref = riccati_fused.fused_expand_backward_reference(*targs)
    torch.cuda.synchronize()
    keep = torch.arange(9, device=cuda) != 4
    assert bool(torch.isnan(got[2][4]) | torch.isnan(got[3][4]))
    for g, r in zip(got, ref):
        assert torch.isfinite(g[keep]).all()
        assert float((g[keep] - r[keep]).abs().max()) <= tol * max(
            1.0, float(r[keep].abs().max()))
