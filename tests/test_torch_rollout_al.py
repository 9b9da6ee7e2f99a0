"""Fused ladder rollout + AL merit: the port's plain
``batched_ls_rollout_al_reference`` against the JAX package's Pallas kernel
in interpret mode on the rocket MPC window (three SOC blocks), on a
ZERO + NONPOS pair, on the grasp window (ZERO, NONPOS and two SOC blocks at
n = m = 6) and on the flexsat regulator's single NONPOS block (n=12, m=3)
in float64 (Xs/Us rtol 1e-9, J rtol 1e-8); the
wrapper's CPU dispatch; the byte and FLOP counts that the kernel's bound is
computed from; and, on a CUDA device, the kernel against the plain version
in float32 and float64 (the rocket and grasp windows, flexsat at its
bench shapes N=80, n=12, m=3, p=6, L=6, B=1024, and random problems at the
edges of its thread mapping), and the wrapper's limits.

JAX is imported only by the tests that compare with it, so the kernel tests
also run where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_rollout_al.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import altro_tpu_torch as tt  # noqa: E402
from altro_tpu_torch import convert  # noqa: E402
from altro_tpu_torch.ops import rollout_al  # noqa: E402

torch.set_num_threads(1)
LADDER = (1.0, 0.5, 0.25, 0.125, 0.0625, 0.0)


def _window(kind, N):
    """The rocket MPC window tracking the hover rollout ('rocket': three SOC
    blocks) or the same window with a terminal ZERO goal and a NONPOS
    thrust bound instead ('zero_nonpos')."""
    from altro_tpu_torch.models import rocket
    from altro_tpu_torch.mpc import gen_tracking_mpc

    tp = rocket.rocket_problem(N=N + 2, tf=(N + 1) * 0.05)
    U_tr = rocket.hover_controls(tp)
    X_tr = tp.dynamics.rollout(tp.x0, U_tr)
    pm = gen_tracking_mpc(tp, X_tr, U_tr, N, dt=0.05)
    if kind == "zero_nonpos":
        blocks = (tt.goal_constraint(N, 6, 3, torch.ones(6),
                                     dtype=torch.float64),
                  tt.bound_constraint(N, 6, 3, u_min=-50.0, u_max=150.0,
                                      dtype=torch.float64))
        pm = tt.Problem(dynamics=pm.dynamics, cost=pm.cost,
                        constraints=blocks, x0=pm.x0)
    return pm, X_tr[:N], U_tr[:N - 1]


def _case(kind, N, Bt, seed):
    """Port arguments (without the ladder) for per-lane inputs around the
    window's track: rho varies over lanes and knots; lane 0 sits at the
    thrust-angle cone's apex (v = 0) at knot 0 for the rocket blocks.
    'grasp': the grasp window's ZERO, NONPOS and two SOC blocks at
    n = m = 6 with the kernel benchmark's inputs (an apex lane-knot with
    s = 500), rho varied the same way; 'flexsat': the flexsat regulator's
    one NONPOS block (n=12, m=3) with the kernel benchmark's inputs, rho
    varied the same way."""
    if kind in ("grasp", "flexsat"):
        from altro_tpu_torch.bench.kernels import (flexsat_inputs,
                                                   grasp_inputs)

        inputs = grasp_inputs if kind == "grasp" else flexsat_inputs
        g = inputs(torch.float64, torch.device("cpu"), B=Bt, N=N)
        rho = 10.0 ** np.random.default_rng(seed).uniform(0, 3, (Bt, N))
        return g["ladder_al"][:10] + (torch.as_tensor(rho),)
    pm, X_tr, U_tr = _window(kind, N)
    rng = np.random.default_rng(seed)
    n, m = pm.n, pm.m
    X = X_tr[None].numpy() + rng.standard_normal((Bt, N, n))
    U = U_tr[None].numpy() + 60.0 * rng.standard_normal((Bt, N - 1, m))
    K = 0.1 * rng.standard_normal((Bt, N - 1, m, n))
    d = 5.0 * rng.standard_normal((Bt, N - 1, m))
    lams = [300.0 * rng.standard_normal((Bt, N, c.p))
            for c in pm.constraints]
    if kind == "rocket":
        # knot 0 rolls out to x = xbar, u = ubar + alpha d for every rung
        U[0, 0, :2] = d[0, 0, :2] = 0.0
        lams[1][0, 0, :-1] = 0.0
    rho = 10.0 ** rng.uniform(0, 3, (Bt, N))
    t = torch.as_tensor
    dyn = pm.dynamics
    return (pm.cost, dyn.A, dyn.B, dyn.d, pm.constraints, t(X), t(U), t(K),
            t(d), tuple(map(t, lams)), t(rho))


def _to_jax(args):
    import jax.numpy as jnp

    from altro_tpu.cones import Cone
    from altro_tpu.constraints import ConicConstraint
    from altro_tpu.costs import QuadCost
    a = lambda v: jnp.asarray(v.numpy())            # noqa: E731
    cost, A, B, dd, blocks, X, U, K, d, lams, rho = args
    jcost = QuadCost(**{k: a(v) for k, v in vars(cost).items()})
    jblocks = tuple(ConicConstraint(Cx=a(c.Cx), Cu=a(c.Cu), b=a(c.b),
                                    mask=a(c.mask), cone=Cone(c.cone.value),
                                    name=c.name) for c in blocks)
    return (jcost, a(A), a(B), a(dd), jblocks, a(X), a(U), a(K), a(d),
            tuple(map(a, lams)), a(rho))


@pytest.fixture(scope="module")
def interpret_cases():
    """One interpret-mode run of the JAX Pallas kernel per block set (slow
    on the CPU): {kind: (port args, JAX outputs)}."""
    pytest.importorskip("jax")
    from altro_tpu.ops.rollout import batched_ls_rollout_al as j_al

    out = {}
    for kind, N in (("rocket", 13), ("zero_nonpos", 7), ("grasp", 7),
                    ("flexsat", 7)):
        args = _case(kind, N, 4, seed=1)
        out[kind] = (args, j_al(*_to_jax(args), LADDER[::2], interpret=True))
    return out


@pytest.mark.parametrize("kind", ["rocket", "zero_nonpos", "grasp",
                                  "flexsat"])
def test_reference_matches_jax_pallas_interpret(interpret_cases, kind):
    args, (Xj, Uj, Jj) = interpret_cases[kind]
    Xs, Us, J = rollout_al.batched_ls_rollout_al_reference(*args,
                                                           LADDER[::2])
    assert J.shape == (4, 3) and Xs.shape[:2] == (4, 3)
    np.testing.assert_allclose(Xs.numpy(), np.asarray(Xj), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(Us.numpy(), np.asarray(Uj), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(J.numpy(), np.asarray(Jj), rtol=1e-8)


def test_wrapper_takes_plain_version_on_cpu(interpret_cases):
    args, _ = interpret_cases["rocket"]
    before = rollout_al.launch_count
    got = rollout_al.batched_ls_rollout_al(*args, LADDER)
    ref = rollout_al.batched_ls_rollout_al_reference(*args, LADDER)
    assert rollout_al.launch_count == before
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    with pytest.raises(ValueError):
        rollout_al.batched_ls_rollout_al(*args[:7], args[7][:, :-1],
                                         *args[8:], LADDER)


def test_merit_is_al_cost_without_the_lambda_term():
    """J of the alpha=0 rung with K = d = 0 is the AL cost of (Xbar rolled
    out, Ubar) plus sum mask |lam|^2 / (2 rho)."""
    from altro_tpu_torch.solver.altro import total_al_cost_res

    cost, A, B, dd, blocks, X, U, K, d, lams, rho = _case("rocket", 9, 3, 2)
    Xs, Us, J = rollout_al.batched_ls_rollout_al_reference(
        cost, A, B, dd, blocks, X, U, torch.zeros_like(K),
        torch.zeros_like(d), lams, rho, (0.0,))
    prob = tt.Problem(dynamics=tt.LTVDynamics(A=A, B=B, d=dd), cost=cost,
                      constraints=blocks, x0=X[:, 0])
    duals = tuple(tt.DualState(lam=lam, rho=rho) for lam in lams)
    J_al, _ = total_al_cost_res(prob, duals, Xs[:, 0], Us[:, 0])
    lam_term = sum(torch.sum(c.mask * torch.sum(lam ** 2, -1) / (2 * rho), -1)
                   for c, lam in zip(blocks, lams))
    np.testing.assert_allclose(J[:, 0].numpy(), (J_al + lam_term).numpy(),
                               rtol=1e-12)


def test_work_counts_at_the_rocket_shape():
    """The yardstick of the kernel's bound (bench/kernels.py): 8.5 MB and
    0.089 GFLOP at B=1024, N=21, n=6, m=3, 15 rows, L=6 in float32."""
    from altro_tpu_torch.bench.kernels import bound_ms, rollout_al_work

    nbytes, flops = rollout_al_work(1024, 21, 6, 3, 15, 6, 4)
    assert (nbytes, flops) == (8_478_936, 88_805_376)
    assert rollout_al_work(1024, 21, 6, 3, 15, 6, 8)[0] == 2 * nbytes
    ms, by = bound_ms(nbytes, flops, 4)
    assert by == "bytes" and abs(ms - 0.00253) < 1e-5


def test_bench_inputs_run_through_the_wrapper():
    """The rocket-window arguments that the benchmark and the smoke run time
    the kernel on: the shapes of a B=3 batch, and a finite merit."""
    from altro_tpu_torch.bench.kernels import ROCKET_LADDER, rocket_inputs

    rk = rocket_inputs(torch.float64, torch.device("cpu"), B=3)
    assert rk["ladder_al"][-1] == ROCKET_LADDER
    Xs, Us, J = rollout_al.batched_ls_rollout_al(*rk["ladder_al"],
                                                 packed=rk["packed"])
    assert Xs.shape == (3, 6, 21, 6) and Us.shape == (3, 6, 20, 3)
    assert J.shape == (3, 6) and bool(torch.isfinite(J).all())


MIXED = (("zero", 4), ("nonpos", 4), ("soc", 5), ("soc", 3))


def _random_case(n, m, N, Bt, spec, seed, masked=()):
    """Port arguments (without the ladder) of a random problem: shared cost,
    dynamics near the identity and constraint blocks ``spec`` = ((cone, p),
    ...), the blocks ``masked`` switched off on the even knots; per-lane
    Xbar, Ubar, gains, multipliers and rho in [1, 100]."""
    rng = np.random.default_rng(seed)
    t = torch.as_tensor

    def spd(N_, d):
        M = 0.3 * rng.standard_normal((N_, d, d))
        return np.einsum("kij,klj->kil", M, M) + np.eye(d)

    R, r = spd(N, m), rng.standard_normal((N, m))
    H = 0.1 * rng.standard_normal((N, m, n))
    R[-1], r[-1], H[-1] = 0.0, 0.0, 0.0
    cost = tt.QuadCost(Q=t(spd(N, n)), q=t(rng.standard_normal((N, n))),
                       R=t(R), r=t(r), H=t(H), c=t(rng.standard_normal(N)))
    A = 0.9 * np.eye(n) + 0.05 * rng.standard_normal((N - 1, n, n))
    B = 0.3 * rng.standard_normal((N - 1, n, m))
    dd = 0.1 * rng.standard_normal((N - 1, n))
    blocks = []
    for i, (cone, p) in enumerate(spec):
        mask = np.ones(N)
        if i in masked:
            mask[::2] = 0.0
        blocks.append(tt.ConicConstraint(
            Cx=t(0.3 * rng.standard_normal((N, p, n))),
            Cu=t(0.3 * rng.standard_normal((N, p, m))),
            b=t(rng.standard_normal((N, p))), mask=t(mask),
            cone=tt.Cone(cone)))
    X = rng.standard_normal((Bt, N, n))
    U = rng.standard_normal((Bt, N - 1, m))
    K = 0.1 * rng.standard_normal((Bt, N - 1, m, n))
    d = rng.standard_normal((Bt, N - 1, m))
    lams = tuple(t(3.0 * rng.standard_normal((Bt, N, p))) for _, p in spec)
    rho = 10.0 ** rng.uniform(0, 2, (Bt, N))
    return (cost, t(A), t(B), t(dd), tuple(blocks), t(X), t(U), t(K), t(d),
            lams, t(rho))


def _assert_matches(got, ref, tol):
    """Xs, Us against max(1, max|plain|); J per lane against
    max(1, |J_plain|)."""
    for g, r in zip(got[:2], ref[:2]):
        assert float((g - r).abs().max()) <= tol * max(1.0,
                                                      float(r.abs().max()))
    assert bool(((got[2] - ref[2]).abs()
                 <= tol * torch.clamp(ref[2].abs(), min=1.0)).all())


def test_random_case_reference_is_consistent():
    """The edge tests' generator on the CPU: the wrapper's plain route takes
    16 mixed blocks of 64 rows, and a block masked off on every knot adds
    nothing to the merit."""
    args = _random_case(5, 3, 4, 2, MIXED * 4, seed=11)
    Xs, Us, J = rollout_al.batched_ls_rollout_al(*args, (1.0, 0.0))
    assert J.shape == (2, 2) and bool(torch.isfinite(J).all())
    blocks = list(args[4])
    off = tt.ConicConstraint(Cx=blocks[2].Cx, Cu=blocks[2].Cu, b=blocks[2].b,
                             mask=torch.zeros_like(blocks[2].mask),
                             cone=blocks[2].cone)
    with_off = rollout_al.batched_ls_rollout_al(
        *args[:4], tuple(blocks[:2] + [off] + blocks[3:]), *args[5:],
        (1.0, 0.0))[2]
    without = rollout_al.batched_ls_rollout_al(
        *args[:4], tuple(blocks[:2] + blocks[3:]), *args[5:9],
        args[9][:2] + args[9][3:], args[10], (1.0, 0.0))[2]
    np.testing.assert_allclose(with_off.numpy(), without.numpy(), rtol=1e-12)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to run the hand-written kernel")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.float64, 1e-9)])
@pytest.mark.parametrize("kind,N,Bt", [("rocket", 21, 67),
                                       ("zero_nonpos", 9, 5),
                                       ("grasp", 21, 1024),
                                       ("grasp", 21, 131),
                                       ("flexsat", 80, 1024)])
def test_kernel_matches_plain_version(cuda, kind, N, Bt, dtype, tol):
    """Xs, Us against max(1, max|plain|); J per lane against
    max(1, |J_plain|): the merit reaches 1e6 with rho up to 1e3."""
    args = convert.tree_to(_case(kind, N, Bt, seed=3), cuda, dtype)
    before = rollout_al.launch_count
    got = rollout_al.batched_ls_rollout_al(*args, LADDER)
    torch.cuda.synchronize()
    assert rollout_al.launch_count == before + 1
    ref = rollout_al.batched_ls_rollout_al_reference(*args, LADDER)
    _assert_matches(got, ref, tol)


# The edges of the kernel's thread mapping: (n, m, N, Bt, blocks, ladder
# length, masked blocks). 16 lanes per (scenario, rung) up to n, m = 16 with
# 1, 2 or 4 constraint rows per lane, 32 lanes above with 1 or 2; a tail block
# of scenarios and a single scenario; the longest ladder (split into chunks
# of rungs at 32 lanes) and the shortest; a block masked off on even knots.
EDGES = {
    "bt1023": (6, 3, 9, 1023, MIXED[1:], 6, ()),
    "bt1": (6, 3, 9, 1, MIXED[1:], 6, ()),
    "rows2": (8, 4, 6, 17, MIXED * 2, 3, ()),
    "rows4_16_blocks": (8, 4, 6, 17, MIXED * 4, 3, ()),
    "wide_16_blocks": (32, 32, 5, 9, MIXED * 4, 3, ()),
    "wide_rows1": (20, 5, 6, 7, MIXED * 2, 2, ()),
    "no_blocks": (5, 2, 6, 4, (), 2, ()),
    "longest_ladder": (6, 3, 6, 5, MIXED[1:], 32, ()),
    "longest_ladder_wide": (20, 5, 5, 3, MIXED, 32, ()),
    "one_rung": (6, 3, 6, 5, MIXED[1:], 1, ()),
    "masked": (6, 3, 9, 33, MIXED, 4, (1, 2)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.float64, 1e-9)])
@pytest.mark.parametrize("edge", sorted(EDGES))
def test_kernel_matches_plain_version_at_its_edges(cuda, edge, dtype, tol):
    n, m, N, Bt, spec, L, masked = EDGES[edge]
    args = convert.tree_to(_random_case(n, m, N, Bt, spec, 5, masked), cuda,
                           dtype)
    ladder = tuple(0.5 ** i for i in range(L - 1)) + (0.0,)
    got = rollout_al.batched_ls_rollout_al(*args, ladder)
    torch.cuda.synchronize()
    assert got[2].shape == (Bt, L)
    _assert_matches(got, rollout_al.batched_ls_rollout_al_reference(
        *args, ladder), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.float64, 1e-9)])
def test_kernel_nan_lane_stays_in_its_lane(cuda, dtype, tol):
    """A NaN multiplier of one lane makes that lane's merit NaN on every
    rung and leaves its rollout alone; every other lane matches the plain
    version."""
    args = list(convert.tree_to(_random_case(6, 3, 7, 40, MIXED, 6), cuda,
                                dtype))
    args[9][2][4, 3, 1] = float("nan")               # an SOC block's row
    got = rollout_al.batched_ls_rollout_al(*args, LADDER)
    ref = rollout_al.batched_ls_rollout_al_reference(*args, LADDER)
    assert bool(torch.isnan(got[2][4]).all())
    keep = torch.arange(40, device=cuda) != 4
    _assert_matches(tuple(g[keep] for g in got), tuple(r[keep] for r in ref),
                    tol)
    for g, r in zip(got[:2], ref[:2]):
        assert float((g[4] - r[4]).abs().max()) <= tol * max(
            1.0, float(r.abs().max()))


@pytest.mark.cuda
def test_kernel_refuses_past_its_limits(cuda):
    args = convert.tree_to(_case("rocket", 9, 2, seed=4), cuda,
                           torch.float64)
    with pytest.raises(ValueError):                 # L > MAX_RUNGS = 32
        rollout_al.batched_ls_rollout_al(*args,
                                         (0.5,) * (rollout_al.MAX_RUNGS + 1))
    many = args[4] * 6                              # 18 blocks, 90 rows
    lams = args[9] * 6
    with pytest.raises(ValueError):
        rollout_al.batched_ls_rollout_al(*args[:4], many, *args[5:9], lams,
                                         args[10], LADDER)
