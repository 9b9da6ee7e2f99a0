"""The port's dense ADMM solvers (``solver/admm_qp.py``, ``admm_conic.py``)
in float64 on the CPU: the five cases of ``tests/test_admm.py`` (analytic
solutions and KKT residuals), each solver against the JAX package's on
bit-equal data carried over as numpy arrays (``convert.batch_qp_from_numpy``
and ``batch_conic_from_numpy``; gates: equal iterations and status,
max|dx| and max|dy| <= 1e-8), a B=3 batch against the JAX package's
``vmap``, a refactor whose Cholesky factor fails keeping the old factor and
rho on its lane, -inf bounds surviving the scaling, and the fixed-buffer
route (``graphed=True`` on the CPU: the chunk over fixed buffers, without
capture) bit for bit against the eager loop. Marked ``cuda``: the graphed
chunk loop against the eager one on the card, for all three solvers.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax
    import jax.numpy as jnp

    from altro_tpu import transcribe as jtr
    from altro_tpu.solver import admm_conic as jconic
    from altro_tpu.solver import admm_qp as jqp
except ImportError:
    # the machine with the card has no JAX: only the cuda-marked tests,
    # which read none of it, run there
    jax = None

import altro_tpu_torch as tt  # noqa: E402
from altro_tpu_torch import convert  # noqa: E402
from altro_tpu_torch.cones import Cone, project_soc  # noqa: E402
from altro_tpu_torch.solver import admm_conic, admm_qp  # noqa: E402
from altro_tpu_torch.transcribe import (BatchConic, BatchQP,  # noqa: E402
                                        extract_traj, to_batch_qp)

torch.set_num_threads(1)
F64 = torch.float64
needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package")


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


# ----------------------------------------------------------------------------
# tests/test_admm.py's five cases
# ----------------------------------------------------------------------------

def test_box_qp_analytic():
    # min 0.5||x - c||^2 s.t. -1 <= x <= 1  ->  x* = clip(c, -1, 1)
    NN = 4
    c = _t([0.5, 2.0, -3.0, 0.0])
    qp = BatchQP(P=torch.eye(NN, dtype=F64)[None], q=-c[None],
                 A=torch.eye(NN, dtype=F64)[None],
                 l=-torch.ones((1, NN), dtype=F64),
                 u=torch.ones((1, NN), dtype=F64), n=NN, m=0, N=1)
    sol = admm_qp.solve(admm_qp.setup(qp), eps_abs=1e-8)
    np.testing.assert_allclose(sol.x[0], torch.clamp(c, -1, 1), atol=1e-6)
    assert int(sol.status[0]) == 1


def test_eq_qp_kkt():
    rng = np.random.default_rng(0)
    NN, ME = 8, 3
    L = rng.standard_normal((NN, NN))
    P = L @ L.T + np.eye(NN)
    q = rng.standard_normal(NN)
    A = rng.standard_normal((ME, NN))
    b = rng.standard_normal(ME)
    qp = BatchQP(P=_t(P)[None], q=_t(q)[None], A=_t(A)[None], l=_t(b)[None],
                 u=_t(b)[None], n=NN, m=0, N=1)
    sol = admm_qp.solve(admm_qp.setup(qp), eps_abs=1e-9)
    x, y = sol.x[0].numpy(), sol.y[0].numpy()
    np.testing.assert_allclose(P @ x + q + A.T @ y, np.zeros(NN), atol=1e-6)
    np.testing.assert_allclose(A @ x, b, atol=1e-7)


def test_conic_matches_qp_on_box():
    NN = 4
    c = _t([0.5, 2.0, -3.0, 0.0])
    A = torch.cat([torch.eye(NN, dtype=F64), -torch.eye(NN, dtype=F64)])
    prob = BatchConic(P=torch.eye(NN, dtype=F64)[None], q=-c[None],
                      A=A[None], b=torch.ones((1, 2 * NN), dtype=F64),
                      segments=((Cone.NONPOS, 2 * NN),), n=NN, m=0, N=1)
    sol = admm_conic.solve(admm_conic.setup(prob), eps_abs=1e-8)
    np.testing.assert_allclose(sol.x[0], torch.clamp(c, -1, 1), atol=1e-6)


def test_conic_soc_projection_problem():
    # min 0.5||x - c||^2 s.t. ||x[:2]|| <= x[2]  ->  x* = proj_SOC(c)
    c = _t([3.0, 4.0, 1.0])
    prob = BatchConic(P=torch.eye(3, dtype=F64)[None], q=-c[None],
                      A=-torch.eye(3, dtype=F64)[None],
                      b=torch.zeros((1, 3), dtype=F64),
                      segments=((Cone.SOC, 3),), n=3, m=0, N=1)
    sol = admm_conic.solve(admm_conic.setup(prob), eps_abs=1e-9)
    np.testing.assert_allclose(sol.x[0], project_soc(c), atol=1e-6)


def test_transcription_qp_matches_altro_unconstrained():
    n, m, N = 4, 2, 11
    rng = np.random.default_rng(1)
    A = _t(rng.standard_normal((n, n)) * 0.3 + np.eye(n) * 0.5)
    B = _t(rng.standard_normal((n, m)))
    prob = tt.Problem(dynamics=tt.lti_dynamics(A, B, N),
                      cost=tt.lqr_objective(torch.eye(n, dtype=F64),
                                            torch.eye(m, dtype=F64) * 0.1,
                                            torch.eye(n, dtype=F64) * 5,
                                            torch.zeros(n, dtype=F64), N),
                      constraints=(), x0=_t([[1.0, -2.0, 0.5, 0.3]]))
    sol = tt.solve(prob, tt.SolverOptions(cost_tolerance=1e-10,
                                          gradient_tolerance=1e-10))
    qp = to_batch_qp(prob)
    qsol = admm_qp.solve(admm_qp.setup(qp), eps_abs=1e-9)
    Xq, Uq = extract_traj(qp, qsol.x)
    np.testing.assert_allclose(sol.X, Xq, atol=1e-5)
    np.testing.assert_allclose(sol.U, Uq, atol=1e-5)


# ----------------------------------------------------------------------------
# against the JAX package on bit-equal data
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_programs():
    """The JAX package's random-linear QP (n=12, m=6, N=11) and the
    rocket's N=21 window as a conic program, tracking the hover-thrust
    rollout from the rocket's x0."""
    from altro_tpu.models import random_linear as jrl
    from altro_tpu.models import rocket as jrk
    from altro_tpu.mpc import gen_tracking_mpc
    rng = np.random.default_rng(1)
    p = jrl.gen_random_linear(rng, 12, 6, 30)
    X, U = jrl.gen_trajectory(rng, p, 30)
    qp = jax.jit(jtr.to_batch_qp)(jrl.gen_tracking_mpc(p, X, U, 11))
    rp = jrk.rocket_problem(N=301, tf=15.0)
    A, B, d = (np.asarray(a[0]) for a in (rp.dynamics.A, rp.dynamics.B,
                                          rp.dynamics.d))
    U = np.asarray(jrk.hover_controls(rp))
    X = [np.asarray(rp.x0)]
    for u in U:
        X.append(A @ X[-1] + B @ u + d)
    pm = gen_tracking_mpc(rp, jnp.asarray(np.stack(X)), jnp.asarray(U), 21,
                          dt=0.05)
    return qp, jax.jit(jtr.to_batch_conic)(pm)


def _gate(jsol, tsol, fields, lane=None):
    jit = np.asarray(jsol.iterations)
    jst = np.asarray(jsol.status)
    if lane is not None:
        jit, jst = jit[lane], jst[lane]
    assert int(jit) == int(tsol.iterations[0]), (jit, tsol.iterations)
    assert int(jst) == int(tsol.status[0]) == 1
    for f in fields:
        a = np.asarray(getattr(jsol, f))
        a = a[lane] if lane is not None else a
        err = np.abs(a - getattr(tsol, f)[0].numpy()).max()
        assert err <= 1e-8, (f, err)


@needs_jax
def test_admm_qp_matches_jax(jax_programs):
    jq, _ = jax_programs
    tq = convert.batch_qp_from_numpy(convert.numpy_tree(jq))
    jsol = jqp.solve(jqp.setup(jq), eps_abs=1e-7)
    tsol = admm_qp.solve(admm_qp.setup(tq), eps_abs=1e-7)
    _gate(jsol, tsol, ("x", "y", "z"))
    assert tsol.chunks == int(jsol.iterations) // admm_qp.CHUNK


@needs_jax
def test_admm_conic_matches_jax(jax_programs):
    _, jc = jax_programs
    tc = convert.batch_conic_from_numpy(convert.numpy_tree(jc))
    jsol = jconic.solve(jconic.setup(jc), eps_abs=1e-7)
    tsol = admm_conic.solve(admm_conic.setup(tc), eps_abs=1e-7)
    _gate(jsol, tsol, ("x", "y", "s"))


@needs_jax
def test_admm_qp_batch_matches_jax_vmap(jax_programs):
    """Three lanes with their own x0 rows: each lane is the JAX package's
    vmapped solve of its lane (the Ruiz scalings depend on P, q, A only,
    so the per-lane setup equals the JAX package's shared one)."""
    jq, _ = jax_programs
    x0s = np.random.default_rng(2).standard_normal((3, 12))
    r0 = (jq.N - 1) * jq.n
    jwork = jqp.setup(jq)
    ls = jnp.stack([jq.l.at[r0:r0 + 12].set(x) for x in x0s])
    us = jnp.stack([jq.u.at[r0:r0 + 12].set(x) for x in x0s])
    jsol = jax.jit(jax.vmap(lambda l, u: jqp.solve(
        jwork.replace(qp=jwork.qp.replace(l=l, u=u)), eps_abs=1e-7)))(ls, us)
    tq = convert.batch_qp_from_numpy(convert.numpy_tree(jq))
    tq = BatchQP(P=tq.P.expand(3, -1, -1), q=tq.q.expand(3, -1),
                 A=tq.A.expand(3, -1, -1), l=_t(ls), u=_t(us), n=tq.n,
                 m=tq.m, N=tq.N)
    tsol = admm_qp.solve(admm_qp.setup(tq), eps_abs=1e-7)
    for lane in range(3):
        one = dataclasses.replace(
            tsol, **{f: getattr(tsol, f)[lane:lane + 1] for f in
                     ("x", "y", "z", "iterations", "status")})
        _gate(jsol, one, ("x", "y"), lane=lane)


def test_failed_refactor_keeps_old_factor_and_rho():
    """``admm_qp._refactor`` on two lanes whose rho both adapt: lane 0's new
    KKT matrix diag(1, -1) + (sigma + rho) I at rho = 0.1 is indefinite
    (``cholesky_ex`` reports info != 0), so it keeps its factor and rho;
    lane 1's at rho = 20 is positive definite and is taken."""
    Ps = torch.diag(_t([1.0, -1.0])).expand(2, 2, 2)
    As = torch.eye(2, dtype=F64).expand(2, 2, 2)
    eq = torch.zeros((2, 2), dtype=torch.bool)
    sigma = torch.tensor(1e-6, dtype=F64)
    K = admm_qp._kkt(Ps, As, sigma, admm_qp._rho_vec(eq, _t([10.0, 10.0])))
    chol = admm_qp.chol_nan(K)
    assert torch.isfinite(chol).all()
    assert int(torch.linalg.cholesky_ex(admm_qp._kkt(
        Ps[:1], As[:1], sigma, admm_qp._rho_vec(eq[:1], _t([0.1]))))[1]) > 0
    d = dataclasses.make_dataclass("D", ["Ps", "As", "eq", "sigma"])(
        Ps, As, eq, sigma)
    z = torch.zeros((2, 2), dtype=F64)
    s = (z, z, z, _t([10.0, 10.0]), chol, torch.zeros(2, dtype=torch.int32),
         z[:, 0], z[:, 0], torch.zeros(2, dtype=torch.bool))
    out = admm_qp._refactor(d, s, (_t([0.1, 20.0]),
                                   torch.tensor([True, True])))
    assert torch.equal(out[3], _t([10.0, 20.0]))
    assert torch.equal(out[4][0], chol[0])
    np.testing.assert_allclose(out[4][1] @ out[4][1].T, K[1] + 10.0 *
                               torch.eye(2, dtype=F64), atol=1e-12)


def test_infinite_bounds_survive_scaling():
    """NONPOS rows carry l = -inf: the scaled bounds E l stay -inf (never
    NaN), those rows are not taken for equalities, and the solve is
    finite."""
    from altro_tpu_torch.models import random_linear as rl
    rng = np.random.default_rng(1)
    p = rl.gen_random_linear(rng, 6, 2, 20)
    X, U = rl.gen_trajectory(rng, p, 20)
    qp = to_batch_qp(rl.gen_tracking_mpc(p, X, U, 11))
    inf = torch.isinf(qp.l)
    assert inf.any() and (qp.l[inf] == -torch.inf).all()
    work = admm_qp.setup(qp)
    ls = work.E * qp.l
    assert torch.equal(torch.isneginf(ls), inf) and not ls.isnan().any()
    assert (work.rho_vec[inf] == 0.1).all()
    sol = admm_qp.solve(work, eps_abs=1e-7)
    assert int(sol.status[0]) == 1
    for f in ("x", "y", "z"):
        assert torch.isfinite(getattr(sol, f)).all()


def test_fixed_buffer_route_matches_eager_loop():
    """``graphed=True`` on the CPU (the chunk over fixed buffers, without
    capture) against the eager loop, bit for bit, for both dense solvers;
    the second graphed solve reuses the first's buffers."""
    from altro_tpu_torch.models import random_linear as rl
    from altro_tpu_torch.transcribe import to_batch_conic
    rng = np.random.default_rng(4)
    p = rl.gen_random_linear(rng, 8, 3, 30)
    X, U = rl.gen_trajectory(rng, p, 30)
    pm = rl.gen_tracking_mpc(p, X, U, 15)
    x0s = _t(rng.standard_normal((2, 8)))
    for mod, prog in ((admm_qp, to_batch_qp(
            dataclasses.replace(pm, x0=x0s))),
            (admm_conic, to_batch_conic(dataclasses.replace(pm, x0=x0s)))):
        work = mod.setup(prog)
        for _ in range(2):
            e = mod.solve(work, eps_abs=1e-7, graphed=False)
            g = mod.solve(work, eps_abs=1e-7, graphed=True)
            for f in dataclasses.fields(e):
                a, b = getattr(e, f.name), getattr(g, f.name)
                assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                        else a == b), (mod.__name__, f.name)
        assert len(work.graphs) == 1


# ----------------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to run the ADMM chunks as graphs")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graphed_chunks_match_eager_on_the_card(cuda):
    """The three solvers' instances of ``bench/baselines.py`` on the card:
    the graphed chunk loop against the eager one (equal status and
    iterations, and bit for bit)."""
    from altro_tpu_torch.bench import baselines
    for name, (mod, make, kw) in baselines.instances(cuda).items():
        work = make(cuda)
        e = mod.solve(work, graphed=False, **kw)
        g = mod.solve(work, graphed=True, **kw)
        assert torch.equal(e.status, g.status), name
        assert torch.equal(e.iterations, g.iterations), name
        assert torch.equal(baselines._primal(e), baselines._primal(g)), name
