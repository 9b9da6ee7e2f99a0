"""The port's problem modules (cones, costs, constraints, dynamics, the
random-linear generators, convert) against the JAX package in float64 on
identical inputs: rtol 1e-12 (atol 1e-12 for entries that are zero)."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import altro_tpu as at  # noqa: E402
from altro_tpu import cones as jcones  # noqa: E402
from altro_tpu.constraints import al_terms_structured as j_al_terms  # noqa: E402
from altro_tpu.models import random_linear as jrl  # noqa: E402

import altro_tpu_torch as tt  # noqa: E402
from altro_tpu_torch import cones as tcones  # noqa: E402
from altro_tpu_torch import convert  # noqa: E402
from altro_tpu_torch.constraints import al_terms_structured as t_al_terms  # noqa: E402
from altro_tpu_torch.models import random_linear as trl  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=1e-12, atol=1e-12)


def close(t, j):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), **TOL)


def _z_cases(rng):
    """Random residuals plus one row in each SOC case: inside, inside the
    polar, boundary, and exactly on the cone's surface."""
    z = rng.standard_normal((64, 5)) * 2.0
    special = np.array([[0.3, 0.4, 0.0, 0.0, 3.0],     # inside
                        [0.3, 0.4, 0.0, 0.0, -3.0],    # polar
                        [3.0, 4.0, 0.0, 0.0, 1.0],     # boundary
                        [3.0, 4.0, 0.0, 0.0, 5.0],     # on the surface
                        [0.0, 0.0, 0.0, 0.0, 0.0]])    # apex
    return np.concatenate([z, special])


@pytest.mark.parametrize("cone", ["zero", "nonpos", "soc"])
def test_cone_projections_match_jax(cone):
    z = _z_cases(np.random.default_rng(0))
    jc, tc = jcones.Cone(cone), tcones.Cone(cone)
    zt = torch.as_tensor(z)
    close(tcones.project(tc, zt), jcones.project(jc, jnp.asarray(z)))
    close(tcones.project_polar(tc, zt), jcones.project_polar(jc, jnp.asarray(z)))
    close(tcones.violation(tc, zt), jcones.violation(jc, jnp.asarray(z)))


def _random_cost(rng, N, n, m):
    S = rng.standard_normal((N, n, n))
    W = rng.standard_normal((N, m, m))
    return at.QuadCost(
        Q=jnp.asarray(S @ S.transpose(0, 2, 1)), q=jnp.asarray(rng.standard_normal((N, n))),
        R=jnp.asarray(W @ W.transpose(0, 2, 1)), r=jnp.asarray(rng.standard_normal((N, m))),
        H=jnp.asarray(rng.standard_normal((N, m, n))), c=jnp.asarray(rng.standard_normal(N)))


def test_quadcost_total_and_expansion_match_jax():
    rng = np.random.default_rng(1)
    N, n, m, Bt = 7, 4, 3, 3
    jc = _random_cost(rng, N, n, m)
    tc = tt.QuadCost(**{k: torch.tensor(v)
                        for k, v in convert.numpy_tree(jc).items()})
    X = rng.standard_normal((Bt, N, n))
    U = rng.standard_normal((Bt, N - 1, m))
    close(tc.total(torch.as_tensor(X), torch.as_tensor(U)),
          jax.vmap(jc.total)(jnp.asarray(X), jnp.asarray(U)))
    t_exp = tc.expansion(torch.as_tensor(X), torch.as_tensor(U))
    j_exp = jax.vmap(jc.expansion)(jnp.asarray(X), jnp.asarray(U))
    close(t_exp[0], j_exp[0])
    close(t_exp[1], j_exp[1])
    for t_h, j_h in zip(t_exp[2:], j_exp[2:]):
        close(t_h, j_h[0])              # the Hessians are the shared stacks


def test_tracking_and_retarget_match_jax():
    rng = np.random.default_rng(2)
    N, n, m = 6, 4, 2
    Xr, Ur = rng.standard_normal((N, n)), rng.standard_normal((N - 1, m))
    Xr2, Ur2 = rng.standard_normal((N, n)), rng.standard_normal((N - 1, m))
    Q, R, Qf = np.diag(rng.random(n)), 0.1 * np.eye(m), 3.0 * np.eye(n)
    jc = at.tracking_objective(Q, R, Qf, Xr, Ur, dt=0.1)
    tc = tt.tracking_objective(*(torch.as_tensor(a) for a in (Q, R, Qf, Xr, Ur)),
                               dt=0.1)
    for k, v in convert.numpy_tree(jc).items():
        close(getattr(tc, k), v)
    jr = at.retarget_tracking(jc, jnp.asarray(Xr2), jnp.asarray(Ur2))
    tr = tt.retarget_tracking(tc, torch.as_tensor(Xr2), torch.as_tensor(Ur2))
    for k, v in convert.numpy_tree(jr).items():
        close(getattr(tr, k), v)
    jl = at.lqr_objective(Q, R, Qf, Xr[0], N, dt=0.1)
    tl = tt.lqr_objective(*(torch.as_tensor(a) for a in (Q, R, Qf, Xr[0])), N,
                          dt=0.1)
    for k, v in convert.numpy_tree(jl).items():
        close(getattr(tl, k), v)


def test_bound_constraint_and_dual_shift_match_jax():
    N, n, m = 6, 3, 2
    kw = dict(x_min=[-1.0, -np.inf, -2.0], x_max=4.0, u_min=-3.0,
              u_max=[3.0, np.inf], start=1, stop=5)
    jb = at.bound_constraint(N, n, m, dtype=jnp.float64, **kw)
    tb = tt.bound_constraint(N, n, m, dtype=torch.float64, **kw)
    for k in ("Cx", "Cu", "b", "mask"):
        close(getattr(tb, k), getattr(jb, k))
    assert tb.cone.value == jb.cone.value
    lam = np.random.default_rng(3).standard_normal((2, N, jb.p))
    jd = jax.vmap(lambda l: at.DualState(lam=l, rho=jnp.ones(N)).shift())(
        jnp.asarray(lam))
    td = tt.DualState(lam=torch.as_tensor(lam), rho=torch.ones(2, N,
                                                               dtype=torch.float64)).shift()
    close(td.lam, jd.lam)


@pytest.mark.parametrize("block", ["bound", "goal"])
def test_al_terms_structured_match_jax(block):
    rng = np.random.default_rng(4)
    N, n, m, Bt = 6, 4, 3, 3
    if block == "bound":
        jcon = at.bound_constraint(N, n, m, u_min=-0.5, u_max=0.5, x_max=1.0,
                                   dtype=jnp.float64)
    else:
        jcon = at.goal_constraint(N, n, m, rng.standard_normal(n),
                                  dtype=jnp.float64)
    tcon = convert.problem_from_numpy({
        "dynamics": {"A": np.zeros((N - 1, n, n)), "B": np.zeros((N - 1, n, m)),
                     "d": np.zeros((N - 1, n))},
        "cost": convert.numpy_tree(_random_cost(rng, N, n, m)),
        "constraints": [convert.numpy_tree(jcon)], "x0": np.zeros(n)}).constraints[0]
    X = rng.standard_normal((Bt, N, n))
    U = rng.standard_normal((Bt, N - 1, m))
    lam = np.abs(rng.standard_normal((Bt, N, jcon.p)))
    rho = np.full((Bt, N), 30.0)
    def j_terms(l, r, x, u):
        g, (kind, w) = j_al_terms(jcon, at.DualState(lam=l, rho=r), x, u)
        assert kind == "diag"
        return g, w

    jg, jw = jax.vmap(j_terms)(*(jnp.asarray(a) for a in (lam, rho, X, U)))
    tg, (tkind, tw) = t_al_terms(
        tcon, tt.DualState(lam=torch.as_tensor(lam), rho=torch.as_tensor(rho)),
        torch.as_tensor(X), torch.as_tensor(U))
    assert tkind == "diag"
    close(tg, jg)
    close(tw, jw)
    close(tcon.evaluate(torch.as_tensor(X), torch.as_tensor(U)),
          jax.vmap(jcon.evaluate)(jnp.asarray(X), jnp.asarray(U)))


def test_ltv_rollout_matches_jax():
    rng = np.random.default_rng(5)
    N, n, m, Bt = 9, 4, 2, 3
    A = 0.5 * rng.standard_normal((N - 1, n, n))
    B = rng.standard_normal((N - 1, n, m))
    d = rng.standard_normal((N - 1, n))
    x0 = rng.standard_normal((Bt, n))
    U = rng.standard_normal((Bt, N - 1, m))
    jd = at.LTVDynamics(A=jnp.asarray(A), B=jnp.asarray(B), d=jnp.asarray(d))
    td = tt.LTVDynamics(A=torch.as_tensor(A), B=torch.as_tensor(B),
                        d=torch.as_tensor(d))
    close(td.rollout(torch.as_tensor(x0), torch.as_tensor(U)),
          jax.vmap(jd.rollout)(jnp.asarray(x0), jnp.asarray(U)))
    close(td.step(torch.as_tensor(x0), torch.as_tensor(U[:, 3]), 3),
          jax.vmap(lambda x, u: jd.step(x, u, 3))(jnp.asarray(x0),
                                                   jnp.asarray(U[:, 3])))


def test_random_linear_generators_match_jax():
    """One seed builds the same problem, reference and MPC window in both
    packages."""
    n, m, N, N_mpc = 6, 3, 20, 8
    jr, tr = np.random.default_rng(11), np.random.default_rng(11)
    jp = jrl.gen_random_linear(jr, n, m, N)
    tp = trl.gen_random_linear(tr, n, m, N)
    jX, jU = jrl.gen_trajectory(jr, jp, N)
    tX, tU = trl.gen_trajectory(tr, tp, N)
    close(tX, jX)
    close(tU, jU)
    for jprob, tprob in ((jp, tp),
                         (jrl.gen_tracking_mpc(jp, jX, jU, N_mpc),
                          trl.gen_tracking_mpc(tp, tX, tU, N_mpc))):
        ref = convert.problem_from_numpy(convert.numpy_tree(jprob))
        for name in ("dynamics", "cost"):
            for k, v in vars(getattr(ref, name)).items():
                close(getattr(getattr(tprob, name), k), v)
        for rc, tc_ in zip(ref.constraints, tprob.constraints):
            for k in ("Cx", "Cu", "b", "mask"):
                close(getattr(tc_, k), getattr(rc, k))
            assert (tc_.cone, tc_.name) == (rc.cone, rc.name)
        close(tprob.x0, ref.x0)


def test_convert_duals_and_options():
    jopts = at.SolverOptions(penalty_initial=1e3, iterations_linesearch=2,
                             early_exact_tol=1e-3)
    topts = convert.options_from_dict(convert.numpy_tree(jopts))
    assert topts == tt.SolverOptions(penalty_initial=1e3,
                                     iterations_linesearch=2,
                                     early_exact_tol=1e-3)
    con = at.bound_constraint(5, 2, 2, u_min=-1.0, u_max=1.0,
                              dtype=jnp.float64)
    jduals = (at.DualState(lam=jnp.arange(20.0).reshape(5, 4),
                           rho=jnp.full((5,), 3.0)),)
    (td,) = convert.duals_from_numpy(convert.numpy_tree(jduals))
    close(td.lam, jduals[0].lam)
    close(td.rho, jduals[0].rho)
    assert con.p == td.lam.shape[-1]


def test_port_imports_no_jax():
    code = ("import sys, altro_tpu_torch, altro_tpu_torch.mpc, "
            "altro_tpu_torch.bench.flagship, altro_tpu_torch.bench.conic, "
            "altro_tpu_torch.models.rocket, altro_tpu_torch.ops.rollout_al, "
            "altro_tpu_torch.ops.blocks, altro_tpu_torch.convert; "
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'flax', 'altro_tpu')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
