"""The port's conic modules against the JAX package in float64 on identical
inputs (atol 1e-12): the SOC projection Jacobians and curvature factors,
the SOC forms of the AL terms, the norm-constraint constructors, the ZOH
discretization and the rocket model (problem, hover controls, noise)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from altro_tpu import cones as jcones  # noqa: E402
from altro_tpu import constraints as jcons  # noqa: E402
from altro_tpu.dynamics import zoh_discretize as j_zoh  # noqa: E402
from altro_tpu.models import rocket as jrocket  # noqa: E402

from altro_tpu_torch import cones as tcones  # noqa: E402
from altro_tpu_torch import constraints as tcons  # noqa: E402
from altro_tpu_torch import convert  # noqa: E402
from altro_tpu_torch.dynamics import zoh_discretize as t_zoh  # noqa: E402
from altro_tpu_torch.models import rocket as trocket  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=0, atol=1e-12)


def close(t, j, **kw):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), **(kw or TOL))


def soc_cases(rng, p=5, rows=64):
    """Random residuals plus one row in each SOC case: inside, inside the
    polar, boundary, on the surface, and the apex (v = 0)."""
    z = rng.standard_normal((rows, p)) * 2.0
    v = np.zeros(p - 1)
    v[:2] = (3.0, 4.0)
    special = np.stack([np.append(0.1 * v, 3.0), np.append(0.1 * v, -3.0),
                        np.append(v, 1.0), np.append(v, 5.0),
                        np.append(np.zeros(p - 1), 1.0),
                        np.append(np.zeros(p - 1), -1.0), np.zeros(p)])
    return np.concatenate([z, special])


def case_counts(z):
    a = np.linalg.norm(z[..., :-1], axis=-1)
    s = z[..., -1]
    inside, polar = a <= s, a <= -s
    return int(inside.sum()), int(polar.sum()), int((~(inside | polar)).sum())


def test_soc_jacobians_and_factors_match_jax():
    z = soc_cases(np.random.default_rng(0))
    assert min(case_counts(z)) > 0
    zt, zj = torch.as_tensor(z), jnp.asarray(z)
    close(tcones.project_soc_jacobian(zt), jcones.project_soc_jacobian(zj))
    for name in ("zero", "nonpos", "soc"):
        close(tcones.project_polar_jacobian(tcones.Cone(name), zt),
              jcones.project_polar_jacobian(jcones.Cone(name), zj))
    for t, j in zip(tcones.soc_polar_curvature_factors(zt),
                    jcones.soc_polar_curvature_factors(zj)):
        close(t, j)
    # the factors reassemble the Jacobian, except at z = 0 exactly, which is
    # both inside (J = 0) and in the polar (factors: diag(1)) in both
    # packages
    zt = zt[zt.abs().sum(-1) > 0]
    w, c1, u1, c2, u2 = tcones.soc_polar_curvature_factors(zt)
    J = (torch.diag_embed(w) + c1[:, None, None] * u1[:, :, None] * u1[:, None]
         + c2[:, None, None] * u2[:, :, None] * u2[:, None])
    close(J, tcones.project_polar_jacobian(tcones.Cone.SOC, zt))


def _soc_block(kind, N, n, m):
    """A JAX SOC block and its port copy: 'dense' is a p=4 control cone,
    'diag_lr' a p=13 state cone (p >= 12 takes the factored form)."""
    rng = np.random.default_rng(1)
    if kind == "dense":
        jcon = jcons.norm_constraint2(N, n, m, rng.standard_normal((3, m)),
                                      rng.standard_normal(m), on="control",
                                      offset=0.5, dtype=jnp.float64)
    else:
        jcon = jcons.norm_constraint2(N, n, m, rng.standard_normal((12, n)),
                                      rng.standard_normal(n), on="state",
                                      start=1, dtype=jnp.float64)
    tree = convert.numpy_tree(jcon)
    tcon = tcons.ConicConstraint(
        **{k: torch.tensor(tree[k]) for k in ("Cx", "Cu", "b", "mask")},
        cone=tcones.Cone(tree["cone"]), name=tree["name"])
    return jcon, tcon


@pytest.mark.parametrize("kind", ["dense", "diag_lr"])
def test_soc_al_terms_match_jax(kind):
    N, n, m, Bt = 6, 5, 3, 4
    jcon, tcon = _soc_block(kind, N, n, m)
    rng = np.random.default_rng(2)
    X = 2.0 * rng.standard_normal((Bt, N, n))
    U = 2.0 * rng.standard_normal((Bt, N - 1, m))
    lam = rng.standard_normal((Bt, N, jcon.p))
    lam[0, 2, :-1] = 0.0           # with X, U zeroed below: the apex
    X[0, 2] = 0.0
    U[0, 2] = 0.0
    rho = np.full((Bt, N), 30.0)
    jargs = tuple(jnp.asarray(a) for a in (lam, rho, X, U))
    tdual = tcons.DualState(lam=torch.as_tensor(lam),
                            rho=torch.as_tensor(rho))
    tX, tU = torch.as_tensor(X), torch.as_tensor(U)

    def j_struct(l, r, x, u):
        g, (kd, H) = jcons.al_terms_structured(jcon, jcons.DualState(l, r),
                                               x, u)
        assert kd == kind
        return g, H

    jg, jH = jax.vmap(j_struct)(*jargs)
    tg, (tkind, tH) = tcons.al_terms_structured(tcon, tdual, tX, tU)
    assert tkind == kind
    close(tg, jg)
    for t, j in zip(jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(np.asarray, tH)),
            jax.tree_util.tree_leaves(jH)):
        close(t, j)

    jv, jgc, jcurv = jax.vmap(lambda l, r, x, u: jcons.al_terms(
        jcon, jcons.DualState(l, r), x, u))(*jargs)
    tv, tgc, tcurv = tcons.al_terms(tcon, tdual, tX, tU)
    close(tv, jv, rtol=1e-12, atol=1e-12)
    close(tgc, jgc)
    close(tcurv, jcurv)
    close(tcons.al_cost(tcon, tdual, tX, tU),
          jax.vmap(lambda l, r, x, u: jcons.al_cost(
              jcon, jcons.DualState(l, r), x, u))(*jargs), rtol=1e-12,
          atol=1e-12)
    jd = jax.vmap(lambda l, r, x, u: jcons.dual_update(
        jcon, jcons.DualState(l, r), x, u, 10.0, 1e3))(*jargs)
    td = tcons.dual_update(tcon, tdual, tX, tU, 10.0, 1e3)
    close(td.lam, jd.lam)
    close(td.rho, jd.rho)


def test_norm_constraints_match_jax():
    N, n, m = 9, 6, 3
    rng = np.random.default_rng(3)
    A, c = rng.standard_normal((2, n)), rng.standard_normal(n)
    mask = (rng.random(N) < 0.5).astype(float)
    pairs = [
        (jcons.norm_constraint(N, n, m, 4.0, dtype=jnp.float64),
         tcons.norm_constraint(N, n, m, 4.0, dtype=torch.float64)),
        (jcons.norm_constraint(N, n, m, 2.0, on="state", start=2, stop=7,
                               dtype=jnp.float64),
         tcons.norm_constraint(N, n, m, 2.0, on="state", start=2, stop=7,
                               dtype=torch.float64)),
        (jcons.norm_constraint2(N, n, m, A, c, on="state", offset=0.3,
                                start=3, dtype=jnp.float64),
         tcons.norm_constraint2(N, n, m, A, c, on="state", offset=0.3,
                                start=3, dtype=torch.float64)),
        (jcons.norm_constraint2(N, n, m, A, c, on="state", mask=mask,
                                dtype=jnp.float64),
         tcons.norm_constraint2(N, n, m, A, c, on="state",
                                mask=torch.as_tensor(mask),
                                dtype=torch.float64)),
    ]
    for jc, tc in pairs:
        for k in ("Cx", "Cu", "b", "mask"):
            close(getattr(tc, k), getattr(jc, k))
        assert (tc.cone.value, tc.name) == (jc.cone.value, jc.name)


def test_zoh_discretize_matches_jax():
    rng = np.random.default_rng(4)
    A, B, d = (rng.standard_normal((5, 5)), rng.standard_normal((5, 2)),
               rng.standard_normal(5))
    for dd in (d, None):
        want = j_zoh(jnp.asarray(A), jnp.asarray(B), 0.1,
                     None if dd is None else jnp.asarray(dd))
        got = t_zoh(torch.as_tensor(A), torch.as_tensor(B), 0.1,
                    None if dd is None else torch.as_tensor(dd))
        for g, w in zip(got, want):
            close(g, w)


def test_rocket_problem_and_hover_match_jax():
    """rocket_problem(N=41) built by the port equals the JAX problem carried
    across with convert (goal ZERO block + three SOC blocks)."""
    N = 41
    jp = jrocket.rocket_problem(N=N, tf=(N - 1) * 0.05)
    tp = trocket.rocket_problem(N=N, tf=(N - 1) * 0.05)
    ref = convert.problem_from_numpy(convert.numpy_tree(jp))
    for name in ("dynamics", "cost"):
        for k, v in vars(getattr(ref, name)).items():
            close(getattr(getattr(tp, name), k), v)
    assert [c.cone.value for c in ref.constraints] == ["zero", "soc", "soc",
                                                       "soc"]
    assert [c.p for c in ref.constraints] == [6, 4, 4, 7]
    for rc, tc in zip(ref.constraints, tp.constraints):
        for k in ("Cx", "Cu", "b", "mask"):
            close(getattr(tc, k), getattr(rc, k))
        assert (tc.cone, tc.name) == (rc.cone, rc.name)
    close(tp.x0, ref.x0)
    close(trocket.hover_controls(tp), jrocket.hover_controls(jp))


def test_rocket_noise_model_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((7, 6)) * 10.0
    noise = rng.standard_normal((7, 6))
    want = jax.vmap(jrocket.rocket_noise_model())(jnp.asarray(x),
                                                   jnp.asarray(noise))
    got = trocket.rocket_noise_model()(torch.as_tensor(x),
                                       torch.as_tensor(noise))
    close(got, want)
    # one scenario's norms do not reach another's
    one = trocket.rocket_noise_model()(torch.as_tensor(x[:1]),
                                       torch.as_tensor(noise[:1]))
    close(one, np.asarray(want)[:1])


def test_rocket_mpc_window_carries_three_soc_blocks():
    """gen_tracking_mpc drops the goal and clips the masks to the window
    (the port's own window against the JAX window)."""
    from altro_tpu.mpc import gen_tracking_mpc as j_gen

    from altro_tpu_torch.mpc import gen_tracking_mpc as t_gen
    N = 41
    jp = jrocket.rocket_problem(N=N, tf=(N - 1) * 0.05)
    tp = trocket.rocket_problem(N=N, tf=(N - 1) * 0.05)
    U = np.asarray(jrocket.hover_controls(jp))
    X = np.asarray(jp.dynamics.rollout(jp.x0, jnp.asarray(U)))
    jw = j_gen(jp, jnp.asarray(X), jnp.asarray(U), 21, dt=0.05)
    tw = t_gen(tp, torch.tensor(X), torch.tensor(U), 21, dt=0.05)
    ref = convert.problem_from_numpy(convert.numpy_tree(jw))
    assert [c.p for c in tw.constraints] == [4, 4, 7]
    for rc, tc in zip(ref.constraints, tw.constraints):
        for k in ("Cx", "Cu", "b", "mask"):
            close(getattr(tc, k), getattr(rc, k))
    for k, v in vars(ref.cost).items():
        close(getattr(tw.cost, k), v)
    close(tw.x0, ref.x0)
