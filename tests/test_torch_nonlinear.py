"""The nonlinear and non-affine path against the JAX package in float64 on
the CPU: ``QuadNormConstraint`` (evaluate, jacobians, second_order,
violations on controls and states, with c, offset and a knot mask),
``rk4`` and the RK4 SRB ``NonlinearDynamics`` (step, rollout, linearize;
shared and per-lane params), ``rollout_closed_loop`` (LTV and nonlinear),
``al_expansion`` with an active quadratic norm block; the solves: the
quadratic norm block binding like its SOC counterpart, the naive rocket at
N=41 (two lanes) and the nonlinear SRB trot at B=8 (one lane per contact
schedule, QP friction) against ``jax.vmap`` of the JAX package's solve; the
solver's routing (a non-affine or nonlinear problem never reaches the fused
kernels, whatever ``ls_fused`` says) and the fixed-buffer route
(``graphed=True`` on the CPU) bit for bit against the eager solve on both
paths. Every input is made from a numpy seed and goes through both
packages.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import altro_tpu as at  # noqa: E402
from altro_tpu.models import rocket as jrocket  # noqa: E402
from altro_tpu.models.quadruped import srb as jsrb  # noqa: E402
from altro_tpu.solver import altro as jaltro  # noqa: E402

import altro_tpu_torch as tt  # noqa: E402
from altro_tpu_torch import convert  # noqa: E402
from altro_tpu_torch.bench.families import OPTS, quadruped_setup  # noqa: E402
from altro_tpu_torch.models import rocket as trocket  # noqa: E402
from altro_tpu_torch.models.quadruped import srb as tsrb  # noqa: E402
from altro_tpu_torch.solver import altro, graph  # noqa: E402

torch.set_num_threads(1)
F64 = torch.float64
N_Q, N_Q_N, N_Q_M = 9, 5, 3          # the pieces' horizon and widths
LANES = 3
ROCKET_N, ROCKET_TF = 41, 10.0
ROCKET_OPTS = dict(cost_tolerance=1e-5, gradient_tolerance=1e-6,
                   constraint_tolerance=1e-4, penalty_initial=1e-2,
                   penalty_scaling=500.0, iterations_outer=40,
                   iterations_inner=100)
SRB_B = 8


def T(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def close(a, b, atol, rtol=0.0):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=rtol)


# ------------------------------------------------------------ the block

def _quad_blocks(on):
    """One quadratic norm block in both packages on the same numpy data
    (per-knot A [N, 2, dim], c, offset, knots 2..N-2)."""
    rng = np.random.default_rng(21)
    dim = N_Q_M if on == "control" else N_Q_N
    A = rng.standard_normal((N_Q, 2, dim))
    c = rng.standard_normal((N_Q, dim))
    kw = dict(c=c, offset=0.7, on=on, start=2, stop=N_Q - 1)
    return (at.quad_norm_constraint(N_Q, N_Q_N, N_Q_M, jnp.asarray(A), **kw),
            tt.quad_norm_constraint(N_Q, N_Q_N, N_Q_M, A, **kw))


def _lanes_xu(seed, B=LANES, N=N_Q, n=N_Q_N, m=N_Q_M):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, N, n)),
            rng.standard_normal((B, N - 1, m)))


@pytest.mark.parametrize("on", ["control", "state"])
def test_quad_norm_pieces_match_jax(on):
    jb, tb = _quad_blocks(on)
    X, U = _lanes_xu(22)
    g = np.abs(np.random.default_rng(23).standard_normal((LANES, N_Q, 1)))
    tX, tU = T(X), T(U)
    got = dict(evaluate=tb.evaluate(tX, tU),
               violations=tb.violations(tX, tU),
               max_violation=tb.max_violation(tX, tU))
    got.update(zip(("Cx", "Cu"), tb.jacobians(tX, tU)))
    got.update(zip(("Hxx", "Huu", "Hux"), tb.second_order(tX, tU, T(g))))
    for b in range(LANES):
        jX, jU = jnp.asarray(X[b]), jnp.asarray(U[b])
        ref = dict(evaluate=jb.evaluate(jX, jU),
                   violations=jb.violations(jX, jU),
                   max_violation=jb.max_violation(jX, jU))
        ref.update(zip(("Cx", "Cu"), jb.jacobians(jX, jU)))
        ref.update(zip(("Hxx", "Huu", "Hux"),
                       jb.second_order(jX, jU, jnp.asarray(g[b]))))
        for k, r in ref.items():
            t = got[k]
            t = t[b] if t.dim() == np.asarray(r).ndim + 1 else t
            close(t, r, 1e-12)
    assert tb.p == 1 and not tb.is_affine
    # a fresh dual state reads the block's mask, not an affine block's Cx
    d = tt.DualState.init(tb, 2.0, batch=(LANES,))
    assert d.lam.shape == (LANES, N_Q, 1) and float(d.rho[0, 0]) == 2.0


def test_al_expansion_with_a_quad_norm_block_matches_jax():
    """The expansion of a problem with an affine SOC block and two active
    quadratic norm blocks (controls and states): per-lane Jacobians and the
    exact curvature, against the JAX package per lane."""
    rng = np.random.default_rng(24)
    jprob = jrocket.rocket_problem(N=N_Q, tf=2.0, conic=False)
    tprob = trocket.rocket_problem(N=N_Q, tf=2.0, conic=False)
    n, m = 6, 3
    X = np.asarray(jprob.x0)[None, None] + rng.standard_normal(
        (LANES, N_Q, n))
    U = np.asarray(jrocket.hover_controls(jprob))[None] + 40.0 * \
        rng.standard_normal((LANES, N_Q - 1, m))
    lams = [np.abs(rng.standard_normal((LANES, N_Q, c.p))) * 50.0
            for c in jprob.constraints]
    rho = 1e2
    tduals = tuple(tt.DualState(lam=T(lam), rho=torch.full((LANES, N_Q),
                                                            rho, dtype=F64))
                   for lam in lams)
    got = altro.al_expansion(dataclasses.replace(tprob, x0=T(X[:, 0])),
                             tduals, T(X), T(U))
    assert got[2].dim() == 4 and got[3].dim() == 4   # per-lane curvature
    for b in range(LANES):
        jd = tuple(at.DualState(lam=jnp.asarray(lam[b]),
                                rho=jnp.full((N_Q,), rho)) for lam in lams)
        ref = jaltro.al_expansion(jprob, jd, jnp.asarray(X[b]),
                                  jnp.asarray(U[b]))
        for t, r in zip(got, ref):
            close(t[b] if t.dim() == r.ndim + 1 else t, r, 1e-10, 1e-12)


# ----------------------------------------------------------- dynamics

def _srb_model(lane_ids):
    """The RK4 SRB model over the flat bench's contact schedules of lanes
    ``lane_ids`` (one schedule per lane of 8), both packages, and states
    and controls near the stance."""
    from altro_tpu_torch.models.quadruped import config
    su = quadruped_setup(SRB_B, True, F64, "cpu", nonlinear=True)
    params = tuple(p[list(lane_ids)] for p in su.prob.dynamics.params)
    return su, params, config.MPCConfig().dynamics_discretization


def _jax_srb_f(dt):
    def f(params, x, u, k):
        return at.rk4(jsrb.continuous_dynamics, x, u, dt, params[0][k],
                      params[1][k])
    return f


@pytest.mark.parametrize("per_lane", [True, False], ids=["per_lane",
                                                         "shared"])
def test_srb_nonlinear_dynamics_match_jax(per_lane):
    su, params, dt = _srb_model([0, 3, 6])
    N = su.prob.N
    if not per_lane:
        params = tuple(p[0] for p in params)
    tdyn = tsrb.nonlinear_dynamics(*params, dt)
    assert tdyn.lane_axes == (per_lane, per_lane) and tdyn.per_lane
    # the JAX params carried across with the port's model function
    conv = convert.nonlinear_dynamics_from_numpy(
        convert.numpy_tree(tuple(jnp.asarray(p.numpy()) for p in params)),
        tsrb.rk4_knot_fn(dt), 12, 12, N, lane_axes=(per_lane, per_lane))
    assert conv.f is tdyn.f and all(
        torch.equal(a, b) for a, b in zip(conv.params, tdyn.params))
    rng = np.random.default_rng(25)
    x0 = su.x_des.numpy()[None] + 0.02 * rng.standard_normal((LANES, 12))
    U = su.U0[:LANES].numpy() + 3.0 * rng.standard_normal((LANES, N - 1, 12))
    X = su.x_des.numpy()[None, None] + 0.02 * rng.standard_normal(
        (LANES, N, 12))
    jf = _jax_srb_f(dt)
    jparams = tuple(jnp.asarray(p.numpy()) for p in params)

    def j_one(p, x0_b, X_b, U_b):
        d = at.NonlinearDynamics(f=jf, params=p, n_=12, m_=12, N_=N)
        return (d.step(x0_b, U_b[0], 3), d.rollout(x0_b, U_b),
                d.linearize(X_b, U_b))
    p_axes = (0, 0) if per_lane else (None, None)
    jstep, jroll, jlin = jax.jit(jax.vmap(j_one, in_axes=(p_axes, 0, 0, 0)))(
        jparams, jnp.asarray(x0), jnp.asarray(X), jnp.asarray(U))
    close(tdyn.step(T(x0), T(U[:, 0]), 3), jstep, 1e-10)
    close(tdyn.rollout(T(x0), T(U)), jroll, 1e-10)
    for t, r in zip(tdyn.linearize(T(X), T(U)), jlin):
        close(t, r, 1e-10)
    # rk4 alone on the continuous model of lane 0's knot 5
    p0 = tuple(p[0] if per_lane else p for p in params)
    close(tt.rk4(tsrb.continuous_dynamics, T(X[0, 5]), T(U[0, 5]), dt,
                 p0[0][5], p0[1][5]),
          at.rk4(jsrb.continuous_dynamics, jnp.asarray(X[0, 5]),
                 jnp.asarray(U[0, 5]), dt, jnp.asarray(p0[0][5].numpy()),
                 jnp.asarray(p0[1][5].numpy())), 1e-12)


def test_rollout_closed_loop_matches_jax():
    """Both dynamics kinds, every rung of a ladder with alpha = 0 last,
    against the JAX package's single-alpha rollout per lane; the alpha = 0
    rung started on a trajectory of this rollout reproduces it bit for
    bit."""
    alphas = (1.0, 0.5, 0.25, 0.0)
    rng = np.random.default_rng(26)
    su, params, dt = _srb_model([1, 4, 7])
    # the first 7 knots of each schedule: over the whole horizon an
    # open-loop perturbation of the stance forces spins some bodies to
    # overflow
    N = 7
    params = tuple(p[:, :N] for p in params)
    nl = (tsrb.nonlinear_dynamics(*params, dt),
          lambda b: at.NonlinearDynamics(
              f=_jax_srb_f(dt), params=tuple(jnp.asarray(p[b].numpy())
                                             for p in params),
              n_=12, m_=12, N_=N),
          su.x_des.numpy(), su.U0[0, 0].numpy(), 12, 12, 0.02, 0.5, 0.01)
    jr = jrocket.rocket_problem(N=N_Q, tf=2.0)
    tr = trocket.rocket_problem(N=N_Q, tf=2.0)
    ltv = (tr.dynamics, lambda b: jr.dynamics, np.asarray(jr.x0),
           np.asarray(jrocket.hover_controls(jr))[0], 6, 3, 0.5, 20.0,
           0.1)
    for tdyn, jdyn, xc, uc, n, m, sx, su_, sk in (nl, ltv):
        Nk = tdyn.N
        Xbar = xc + sx * rng.standard_normal((LANES, Nk, n))
        Ubar = uc + su_ * rng.standard_normal((LANES, Nk - 1, m))
        K = sk * rng.standard_normal((LANES, Nk - 1, m, n))
        d = su_ * rng.standard_normal((LANES, Nk - 1, m))
        Xs, Us = altro.rollout_closed_loop(tdyn, T(Xbar), T(Ubar), T(K),
                                           T(d), alphas)
        assert Xs.shape == (LANES, len(alphas), Nk, n)
        for b in range(LANES):
            for i, a in enumerate(alphas):
                jX, jU = jaltro.rollout_closed_loop(
                    jdyn(b), jnp.asarray(Xbar[b]), jnp.asarray(Ubar[b]),
                    jnp.asarray(K[b]), jnp.asarray(d[b]), a)
                close(Xs[b, i], jX, 1e-12, 1e-12)
                close(Us[b, i], jU, 1e-12, 1e-12)
        # alpha = 0 on a trajectory of this rollout: the same bits
        X1, U1 = Xs[:, 0].contiguous(), Us[:, 0].contiguous()
        assert bool(torch.isfinite(X1).all())
        Xr, Ur = altro.rollout_closed_loop(tdyn, X1, U1, T(K), T(d),
                                           alphas)
        assert torch.equal(Xr[:, -1], X1) and torch.equal(Ur[:, -1], U1)


# --------------------------------------------------------------- solves

def _binding_problems():
    """A random LTI model with ||u|| <= 0.3 binding, as the SOC block and as
    the quadratic norm block, both packages: the data of the JAX package's
    test_quad_norm_binds_like_soc (its PRNG keys 4 and 5), taken to numpy
    and given to both."""
    n, m, N = 4, 2, 21
    A = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (n, n))
                   * 0.3 + jnp.eye(n) * 0.7)
    B = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (n, m)) * 0.5)
    x0 = np.full(n, 3.0)
    bnd = 0.3
    jdyn = at.lti_dynamics(jnp.asarray(A), jnp.asarray(B), N)
    jcost = at.lqr_objective(jnp.eye(n), jnp.eye(m) * 1e-3,
                             jnp.eye(n) * 10, jnp.zeros(n), N)
    jnaive = at.Problem(dynamics=jdyn, cost=jcost, x0=jnp.asarray(x0),
                        constraints=(at.quad_norm_constraint(
                            N, n, m, jnp.eye(m), offset=bnd),))
    tdyn = tt.lti_dynamics(T(A), T(B), N)
    tcost = tt.lqr_objective(torch.eye(n, dtype=F64),
                             torch.eye(m, dtype=F64) * 1e-3,
                             torch.eye(n, dtype=F64) * 10,
                             torch.zeros(n, dtype=F64), N)
    kw = dict(dynamics=tdyn, cost=tcost, x0=T(x0)[None])
    tnaive = tt.Problem(constraints=(tt.quad_norm_constraint(
        N, n, m, torch.eye(m, dtype=F64), offset=bnd),), **kw)
    tsoc = tt.Problem(constraints=(tt.norm_constraint(
        N, n, m, bnd, dtype=F64),), **kw)
    return jnaive, tnaive, tsoc, bnd


def test_quad_norm_binds_like_soc():
    jnaive, tnaive, tsoc, bnd = _binding_problems()
    kw = dict(constraint_tolerance=1e-8, cost_tolerance=1e-8,
              gradient_tolerance=1e-10, penalty_initial=1e2,
              penalty_scaling=10.0, iterations_outer=40)
    jsol = jax.jit(at.solve)(jnaive, at.SolverOptions(**kw))
    sol = altro.solve(tnaive, tt.SolverOptions(**kw))
    ssoc = altro.solve(tsoc, tt.SolverOptions(**kw))
    assert int(sol.stats.status[0]) == int(jsol.stats.status) == 1
    assert int(sol.stats.iterations[0]) == int(jsol.stats.iterations)
    close(sol.U[0], jsol.U, 1e-8)
    assert int(ssoc.stats.status[0]) == 1
    close(sol.U, ssoc.U, 1e-4)
    assert float(torch.linalg.vector_norm(sol.U, dim=-1).max()) <= bnd + 1e-6


def _naive_rocket(B_x0):
    jprob = jrocket.rocket_problem(N=ROCKET_N, tf=ROCKET_TF, conic=False)
    tprob = convert.problem_from_numpy(convert.numpy_tree(jprob))
    return jprob, dataclasses.replace(tprob, x0=T(B_x0))


def _rocket_x0s():
    x0 = np.array([4.0, 2.0, 20.0, -3.0, 2.0, -5.0])
    return np.stack([x0, x0 + 0.5 * np.random.default_rng(0)
                     .standard_normal(6)])


def test_naive_rocket_matches_jax():
    """The naive rocket at N=41, tf=10 from the hover warm start, the
    default x0 and a perturbed one: equal status and iterations, U within
    1e-8 (the JAX package takes 66 and 133 iterations); the converted
    problem's blocks evaluate as the JAX package's, and the port's own
    conic=False builder gives the same problem."""
    x0s = _rocket_x0s()
    jprob, tprob = _naive_rocket(x0s)
    own = trocket.rocket_problem(N=ROCKET_N, tf=ROCKET_TF, conic=False)
    assert [type(c).__name__ for c in own.constraints] == [
        "ConicConstraint"] + ["QuadNormConstraint"] * 3
    X, U = _lanes_xu(28, 2, ROCKET_N, 6, 3)
    for c_own, c_conv, c_j in zip(own.constraints, tprob.constraints,
                                  jprob.constraints):
        ref = c_j.evaluate(jnp.asarray(X[1]), jnp.asarray(U[1]))
        close(c_conv.evaluate(T(X), T(U))[1], ref, 1e-12)
        close(c_own.evaluate(T(X), T(U))[1], ref, 1e-12)
    u0 = jrocket.hover_controls(jprob)
    jopts = at.SolverOptions(**ROCKET_OPTS)

    def one(x0):
        s = at.solve(jprob.replace(x0=x0), jopts, U0=u0)
        return s.U, s.stats.status, s.stats.iterations
    jU, js, ji = jax.jit(jax.vmap(one))(jnp.asarray(x0s))
    U0 = T(np.asarray(u0))[None].expand(2, -1, -1).contiguous()
    sol = altro.solve(tprob, tt.SolverOptions(**ROCKET_OPTS), U0=U0)
    assert sol.stats.status.tolist() == np.asarray(js).tolist() == [1, 1]
    assert sol.stats.iterations.tolist() == np.asarray(ji).tolist()
    close(sol.U, jU, 1e-8)


def _srb_problem():
    su = quadruped_setup(SRB_B, True, F64, "cpu", nonlinear=True)
    return su, dataclasses.replace(su.prob, x0=su.draw_x0())


def test_srb_nonlinear_solve_matches_jax():
    """The nonlinear SRB trot at B=8 (one lane per contact schedule, QP
    friction) from the stance forces and the reference states, against
    ``jax.vmap`` of the JAX package's solve of the same RK4 model: equal
    status and iterations, U within 1e-8."""
    from altro_tpu.models.quadruped import config as jconfig
    from altro_tpu.models.quadruped import controller as jcontroller
    su, tprob = _srb_problem()
    cfg = jconfig.MPCConfig(linearized_friction=True)
    jprob, _ = jcontroller.build_mpc_problem(cfg, jnp.float64)
    jf = _jax_srb_f(cfg.dynamics_discretization)
    jopts = at.SolverOptions(**OPTS)
    N = cfg.N

    def one(fl, ct, x0, X0):
        dyn = at.NonlinearDynamics(f=jf, params=(fl, ct), n_=12, m_=12,
                                   N_=N)
        s = at.solve(jprob.replace(dynamics=dyn, x0=x0), jopts,
                     U0=jnp.asarray(su.U0[0].numpy()), X0=X0)
        return s.U, s.stats.status, s.stats.iterations
    jU, js, ji = jax.jit(jax.vmap(one))(
        *(jnp.asarray(p.numpy()) for p in tprob.dynamics.params),
        jnp.asarray(tprob.x0.numpy()), jnp.asarray(su.X0.numpy()))
    # the JAX problem converts with the model given (its function is code)
    jtree = convert.numpy_tree(jprob.replace(dynamics=at.NonlinearDynamics(
        f=jf, params=(), n_=12, m_=12, N_=N)))
    with pytest.raises(ValueError, match="nonlinear"):
        convert.problem_from_numpy(jtree)
    conv = convert.problem_from_numpy(jtree, dynamics=tprob.dynamics)
    assert conv.dynamics is tprob.dynamics
    for a, b in zip(graph.tensors(conv.cost), graph.tensors(tprob.cost)):
        close(a, b.numpy(), 1e-12)
    sol = altro.solve(tprob, su.opts, U0=su.U0, X0=su.X0)
    assert sol.stats.status.tolist() == np.asarray(js).tolist()
    assert int(sol.stats.status.sum()) == SRB_B
    assert sol.stats.iterations.tolist() == np.asarray(ji).tolist()
    close(sol.U, jU, 1e-8, 1e-9)


# -------------------------------------------------------------- routing

@pytest.mark.parametrize("ls_fused", ["on", "auto"])
@pytest.mark.parametrize("path", ["naive_rocket", "srb"])
def test_non_affine_and_nonlinear_never_reach_the_fused_kernels(
        monkeypatch, path, ls_fused):
    def refuse(*a, **k):
        raise AssertionError("a fused kernel was called")
    monkeypatch.setattr(altro, "fused_expand_backward", refuse)
    monkeypatch.setattr(altro, "batched_ls_rollout_al", refuse)
    if path == "naive_rocket":
        jprob, prob = _naive_rocket(_rocket_x0s()[:1])
        kw, U0, X0 = ROCKET_OPTS, T(np.asarray(jrocket.hover_controls(
            jprob)))[None], None
    else:
        su, prob = _srb_problem()
        kw, U0, X0 = OPTS, su.U0, su.X0
    opts = tt.SolverOptions(**dict(kw, ls_fused=ls_fused))
    assert not altro.ltv_affine(prob)
    assert not altro._uses_fused_ladder(opts, prob, prob.x0)
    ctx = altro.loop_context(prob, opts, U0)
    assert ctx.packed is None
    state = altro.solve_partial(prob, opts, U0=U0, X0=X0, it_cap=3)
    assert int(state[8].max()) == 3
    # the affine conic rocket does take them on "on"
    conic = trocket.rocket_problem(N=ROCKET_N, tf=ROCKET_TF)
    assert altro.ltv_affine(conic)
    assert altro._uses_fused_ladder(
        tt.SolverOptions(ls_fused="on"), conic, conic.x0)


@pytest.mark.parametrize("path", ["naive_rocket", "srb"])
def test_fixed_buffer_route_equals_eager(path):
    """``GraphedSolve`` on the CPU (the same functions over the same
    buffers, no capture) gives the eager solve's bits."""
    if path == "naive_rocket":
        jprob, prob = _naive_rocket(_rocket_x0s()[:1])
        opts = tt.SolverOptions(**ROCKET_OPTS)
        U0 = T(np.asarray(jrocket.hover_controls(jprob)))[None]
        X0 = None
    else:
        su, prob = _srb_problem()
        opts, U0, X0 = su.opts, su.U0, su.X0
    eager = altro.solve(prob, opts, U0=U0, X0=X0)
    gs = graph.GraphedSolve(prob, opts, states=X0 is not None)
    # a second call reloads every buffer (once on the slower SRB)
    for _ in range(2 if X0 is None else 1):
        fixed = gs(prob.x0, U0, X0)
        for a, b in ((fixed.X, eager.X), (fixed.U, eager.U),
                     (fixed.stats.iterations, eager.stats.iterations),
                     (fixed.stats.status, eager.stats.status)):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="states"):
        gs(prob.x0, U0, None if X0 is not None else prob.x0)
