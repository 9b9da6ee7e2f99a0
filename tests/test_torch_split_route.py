"""The split route on shared dynamics against the JAX package in float64 on
the CPU: ``make_mpc_step(shared_k=False)`` (per-lane window indices, a
per-lane cost) against ``jax.vmap`` of the JAX package's default step with
lanes at different start windows; solves with the fused expansion off
(``SolverOptions.fused_expansion``) against the JAX package under
ALTRO_TPU_FUSED=0 on a rocket and a grasp problem; the per-lane cost's
``total`` and ``expansion`` against ``vmap`` of the JAX ones; and the small
pieces (``stage_terms``, ``euler_discretize``, ``total_al_cost``,
``al_expansion``, ``check_status``, ``print_summary``).
"""
import contextlib
import dataclasses
import io
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import altro_tpu as at  # noqa: E402
from altro_tpu import costs as jcosts  # noqa: E402
from altro_tpu.models import grasp as jgrasp  # noqa: E402
from altro_tpu.models import random_linear as jrl  # noqa: E402
from altro_tpu.models import rocket as jrocket  # noqa: E402
from altro_tpu.mpc import make_mpc_step as j_make_mpc_step  # noqa: E402
from altro_tpu.mpc import track_window as j_track_window  # noqa: E402
from altro_tpu.solver import altro as jaltro  # noqa: E402

import altro_tpu_torch as tt  # noqa: E402
from altro_tpu_torch import convert  # noqa: E402
from altro_tpu_torch.costs import retarget_tracking  # noqa: E402
from altro_tpu_torch.dynamics import euler_discretize  # noqa: E402
from altro_tpu_torch.models import grasp as tgrasp  # noqa: E402
from altro_tpu_torch.mpc import make_mpc_step, track_window  # noqa: E402
from altro_tpu_torch.ops import riccati, riccati_fused  # noqa: E402
from altro_tpu_torch.solver import altro  # noqa: E402
from altro_tpu_torch.solver.graph import tensors  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-8
TIGHT = 1e-12


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=atol,
                               rtol=0)


FLAG_KW = dict(cost_tolerance=1e-4, gradient_tolerance=1e-4,
               constraint_tolerance=1e-4, penalty_initial=1e3,
               penalty_scaling=100.0, iterations_linesearch=2)


def _flagship(n=6, m=3, N_mpc=11, T=4, B=4, seed=1):
    rng = np.random.default_rng(seed)
    N_track = N_mpc + T + B + 2
    prob = jrl.gen_random_linear(rng, n, m, N_track)
    X_track, U_track = jrl.gen_trajectory(rng, prob, N_track)
    prob_mpc = jrl.gen_tracking_mpc(prob, X_track, U_track, N_mpc)
    return prob_mpc, X_track, U_track, rng.standard_normal((T, B, n))


def _torch(prob_mpc, X_track, U_track):
    return (convert.problem_from_numpy(convert.numpy_tree(prob_mpc)),
            torch.tensor(np.asarray(X_track)),
            torch.tensor(np.asarray(U_track)))


@pytest.mark.parametrize("early_tol", [0.0, 1e-3],
                         ids=["classic", "early_exact"])
def test_lane_step_matches_jax_vmap(early_tol):
    """B=4 lanes started at windows 0-3, four steps of the flagship's
    options: every lane-step's status and iterations equal, X/U/x0/viol
    within 1e-8, the carried window indices equal; the split route ran
    (kernel B's wrapper never called)."""
    T, B = 4, 4
    prob_mpc, X_track, U_track, noise = _flagship(T=T, B=B)
    kw = dict(FLAG_KW, early_exact_tol=early_tol)
    jstep, jinit = j_make_mpc_step(prob_mpc, at.SolverOptions(**kw), X_track,
                                   U_track)
    vstep = jax.jit(jax.vmap(jstep))
    jcarry = jax.vmap(jinit)(jnp.arange(B))

    tp, X_t, U_t = _torch(prob_mpc, X_track, U_track)
    tstep, tinit = make_mpc_step(tp, tt.SolverOptions(**kw), X_t, U_t,
                                 shared_k=False)
    tcarry = tinit(B, torch.arange(B))
    assert tcarry[4].dtype == torch.int64
    close(tcarry[1], jcarry[1])
    fused0 = riccati_fused.launch_count
    for t in range(T):
        jcarry, jout = vstep(jcarry, jnp.asarray(noise[t]))
        tcarry, tout = tstep(tcarry, torch.as_tensor(noise[t]))
        assert tout.iters.tolist() == np.asarray(jout.iters).tolist(), t
        assert tout.status.tolist() == np.asarray(jout.status).tolist(), t
        assert int(tout.status.sum()) == B
        for k in ("X", "U", "viol", "x0"):
            close(getattr(tout, k), getattr(jout, k))
        assert tcarry[4].tolist() == np.asarray(jcarry[4]).tolist()
    assert riccati_fused.launch_count == fused0


def test_lane_step_fixed_buffers_equal_eager():
    """The graphed form's route on the CPU (the same functions over fixed
    buffers, per-lane cost tensors among them) equals the host-driven step
    bit for bit, lanes at different windows; an int start index and a
    constraints_fn are handled as documented (one that returns the
    problem's own shared blocks changes no bit of the step)."""
    T, B = 3, 4
    prob_mpc, X_track, U_track, noise = _flagship(T=T, B=B, seed=2)
    tp, X_t, U_t = _torch(prob_mpc, X_track, U_track)
    opts = tt.SolverOptions(**FLAG_KW)
    forms = {g: make_mpc_step(tp, opts, X_t, U_t, shared_k=False, graphed=g)
             for g in (False, True)}
    carry0 = forms[False][1](B, torch.tensor([3, 0, 1, 2]))
    for g in (False, True):
        carry = carry0
        for t in range(T):
            carry, out = forms[g][0](carry, torch.as_tensor(noise[t]))
        forms[g] = (carry, out)
    (ce, oe), (cg, og) = forms[False], forms[True]
    for x, y in zip(tensors(ce), tensors(cg)):
        assert torch.equal(x, y)
    assert ce[4].tolist() == [6, 3, 4, 5]
    assert torch.equal(oe.iters, og.iters) and torch.equal(oe.U, og.U)
    step, init = make_mpc_step(tp, opts, X_t, U_t, shared_k=False)
    assert init(2, 5)[4].tolist() == [5, 5]
    seen = []

    def same_blocks(k):
        seen.append(k)
        return tp.constraints

    cstep, _ = make_mpc_step(tp, opts, X_t, U_t, shared_k=False,
                             constraints_fn=same_blocks)
    nz = torch.as_tensor(noise[0])
    (c1, o1), (c2, o2) = step(carry0, nz), cstep(carry0, nz)
    assert seen[0].tolist() == [4, 1, 2, 3]
    for x, y in zip(tensors(c1), tensors(c2)):
        assert torch.equal(x, y)
    assert torch.equal(o1.iters, o2.iters)


def test_track_window_per_lane_clamps_like_dynamic_slice():
    prob_mpc, X_track, U_track, _ = _flagship()
    _, X_t, U_t = _torch(prob_mpc, X_track, U_track)
    ks = [0, 3, len(X_track) - 11, len(X_track) - 5, 100]
    Xw, Uw = track_window(X_t, U_t, torch.tensor(ks), 11)
    assert Xw.shape == (len(ks), 11, 6) and Uw.shape == (len(ks), 10, 3)
    for i, k in enumerate(ks):
        jX, jU = j_track_window(X_track, U_track, jnp.asarray(k), 11)
        close(Xw[i], jX, 0.0)
        close(Uw[i], jU, 0.0)
        sX, sU = track_window(X_t, U_t, k, 11)
        assert torch.equal(Xw[i], sX) and torch.equal(Uw[i], sU)


def _split_solve(jprob, tprob, x0s, kw, U0):
    """The JAX package's vmapped solve under ALTRO_TPU_FUSED=0 and the
    port's with ``fused_expansion=False``; the port's fused route on the
    CPU (the plain version of kernel B) too."""
    import os
    os.environ["ALTRO_TPU_FUSED"] = "0"
    try:
        jsol = jax.jit(jax.vmap(lambda x0: at.solve(
            jprob.replace(x0=x0), at.SolverOptions(**kw), U0=U0)))(
                jnp.asarray(x0s))
    finally:
        del os.environ["ALTRO_TPU_FUSED"]
    tp = dataclasses.replace(tprob, x0=torch.as_tensor(x0s))
    U0t = torch.tensor(np.asarray(U0)).expand(len(x0s), -1, -1).contiguous()
    tsol = {f: tt.solve(tp, tt.SolverOptions(**kw, fused_expansion=f),
                        U0=U0t) for f in (False, True)}
    return jsol, tsol


def _check_split(jsol, tsol):
    sp = tsol[False]
    assert sp.stats.status.tolist() == np.asarray(jsol.stats.status).tolist()
    assert int(sp.stats.status.sum()) == sp.stats.status.numel()
    assert (sp.stats.iterations.tolist()
            == np.asarray(jsol.stats.iterations).tolist())
    for k in ("X", "U"):
        close(getattr(sp, k), getattr(jsol, k))
    # on the CPU both routes run the same plain arithmetic
    for k in ("X", "U", "K"):
        assert torch.equal(getattr(sp, k), getattr(tsol[True], k))


@pytest.mark.parametrize("ls_fused", ["off", "on"])
def test_split_route_rocket_matches_jax(ls_fused):
    """The rocket's N_mpc=21 window (three SOC blocks) tracking the hover
    controls' rollout of the N=41 problem over 6 s, B=3 perturbed initial
    states, the benchmark's warm options."""
    from altro_tpu.mpc import gen_tracking_mpc as j_gen
    from altro_tpu_torch.bench.conic import WARM_OPTS
    jp = jrocket.rocket_problem(N=41, tf=6.0)
    U_tr = jrocket.hover_controls(jp)
    X_tr = jp.dynamics.rollout(jp.x0, U_tr)
    jw = j_gen(jp, X_tr, U_tr, 21, dt=0.05)
    tw = convert.problem_from_numpy(convert.numpy_tree(jw))
    rng = np.random.default_rng(3)
    x0s = np.asarray(jw.x0) + 0.05 * rng.standard_normal((3, 6))
    d0 = riccati.launch_count
    jsol, tsol = _split_solve(jw, tw, x0s, dict(WARM_OPTS, ls_fused=ls_fused),
                              U_tr[:20])
    assert riccati.launch_count == d0       # the CPU takes the plain version
    _check_split(jsol, tsol)


def test_split_route_grasp_matches_jax():
    """Grasp at N=21 over 2 s (goal and torque balance ZERO, max force
    NONPOS, two SOC friction cones), B=3 perturbed initial states."""
    N, tf = 21, 2.0
    kw = dict(cost_tolerance=1e-6, gradient_tolerance=1e-8,
              constraint_tolerance=1e-6, penalty_initial=10.0,
              penalty_scaling=10.0, iterations_outer=30)
    jo = jgrasp.make_grasp_object(N, tf)
    to = tgrasp.make_grasp_object(N, tf)
    jp = jgrasp.grasp_problem(jo, N, tf)
    tp = tgrasp.grasp_problem(to, N, tf)
    rng = np.random.default_rng(4)
    x0s = np.asarray(jp.x0) + 0.01 * rng.standard_normal((3, 6))
    jsol, tsol = _split_solve(jp, tp, x0s, kw, jgrasp.hover_controls(jo, N))
    _check_split(jsol, tsol)


def _lane_cost(B=3, seed=5):
    prob_mpc, X_track, U_track, _ = _flagship(seed=seed)
    rng = np.random.default_rng(seed)
    ks = jnp.asarray(rng.integers(0, 6, B))
    N = prob_mpc.N
    jw = jax.vmap(lambda k: j_track_window(X_track, U_track, k, N))(ks)
    jc = jax.vmap(lambda X, U: jcosts.retarget_tracking(prob_mpc.cost, X, U))(
        *jw)
    tp, _, _ = _torch(prob_mpc, X_track, U_track)
    tc = retarget_tracking(tp.cost, *(torch.tensor(np.asarray(a))
                                      for a in jw))
    X = rng.standard_normal((B, N, 6))
    U = rng.standard_normal((B, N - 1, 3))
    return prob_mpc, jc, tc, X, U


def test_per_lane_cost_matches_vmap():
    """``retarget_tracking`` of per-lane windows, then ``total`` and
    ``expansion`` on [B] trajectories and on a [B, L] ladder, against
    ``vmap`` of the JAX functions, within 1e-12."""
    _, jc, tc, X, U = _lane_cost()
    assert tc.per_lane and tc.q.shape == (3,) + tuple(jc.q.shape[1:])
    for k in ("q", "r", "c"):
        close(getattr(tc, k), getattr(jc, k), TIGHT)
    close(tc.Q, jc.Q[0], 0.0)
    total = jax.vmap(lambda c, X, U: c.total(X, U))(jc, X, U)
    close(tc.total(torch.as_tensor(X), torch.as_tensor(U)), total, TIGHT)
    jexp = jax.vmap(lambda c, X, U: c.expansion(X, U))(jc, X, U)
    texp = tc.expansion(torch.as_tensor(X), torch.as_tensor(U))
    for a, b in zip(texp[:2], jexp[:2]):
        close(a, b, TIGHT)
    for a, b in zip(texp[2:], jexp[2:]):
        close(a, b[0], 0.0)
    # a ladder of L=2 rungs per lane: [B, L, N, n]
    XL, UL = np.stack([X, 2 * X], 1), np.stack([U, -U], 1)
    totL = jax.vmap(lambda c, X, U: jax.vmap(c.total)(X, U))(jc, XL, UL)
    close(tc.total(torch.as_tensor(XL), torch.as_tensor(UL)), totL, TIGHT)
    stage = jax.vmap(lambda c, x, u: c.stage_terms(x, u, 4))(
        jc, X[:, 4], U[:, 4])
    close(tc.stage_terms(torch.as_tensor(X[:, 4]), torch.as_tensor(U[:, 4]),
                         4), stage, TIGHT)


def test_stage_terms_and_euler_match_jax():
    prob_mpc, X_track, U_track, _ = _flagship()
    tp, _, _ = _torch(prob_mpc, X_track, U_track)
    rng = np.random.default_rng(6)
    x, u = rng.standard_normal(6), rng.standard_normal(3)
    for k in (0, 5, prob_mpc.N - 1):
        close(tp.cost.stage_terms(torch.as_tensor(x), torch.as_tensor(u), k),
              prob_mpc.cost.stage_terms(x, u, k), TIGHT)
    A, B, d = (rng.standard_normal(s) for s in ((6, 6), (6, 3), (6,)))
    for dd in (d, None):
        got = euler_discretize(torch.as_tensor(A), torch.as_tensor(B), 0.05,
                               None if dd is None else torch.as_tensor(dd))
        for a, b in zip(got, at.euler_discretize(A, B, 0.05, dd)):
            close(a, b, TIGHT)


def test_al_cost_expansion_and_status_match_jax():
    """``total_al_cost`` and ``al_expansion`` on a bound-constrained
    flagship window with nonzero multipliers (rows on both sides of the
    kink) against the JAX functions vmapped over lanes; ``check_status``
    and ``print_summary`` on a solve's statistics."""
    prob_mpc, X_track, U_track, _ = _flagship()
    tp, _, _ = _torch(prob_mpc, X_track, U_track)
    rng = np.random.default_rng(7)
    B, N = 3, prob_mpc.N
    X = 2.0 * rng.standard_normal((B, N, 6))
    U = 3.0 * rng.standard_normal((B, N - 1, 3))
    jduals = tuple(
        at.DualState(lam=jnp.asarray(rng.uniform(0, 2, (B,) + d.lam.shape)),
                     rho=jnp.full((B,) + d.rho.shape, 50.0))
        for d in prob_mpc.init_duals(1.0))
    tduals = convert.duals_from_numpy(convert.numpy_tree(jduals))
    Xt, Ut = torch.as_tensor(X), torch.as_tensor(U)
    jJ = jax.vmap(lambda d, X, U: jaltro.total_al_cost(prob_mpc, d, X, U))(
        jduals, X, U)
    close(altro.total_al_cost(tp, tduals, Xt, Ut), jJ, TIGHT)
    jexp = jax.vmap(lambda d, X, U: jaltro.al_expansion(prob_mpc, d, X, U))(
        jduals, X, U)
    for a, b in zip(altro.al_expansion(tp, tduals, Xt, Ut), jexp):
        close(a, b, TIGHT)

    sol = tt.solve(dataclasses.replace(tp, x0=torch.as_tensor(X[:, 0])),
                   tt.SolverOptions(**FLAG_KW))
    jstats = jaltro.Stats(**{f.name: np.asarray(getattr(sol.stats, f.name))
                             for f in dataclasses.fields(sol.stats)})
    with _no_warning():
        assert altro.check_status(sol.stats) == jaltro.check_status(jstats)
    failed = dataclasses.replace(sol.stats, status=torch.tensor([1, 0, 0]))
    with pytest.warns(UserWarning, match="2 unsuccessful solve"):
        assert not altro.check_status(failed, "a test")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        altro.print_summary(sol)
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == B and all("SOLVE_SUCCEEDED" in s for s in lines)


@contextlib.contextmanager
def _no_warning():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        yield
