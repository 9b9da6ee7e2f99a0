"""The slice as a whole against the JAX package in float64: a cold solve of
a bound-constrained LQR problem (same iterations and status, X/U/K to
atol 1e-8), the warm-started random-linear MPC step with shared_k=True
(per-step iterations and status equal, X/U/viol to atol 1e-8) and the
closed loop ``run_mpc`` of two lanes against the JAX package's run of each
lane (the same)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import altro_tpu as at  # noqa: E402
from altro_tpu.models import random_linear as jrl  # noqa: E402
from altro_tpu.mpc import make_mpc_step as j_make_mpc_step  # noqa: E402
from altro_tpu.mpc import run_mpc as j_run_mpc  # noqa: E402

import altro_tpu_torch as tt  # noqa: E402
from altro_tpu_torch import convert  # noqa: E402
from altro_tpu_torch.mpc import (_xws_corrector, gen_tracking_mpc,  # noqa: E402
                                 make_mpc_step, run_mpc, shift_fill)
from altro_tpu_torch.ops import riccati_fused, rollout  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-8


def close(t, j):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=ATOL, rtol=0)


def _lqr_problem(n=4, m=2, N=15):
    rng = np.random.default_rng(5)
    A = 0.3 * rng.standard_normal((n, n)) + 0.7 * np.eye(n)
    B = 0.5 * rng.standard_normal((n, m))
    dyn = at.lti_dynamics(jnp.asarray(A), jnp.asarray(B), N)
    cost = at.lqr_objective(jnp.eye(n), 0.1 * jnp.eye(m), 5.0 * jnp.eye(n),
                            jnp.zeros(n), N)
    cons = (at.bound_constraint(N, n, m, u_min=-1.0, u_max=1.0,
                                dtype=jnp.float64),)
    x0s = 2.0 * rng.standard_normal((4, n))
    return at.Problem(dynamics=dyn, cost=cost, constraints=cons,
                      x0=jnp.asarray(x0s[0])), x0s


@pytest.mark.parametrize("batched", [False, True], ids=["single", "vmapped"])
def test_cold_solve_matches_jax(batched):
    jprob, x0s = _lqr_problem()
    opts = dict(penalty_initial=1e2, penalty_scaling=10.0)
    if batched:
        jsol = jax.jit(jax.vmap(lambda x0: at.solve(
            jprob.replace(x0=x0), at.SolverOptions(**opts))))(jnp.asarray(x0s))
    else:
        x0s = x0s[:1]
        jsol = jax.tree_util.tree_map(lambda a: a[None],
                                      at.solve(jprob, at.SolverOptions(**opts)))
    tprob = dataclasses.replace(convert.problem_from_numpy(
        convert.numpy_tree(jprob)), x0=torch.as_tensor(x0s))
    counts = (rollout.launch_count, riccati_fused.launch_count)
    tsol = tt.solve(tprob, tt.SolverOptions(**opts))
    assert (rollout.launch_count, riccati_fused.launch_count) == counts
    assert tsol.stats.status.tolist() == np.asarray(jsol.stats.status).tolist()
    assert int(tsol.stats.status.sum()) == len(x0s)
    assert (tsol.stats.iterations.tolist()
            == np.asarray(jsol.stats.iterations).tolist())
    assert (tsol.stats.outer_iterations.tolist()
            == np.asarray(jsol.stats.outer_iterations).tolist())
    for k in ("X", "U"):
        close(getattr(tsol, k), getattr(jsol, k))
    # The final gains are taken at a converged iterate whose bound residuals
    # sit on the projection kink: there the JAX package's own single and
    # vmapped solves differ by 1.6e-7 in K on these lanes, so the batched
    # comparison allows that much; the single solve is held to ATOL.
    np.testing.assert_allclose(tsol.K.numpy(), np.asarray(jsol.K), rtol=0,
                               atol=1e-6 if batched else ATOL)
    close(tsol.stats.viol, jsol.stats.viol)
    close(tsol.duals[0].lam, jsol.duals[0].lam)


def _mpc_setup(n=6, m=3, N_mpc=11, T=5, B=4, seed=1):
    rng = np.random.default_rng(seed)
    N_track = N_mpc + T + 2
    prob = jrl.gen_random_linear(rng, n, m, N_track)
    X_track, U_track = jrl.gen_trajectory(rng, prob, N_track)
    prob_mpc = jrl.gen_tracking_mpc(prob, X_track, U_track, N_mpc)
    noise = rng.standard_normal((T, B, n))
    return prob_mpc, X_track, U_track, noise


@pytest.mark.parametrize("early_tol", [0.0, 1e-3], ids=["classic", "early_exact"])
def test_mpc_steps_match_jax(early_tol):
    """Flagship options (penalty 1e3 x100, an L=2 ladder) with and without
    the exact-step early stop."""
    T, B = 5, 4
    prob_mpc, X_track, U_track, noise = _mpc_setup(T=T, B=B)
    kw = dict(cost_tolerance=1e-4, gradient_tolerance=1e-4,
              constraint_tolerance=1e-4, penalty_initial=1e3,
              penalty_scaling=100.0, iterations_linesearch=2,
              early_exact_tol=early_tol)
    jstep, jinit = j_make_mpc_step(prob_mpc, at.SolverOptions(**kw), X_track,
                                   U_track, shared_k=True)
    vstep = jax.jit(jax.vmap(jstep, in_axes=(0, 0, None)))
    jcarry = jax.vmap(lambda _: jinit())(jnp.arange(B))

    tstep, tinit = make_mpc_step(
        convert.problem_from_numpy(convert.numpy_tree(prob_mpc)),
        tt.SolverOptions(**kw), torch.tensor(np.asarray(X_track)),
        torch.tensor(np.asarray(U_track)), shared_k=True)
    tcarry = tinit(B)
    close(tcarry[1], jcarry[1])
    for t in range(T):
        jcarry, jout = vstep(jcarry, jnp.asarray(noise[t]),
                             jnp.asarray(t, jnp.int32))
        tcarry, tout = tstep(tcarry, torch.as_tensor(noise[t]), t)
        assert tout.iters.tolist() == np.asarray(jout.iters).tolist(), t
        assert tout.status.tolist() == np.asarray(jout.status).tolist(), t
        assert int(tout.status.sum()) == B
        for k in ("X", "U", "viol", "x0"):
            close(getattr(tout, k), getattr(jout, k))


@pytest.mark.parametrize("start_k", [0, 2])
def test_run_mpc_matches_jax_per_lane(start_k):
    """3 closed-loop steps on 2 lanes from window ``start_k`` on, each lane
    against the JAX package's ``run_mpc`` of that lane's noise."""
    T, B = 3, 2
    prob_mpc, X_track, U_track, noise = _mpc_setup(T=T + start_k, B=B)
    noise = noise[:T]
    kw = dict(cost_tolerance=1e-4, gradient_tolerance=1e-4,
              constraint_tolerance=1e-4, penalty_initial=1e3,
              penalty_scaling=100.0, iterations_linesearch=2,
              early_exact_tol=1e-3)
    jrun = jax.jit(j_run_mpc, static_argnames=("start_k",))
    jres = [jrun(prob_mpc, at.SolverOptions(**kw), X_track, U_track,
                 jnp.asarray(noise[:, b]), start_k=start_k)
            for b in range(B)]
    tres = run_mpc(convert.problem_from_numpy(convert.numpy_tree(prob_mpc)),
                   tt.SolverOptions(**kw), torch.tensor(np.asarray(X_track)),
                   torch.tensor(np.asarray(U_track)), torch.as_tensor(noise),
                   start_k=start_k)
    assert tres.X.shape == (T, B, prob_mpc.N, 6)
    for b, jr in enumerate(jres):
        assert tres.iters[:, b].tolist() == np.asarray(jr.iters).tolist()
        assert tres.status[:, b].tolist() == np.asarray(jr.status).tolist()
        for k in ("X", "U", "viol", "x0"):
            close(getattr(tres, k)[:, b], getattr(jr, k))
    assert int(tres.status.sum()) == T * B


def test_xws_corrector_is_exact_rollout():
    prob_mpc, X_track, U_track, _ = _mpc_setup(seed=3)
    tp = convert.problem_from_numpy(convert.numpy_tree(prob_mpc))
    dyn = tp.dynamics
    rng = np.random.default_rng(7)
    x0_old = torch.as_tensor(rng.standard_normal((2, tp.n)))
    U_old = torch.as_tensor(0.1 * rng.standard_normal((2, tp.N - 1, tp.m)))
    X_old = dyn.rollout(x0_old, U_old)
    x0_new = X_old[:, 1] + torch.as_tensor(0.01 * rng.standard_normal((2, tp.n)))
    U_ws = shift_fill(U_old)
    close(_xws_corrector(dyn)(X_old, U_ws, x0_new), dyn.rollout(x0_new, U_ws))
    A_tv = dyn.A.clone()
    A_tv[0] *= 1.5
    assert _xws_corrector(dataclasses.replace(dyn, A=A_tv)) is None


def test_per_lane_dynamics_window_and_no_corrector():
    """Per-lane stacks [B, N-1, ...] (B=4, one LTI model per lane): the MPC
    window cuts the knot axis, not the batch axis, and the exact seam
    corrector declines them (it holds only for stacks shared by the
    batch)."""
    prob_mpc, X_track, U_track, _ = _mpc_setup(N_mpc=11, seed=4)
    tp = convert.problem_from_numpy(convert.numpy_tree(prob_mpc))
    dyn = tp.dynamics
    B, N_long, N_mpc = 4, tp.N, 7
    rng = np.random.default_rng(8)
    scale = torch.as_tensor(1.0 + 0.1 * rng.standard_normal((B, 1, 1, 1)))
    A = dyn.A[None] * scale                     # lane-constant along knots
    Bm = dyn.B[None].expand(B, -1, -1, -1) * scale
    d = dyn.d[None].expand(B, -1, -1) * scale[..., 0]
    lanes = tt.LTVDynamics(A=A.contiguous(), B=Bm.contiguous(),
                           d=d.contiguous())
    assert lanes.per_lane and lanes.A.shape[:2] == (B, N_long - 1)
    long = dataclasses.replace(tp, dynamics=lanes)
    X_tr = torch.tensor(np.asarray(X_track))
    U_tr = torch.tensor(np.asarray(U_track))
    win = gen_tracking_mpc(long, X_tr, U_tr, N_mpc).dynamics
    assert win.per_lane and win.N == N_mpc
    assert win.A.shape == (B, N_mpc - 1, tp.n, tp.n)
    assert win.B.shape == (B, N_mpc - 1, tp.n, tp.m)
    assert win.d.shape == (B, N_mpc - 1, tp.n)
    for got, full in ((win.A, A), (win.B, Bm), (win.d, d)):
        assert torch.equal(got, full[:, :N_mpc - 1])
    assert _xws_corrector(win) is None
    assert _xws_corrector(lanes) is None
    # the shared window of the same model keeps its corrector
    assert _xws_corrector(gen_tracking_mpc(tp, X_tr, U_tr, N_mpc).dynamics)
