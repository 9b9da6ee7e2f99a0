"""The rocket conic MPC slice as a whole against the JAX package in float64:
a cold rocket solve at N=41 with the classical and the fused ladder (same
iterations and status, X/U to atol 1e-8), and three warm MPC steps of the
rocket's N_mpc=21 window with the benchmark's options and the tracking
warm start (per-step iterations and status equal, X/U/viol to atol 1e-8);
the tracking warm start's seed.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import altro_tpu as at  # noqa: E402
from altro_tpu.models import rocket as jrocket  # noqa: E402
from altro_tpu.mpc import gen_tracking_mpc as j_gen  # noqa: E402
from altro_tpu.mpc import make_mpc_step as j_make_mpc_step  # noqa: E402

import altro_tpu_torch as tt  # noqa: E402
from altro_tpu_torch import convert  # noqa: E402
from altro_tpu_torch.bench.conic import WARM_OPTS  # noqa: E402
from altro_tpu_torch.models import rocket as trocket  # noqa: E402
from altro_tpu_torch.mpc import make_mpc_step  # noqa: E402
from altro_tpu_torch.ops import riccati_fused, rollout, rollout_al  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-8


def close(t, j):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=ATOL, rtol=0)


def _counts():
    return (rollout.launch_count, riccati_fused.launch_count,
            rollout_al.launch_count)


@pytest.mark.parametrize("ls_fused", ["off", "on"])
def test_cold_solve_matches_jax(ls_fused):
    """N=41 over 15 s from the hover controls, solved to tight tolerances:
    at the benchmark's looser cold tolerances the stopping point moves by
    ~1e-7 in U under reduction-order noise alone (the JAX package's own
    single and vmapped solves differ by that much there)."""
    N, tf = 41, 15.0
    kw = dict(cost_tolerance=1e-8, gradient_tolerance=1e-8,
              constraint_tolerance=1e-7, penalty_initial=1.0,
              penalty_scaling=10.0, ls_fused=ls_fused)
    jp = jrocket.rocket_problem(N=N, tf=tf)
    jsol = at.solve(jp, at.SolverOptions(**kw), U0=jrocket.hover_controls(jp))
    tp = trocket.rocket_problem(N=N, tf=tf)
    counts = _counts()
    tsol = tt.solve(dataclasses.replace(tp, x0=tp.x0[None]),
                    tt.SolverOptions(**kw),
                    U0=trocket.hover_controls(tp)[None])
    assert _counts() == counts          # the CPU takes the plain versions
    assert int(tsol.stats.status[0]) == int(jsol.stats.status) == 1
    assert int(tsol.stats.iterations[0]) == int(jsol.stats.iterations)
    assert (int(tsol.stats.outer_iterations[0])
            == int(jsol.stats.outer_iterations))
    close(tsol.X[0], jsol.X)
    close(tsol.U[0], jsol.U)


@pytest.fixture(scope="module")
def rocket_window():
    """The rocket's N_mpc=21 window tracking the JAX package's cold solve of
    the N=41 problem over 6 s (a 0.15 s dynamics step).

    On this window no lane meets a line-search decision at round-off level
    in the three steps. Where one does (at a 0.05 s step, for one), a last
    step whose expected decrease is ~1e-12 is accepted by one package and
    rejected by the other, which moves that lane's final U by up to ~2e-6
    while iteration counts and status still agree; the card's f32-vs-f64
    gate scores such lanes by cost instead (chip_smoke.py)."""
    N = 41
    jp = jrocket.rocket_problem(N=N, tf=6.0)
    sol = at.solve(jp, at.SolverOptions(
        cost_tolerance=1e-5, gradient_tolerance=1e-6,
        constraint_tolerance=1e-4, penalty_initial=1e-2,
        penalty_scaling=500.0, iterations_outer=40, iterations_inner=100),
        U0=jrocket.hover_controls(jp))
    return j_gen(jp, sol.X, sol.U, 21, dt=0.05), sol.X, sol.U


@pytest.mark.parametrize("ls_fused", ["auto", "on"])
def test_mpc_steps_match_jax(rocket_window, ls_fused):
    """B=4, three steps of the rocket benchmark's warm options with
    warm_start="track" and the rocket noise model (on the CPU "auto" takes
    the classical ladder in both packages)."""
    T, B = 3, 4
    jw, X_track, U_track = rocket_window
    noise = np.random.default_rng(1).standard_normal((T, B, 6))
    kw = dict(WARM_OPTS, ls_fused=ls_fused)
    jstep, jinit = j_make_mpc_step(
        jw, at.SolverOptions(**kw), X_track, U_track,
        noise_model=jrocket.rocket_noise_model(), shared_k=True,
        warm_start="track")
    vstep = jax.jit(jax.vmap(jstep, in_axes=(0, 0, None)))
    jcarry = jax.vmap(lambda _: jinit())(jnp.arange(B))

    tstep, tinit = make_mpc_step(
        convert.problem_from_numpy(convert.numpy_tree(jw)),
        tt.SolverOptions(**kw), torch.tensor(np.asarray(X_track)),
        torch.tensor(np.asarray(U_track)),
        noise_model=trocket.rocket_noise_model(), shared_k=True,
        warm_start="track")
    tcarry = tinit(B)
    close(tcarry[1], jcarry[1])
    close(tcarry[2], jcarry[2])
    for t in range(T):
        jcarry, jout = vstep(jcarry, jnp.asarray(noise[t]),
                             jnp.asarray(t, jnp.int32))
        tcarry, tout = tstep(tcarry, torch.as_tensor(noise[t]), t)
        assert tout.iters.tolist() == np.asarray(jout.iters).tolist(), t
        assert tout.status.tolist() == np.asarray(jout.status).tolist(), t
        assert int(tout.status.sum()) == B
        for k in ("X", "U", "viol", "x0"):
            close(getattr(tout, k), getattr(jout, k))


def test_track_warm_start_seeds_from_the_window():
    """warm_start="track" solves from the tracking window's controls: with
    zero iterations allowed the step returns them unchanged."""
    N = 25
    tp = trocket.rocket_problem(N=N, tf=(N - 1) * 0.05)
    U_tr = trocket.hover_controls(tp) + torch.linspace(0, 1, N - 1)[:, None]
    X_tr = tp.dynamics.rollout(tp.x0, U_tr)
    from altro_tpu_torch.mpc import gen_tracking_mpc
    pm = gen_tracking_mpc(tp, X_tr, U_tr, 11, dt=0.05)
    opts = tt.SolverOptions(**dict(WARM_OPTS, iterations_outer=0))
    step, init = make_mpc_step(pm, opts, X_tr, U_tr,
                               noise_model=trocket.rocket_noise_model(),
                               warm_start="track")
    carry = init(2)
    _, out = step(carry, torch.zeros(2, 6), 4)
    assert torch.equal(out.U, U_tr[5:15].expand(2, 10, 3))
    with pytest.raises(ValueError):
        make_mpc_step(pm, opts, X_tr, U_tr, warm_start="cold")
