"""The ALTRO-vs-baseline oracles of the port in float64 on the CPU:
``run_mpc_lockstep`` on ``tests/test_random_linear_mpc.py``'s problem against
the JAX package's run (equal iterations and status, and the JAX test's
gates), ``run_mpc_lockstep_conic`` on the rocket (the tolerance sweep of
``tests/test_rocket.py``, T cut to 5) and on grasp (``tests/test_grasp.py``),
both also beside the JAX package's on the same tracking data; the rocket
tolerance sweep at T=20 and all four tolerances from the JAX package's own
carry before every step (equal iterations and status on every step), and
the round-off decision where the free-running sweeps part (step 0's SOC
case flip between the JAX package's compiled and op-by-op arithmetic);
the flexible satellite's cold solve against ``admm_qp``, the quadruped's
ALTRO against ``admm_qp`` and ``admm_conic`` (``tests/test_quadruped.py``),
``simulate_host`` with each ADMM backend for 3 periods against the JAX
package's ``native=False`` run (equal status and iterations, forces within
1e-6 N), the native entrants raising when the C++ library does not build,
the three harness tests of ``tests/test_harness.py``, and every benchmark
driver at a tiny size with the result keys of the JAX package's (whose
compute is stubbed out: only its result layout is read).
"""
import dataclasses
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import altro_tpu as at  # noqa: E402

import altro_tpu_torch as tt  # noqa: E402
from altro_tpu_torch.bench import drivers as tdrv  # noqa: E402
from altro_tpu_torch.bench.harness import (benchmark_fn,  # noqa: E402
                                           boxplot_stats, load_results,
                                           save_results)
from altro_tpu_torch.mpc import (gen_tracking_mpc,  # noqa: E402
                                 run_mpc_lockstep, run_mpc_lockstep_conic)
from altro_tpu_torch.solver import admm_qp  # noqa: E402
from altro_tpu_torch.transcribe import extract_traj, to_batch_qp  # noqa: E402

torch.set_num_threads(1)
F64 = torch.float64
QUAD = dict(cost_tolerance=1e-4, constraint_tolerance=1e-4,
            penalty_initial=10.0, penalty_scaling=100.0, reset_duals=False)


# ----------------------------------------------------------------------------
# lockstep loops
# ----------------------------------------------------------------------------

def test_lockstep_random_linear_matches_jax():
    from altro_tpu.models import random_linear as jrl
    from altro_tpu.mpc import run_mpc_lockstep as jlock
    from altro_tpu_torch.models import random_linear as trl
    kw = dict(cost_tolerance=1e-4, constraint_tolerance=1e-4,
              penalty_initial=1e3, penalty_scaling=100.0, reset_duals=False)
    T = 15
    noise = np.random.default_rng(3).standard_normal((T, 12))
    built = []
    for rl in (jrl, trl):
        rng = np.random.default_rng(1)
        p = rl.gen_random_linear(rng, 12, 6, 121)
        X, U = rl.gen_trajectory(rng, p, 121)
        built.append((rl.gen_tracking_mpc(p, X, U, 21), X, U))
    (jp, jX, jU), (tp, tX, tU) = built
    jres = jlock(jp, at.SolverOptions(**kw), jX, jU, jnp.asarray(noise),
                 qp_eps=1e-7)
    res = run_mpc_lockstep(tp, tt.SolverOptions(**kw), tX, tU,
                           torch.tensor(noise), qp_eps=1e-7)
    assert int(res.status[:, 0].sum()) == T
    assert int(res.status[:, 1].sum()) == T
    assert float(res.err_X.max()) < 5e-3
    assert float(res.err_U.max()) < 5e-3
    assert float(res.err_x0.max()) < 1e-5
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(jres.iters))
    np.testing.assert_array_equal(res.status.numpy(),
                                  np.asarray(jres.status))
    np.testing.assert_allclose(res.err_U.numpy(), np.asarray(jres.err_U),
                               atol=1e-8)


@pytest.fixture(scope="module")
def rocket_cold():
    from altro_tpu_torch.bench.baselines import rocket_window
    return rocket_window("cpu")


def test_rocket_lockstep_tolerance_sweep(rocket_cold):
    """The disagreement with the tight conic ADMM shrinks as ALTRO's
    tolerance tightens, and is below 1e-3 at the tightest."""
    from altro_tpu_torch.models import rocket
    pw, X, U = rocket_cold
    T = 5
    noise = torch.tensor(np.random.default_rng(1).standard_normal((T, 6)))
    errs = []
    for tol in (1e-4, 1e-6, 1e-8):
        opts = tt.SolverOptions(
            cost_tolerance=tol, gradient_tolerance=tol * 1e-2,
            constraint_tolerance=tol, penalty_initial=1e3,
            penalty_scaling=10.0, reset_duals=False, iterations_outer=40)
        res = run_mpc_lockstep_conic(pw, opts, X, U, noise, conic_eps=1e-9,
                                     conic_max_iter=50000,
                                     noise_model=rocket.rocket_noise_model())
        assert int(res.status[:, 0].sum()) == T
        assert int(res.status[:, 1].sum()) == T
        errs.append(float(res.err_U.max()))
    assert errs[2] < errs[0], errs
    assert errs[2] < 1e-3, errs


def test_rocket_lockstep_matches_jax(rocket_cold):
    """``run_mpc_lockstep_conic`` on the rocket window (tolerance 1e-6, T=5)
    beside the JAX package's on the same tracking data. The conic side (its
    unshifted warm start and reused KKT factor) takes equal iterations on
    every step, and every status and err_x0 agree. ALTRO's first two warm
    starts sit on the thrust-angle cone's boundary, where the AL Hessian
    jumps: the two packages' cold window solves differ by 6e-11 in U, which
    flips one knot's projection case (luu differs by 269 at knot 18), so
    those two solves take different paths to the same tolerance. From step
    2 on ALTRO's iterations and err_U agree (err_U to 1e-8)."""
    from altro_tpu.models import rocket as jrocket
    from altro_tpu.mpc import gen_tracking_mpc as jgen
    from altro_tpu.mpc import run_mpc_lockstep_conic as jlock
    from altro_tpu_torch.models import rocket
    pw, X, U = rocket_cold
    T, tol, N = 5, 1e-6, 301
    noise = np.random.default_rng(1).standard_normal((T, 6))
    jX, jU = jnp.asarray(X.numpy()), jnp.asarray(U.numpy())
    jpw = jgen(jrocket.rocket_problem(N=N, tf=(N - 1) * 0.05), jX, jU, 21,
               dt=0.05)
    kw = dict(cost_tolerance=tol, gradient_tolerance=tol * 1e-2,
              constraint_tolerance=tol, penalty_initial=1e3,
              penalty_scaling=10.0, reset_duals=False, iterations_outer=40)
    jres = jlock(jpw, at.SolverOptions(**kw), jX, jU, jnp.asarray(noise),
                 conic_eps=1e-9, conic_max_iter=50000,
                 noise_model=jrocket.rocket_noise_model())
    res = run_mpc_lockstep_conic(pw, tt.SolverOptions(**kw), X, U,
                                 torch.tensor(noise), conic_eps=1e-9,
                                 conic_max_iter=50000,
                                 noise_model=rocket.rocket_noise_model())
    assert int(res.status.sum()) == 2 * T
    np.testing.assert_array_equal(res.status.numpy(),
                                  np.asarray(jres.status))
    np.testing.assert_array_equal(res.iters[:, 1].numpy(),
                                  np.asarray(jres.iters)[:, 1])
    np.testing.assert_allclose(res.err_x0.numpy(), np.asarray(jres.err_x0),
                               atol=1e-8)
    np.testing.assert_array_equal(res.iters[2:, 0].numpy(),
                                  np.asarray(jres.iters)[2:, 0])
    np.testing.assert_allclose(res.err_U[2:].numpy(),
                               np.asarray(jres.err_U)[2:], atol=1e-8)


# The rocket tolerance sweep from the JAX package's own carry. Both
# packages get bit-equal data: the JAX package's cold N=301 solve and MPC
# window (converted), the same noise, and, before every step, the JAX
# package's carry (x0, X, U, duals) converted.
SWEEP_T = 20


@pytest.fixture(scope="module")
def rocket_sweep_data():
    from altro_tpu.models import rocket as jrocket
    from altro_tpu.mpc import gen_tracking_mpc as jgen
    from altro_tpu_torch.convert import numpy_tree, problem_from_numpy
    N = 301
    jp = jrocket.rocket_problem(N=N, tf=(N - 1) * 0.05)
    cold = jax.jit(at.solve)(jp, at.SolverOptions(
        cost_tolerance=1e-6, gradient_tolerance=1e-8,
        constraint_tolerance=1e-5, penalty_initial=1e-2,
        penalty_scaling=500.0, iterations_outer=40, iterations_inner=100),
        U0=jrocket.hover_controls(jp))
    jpm = jgen(jp, cold.X, cold.U, 21, dt=0.05)
    noise = np.random.default_rng(1).standard_normal((SWEEP_T, 6))
    return dict(jpm=jpm, cold=cold, noise=noise,
                tpm=problem_from_numpy(numpy_tree(jpm)),
                Xc=torch.tensor(np.asarray(cold.X)),
                Uc=torch.tensor(np.asarray(cold.U)))


def _sweep_opts(mod, tol):
    return mod.SolverOptions(
        cost_tolerance=tol, gradient_tolerance=tol * 1e-2,
        constraint_tolerance=tol, penalty_initial=1e3, penalty_scaling=10.0,
        reset_duals=False, iterations_outer=40)


def _carry_to_port(carry):
    x0, X, U, duals = carry[:4]

    def t(a):
        return torch.tensor(np.asarray(a))[None]
    return (t(x0), t(X), t(U), tuple(tt.DualState(lam=t(d.lam),
                                                 rho=t(d.rho))
                                     for d in duals))


@pytest.mark.parametrize("tol", [1e-2, 1e-4, 1e-6, 1e-8])
def test_rocket_sweep_from_jax_carry_matches_jax(rocket_sweep_data, tol):
    """The rocket tolerance sweep (T=20, f64): before every step the JAX
    package's carry, converted, goes into the port's step, which then takes
    the JAX step's iterations and status, at every step and every
    tolerance: the two packages decide alike from equal inputs. (Run
    free, each on its own carry, the two sequences part later: a solve
    that crosses a round-off decision, such as step 0's in
    ``test_rocket_sweep_step0_case_flip_is_round_off``, moves U by up to
    3e-5 within the tolerance, and a later step decides differently from
    the moved carry.)"""
    from altro_tpu.models import rocket as jrocket
    from altro_tpu.mpc import make_mpc_step as jmake
    from altro_tpu_torch.models import rocket
    from altro_tpu_torch.mpc import make_mpc_step
    d = rocket_sweep_data
    jstep, jinit = jmake(d["jpm"], _sweep_opts(at, tol), d["cold"].X,
                         d["cold"].U, jrocket.rocket_noise_model())
    jstep = jax.jit(jstep)
    carry = jax.jit(jinit)()
    step, _ = make_mpc_step(d["tpm"], _sweep_opts(tt, tol), d["Xc"],
                            d["Uc"], rocket.rocket_noise_model(),
                            graphed=False)
    jit, pit = [], []
    for t in range(SWEEP_T):
        _, out = step(_carry_to_port(carry),
                      torch.tensor(d["noise"][t])[None], t)
        carry, jout = jstep(carry, jnp.asarray(d["noise"][t]))
        jit.append((int(jout.iters), int(jout.status)))
        pit.append((int(out.iters[0]), int(out.status[0])))
    assert pit == jit
    assert all(s == 1 for _, s in pit)


def test_rocket_sweep_step0_case_flip_is_round_off(rocket_sweep_data):
    """Where the free-running sweeps part first (step 0, every tolerance:
    U 3e-5 apart at 1e-4 with equal iterations): the AL expansion of the
    step's first iteration. The port's equals the JAX package's computed
    op by op bit for bit; the JAX package's jit-compiled expansion differs
    in luu by O(rho) at the knots, and only at the knots, where the
    thrust-angle cone's residual z = lam + rho c lies on the cone's
    boundary to the last bit (|v| == s in float64): there one ulp of |v|
    decides between the inside case (no curvature) and the boundary case
    (coef2 = rho / 2 on a rank-1 term), and the compiled reduction rounds
    |v| the other way. Both sides of the decision, from the port's own
    z."""
    from altro_tpu.costs import retarget_tracking
    from altro_tpu.models import rocket as jrocket
    from altro_tpu.mpc import _xws_corrector
    from altro_tpu.mpc import make_mpc_step as jmake
    from altro_tpu.mpc import shift_fill, track_window
    from altro_tpu.solver import altro as jal
    from altro_tpu_torch.cones import _soc_parts, soc_polar_curvature_factors
    from altro_tpu_torch.models import rocket
    from altro_tpu_torch.mpc import _StepPieces
    from altro_tpu_torch.solver import altro as tal
    d = rocket_sweep_data
    tol, jpm, ulp = 1e-4, d["jpm"], 2.0 ** -52
    _, jinit = jmake(jpm, _sweep_opts(at, tol), d["cold"].X, d["cold"].U,
                     jrocket.rocket_noise_model())
    carry = jax.jit(jinit)()
    # the JAX package's step 0 up to its first iteration's state
    x0, X, U, duals, k = carry
    x0_new = jrocket.rocket_noise_model()(jpm.dynamics.step(x0, U[0], 0),
                                          jnp.asarray(d["noise"][0]))
    Xw, Uw = track_window(d["cold"].X, d["cold"].U, int(k) + 1, 21)
    jpk = jpm.replace(cost=retarget_tracking(jpm.cost, Xw, Uw), x0=x0_new)
    U_ws = shift_fill(U)
    js = jal._warmstart_state(jpk, _sweep_opts(at, tol), U_ws,
                              tuple(du.shift() for du in duals),
                              _xws_corrector(jpm.dynamics)(X, U_ws, x0_new))
    # the port's, from the converted carry
    pieces = _StepPieces(d["tpm"], _sweep_opts(tt, tol), d["Xc"], d["Uc"],
                         rocket.rocket_noise_model(), None, "shift")
    pk, ts, _ = pieces.start_from(_carry_to_port(carry),
                                  torch.tensor(d["noise"][0])[None],
                                  *pieces.window(1))
    np.testing.assert_array_equal(ts[0][0].numpy(), np.asarray(js[0]))
    np.testing.assert_array_equal(ts[1][0].numpy(), np.asarray(js[1]))
    port = tal._al_expansion_cd(pk.cost, pk.constraints, ts[3], ts[0],
                                ts[1])
    eager = jal._al_expansion_cd(jpk.cost, jpk.constraints, js[3], js[0],
                                 js[1])
    compiled = jax.jit(jal._al_expansion_cd)(jpk.cost, jpk.constraints,
                                             js[3], js[0], js[1])
    for a, b in zip(port, eager):
        b = np.asarray(b)
        np.testing.assert_array_equal(a.numpy().reshape(b.shape), b)
    dluu = np.abs(np.asarray(compiled[3]) - np.asarray(eager[3])).max(
        axis=(1, 2))
    flipped = set(np.flatnonzero(dluu > 1.0).tolist())
    assert flipped, "the compiled expansion agrees: no case flip to show"
    # the knots whose SOC residual lies on the boundary to two ulp
    on_edge = set()
    X, U = ts[0], ts[1]
    for con, du in zip(pk.constraints, ts[3]):
        if con.cone.value != "soc":
            continue
        z = (du.lam + du.rho[..., None] * con.evaluate(X, U))[0]
        _, s_, a, _ = _soc_parts(z)
        edge = ((a - s_).abs() <= 2 * ulp * s_.abs()) & (con.mask > 0)
        on_edge |= set(torch.nonzero(edge).flatten().tolist())
        for kk in torch.nonzero(edge).flatten().tolist():
            # both sides: |v| eight ulp smaller is the inside case (no
            # curvature), eight ulp larger the boundary case (rank-1
            # weight 1/2, times rho in the expansion)
            sides = z[kk].repeat(2, 1)
            sides[0, :-1] *= 1.0 - 8 * ulp
            sides[1, :-1] *= 1.0 + 8 * ulp
            _, _, _, c2, _ = soc_polar_curvature_factors(sides)
            assert c2.tolist() == [0.0, 0.5]
    assert flipped <= on_edge, (flipped, on_edge)


@pytest.fixture(scope="module")
def grasp_cold():
    """The grasp object, its N=61 problem and the port's cold solve."""
    from altro_tpu_torch.models import grasp
    N, tf = 61, 6.0
    o = grasp.make_grasp_object(N, tf)
    prob = grasp.grasp_problem(o, N, tf)
    sol = tt.solve(dataclasses.replace(prob, x0=prob.x0[None]),
                   tt.SolverOptions(cost_tolerance=1e-6,
                                    gradient_tolerance=1e-8,
                                    constraint_tolerance=1e-6,
                                    penalty_initial=10.0,
                                    penalty_scaling=10.0,
                                    iterations_outer=30,
                                    iterations_inner=50),
                   U0=grasp.hover_controls(o, N)[None])
    return o, prob, sol.X[0], sol.U[0]


GRASP_MPC = dict(cost_tolerance=1e-4, constraint_tolerance=1e-4,
                 penalty_initial=1e4, penalty_scaling=100.0,
                 reset_duals=False)


def test_grasp_lockstep_time_varying_constraints(grasp_cold):
    from altro_tpu_torch.models import grasp
    o, prob, X, U = grasp_cold
    N_mpc = 11
    pm = gen_tracking_mpc(prob, X, U, N_mpc, Qk=1e3, Rk=1.0, Qfk=10.0,
                          dt=6.0 / 60)
    pm = dataclasses.replace(pm, constraints=grasp.grasp_constraints(
        o, N_mpc, 0))
    T = 10
    noise = torch.tensor(np.random.default_rng(0).standard_normal((T, 6)))
    res = run_mpc_lockstep_conic(
        pm, tt.SolverOptions(**GRASP_MPC), X, U, noise, conic_eps=1e-8,
        constraints_fn=lambda k: grasp.grasp_constraints(o, N_mpc, k))
    assert int(res.status[:, 0].sum()) == T
    assert int(res.status[:, 1].sum()) == T
    assert float(res.viol.max()) < 1e-4
    assert float(res.err_X.max()) < 5e-2
    assert float(res.err_U.max()) < 5e-2


def test_grasp_lockstep_matches_jax(grasp_cold):
    """``run_mpc_lockstep_conic`` on the grasp window (N=11, T=5) with its
    per-step constraint windows, beside the JAX package's on the same
    tracking data: equal iterations and status, err_U equal to 1e-8."""
    from altro_tpu.models import grasp as jgrasp
    from altro_tpu.mpc import gen_tracking_mpc as jgen
    from altro_tpu.mpc import run_mpc_lockstep_conic as jlock
    from altro_tpu_torch.models import grasp
    o, prob, X, U = grasp_cold
    N, tf, N_mpc, T = 61, 6.0, 11, 5
    noise = np.random.default_rng(0).standard_normal((T, 6))
    jo = jgrasp.make_grasp_object(N, tf)
    jX, jU = jnp.asarray(X.numpy()), jnp.asarray(U.numpy())
    jpm = jgen(jgrasp.grasp_problem(jo, N, tf), jX, jU, N_mpc, Qk=1e3,
               Rk=1.0, Qfk=10.0, dt=tf / (N - 1))
    jpm = jpm.replace(constraints=jgrasp.grasp_constraints(jo, N_mpc, 0))
    jres = jlock(jpm, at.SolverOptions(**GRASP_MPC), jX, jU,
                 jnp.asarray(noise), conic_eps=1e-8,
                 constraints_fn=lambda k: jgrasp.grasp_constraints(
                     jo, N_mpc, k))
    pm = gen_tracking_mpc(prob, X, U, N_mpc, Qk=1e3, Rk=1.0, Qfk=10.0,
                          dt=tf / (N - 1))
    pm = dataclasses.replace(pm, constraints=grasp.grasp_constraints(
        o, N_mpc, 0))
    res = run_mpc_lockstep_conic(
        pm, tt.SolverOptions(**GRASP_MPC), X, U, torch.tensor(noise),
        conic_eps=1e-8,
        constraints_fn=lambda k: grasp.grasp_constraints(o, N_mpc, k))
    assert int(res.status.sum()) == 2 * T
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(jres.iters))
    np.testing.assert_array_equal(res.status.numpy(),
                                  np.asarray(jres.status))
    np.testing.assert_allclose(res.err_U.numpy(), np.asarray(jres.err_U),
                               atol=1e-8)


def test_flexsat_cold_solve_vs_admm_qp():
    from altro_tpu_torch.models import flexible_satellite as fs
    prob = fs.flexsat_problem()
    prob = dataclasses.replace(prob, x0=prob.x0[None])
    sol = tt.solve(prob, tt.SolverOptions(
        cost_tolerance=1e-6, gradient_tolerance=1e-8,
        constraint_tolerance=1e-6, penalty_initial=100.0,
        penalty_scaling=100.0))
    assert int(sol.stats.status[0]) == 1
    assert float(sol.U.abs().max()) <= 0.01 + 1e-7
    qp = to_batch_qp(prob)
    qsol = admm_qp.solve(admm_qp.setup(qp), eps_abs=1e-9, max_iter=20000)
    Xq, Uq = extract_traj(qp, qsol.x)
    assert int(qsol.status[0]) == 1
    np.testing.assert_allclose(sol.X, Xq, atol=1e-4)
    np.testing.assert_allclose(sol.U, Uq, atol=1e-4)


# ----------------------------------------------------------------------------
# quadruped
# ----------------------------------------------------------------------------

def _scenario(lin):
    from altro_tpu_torch.models.quadruped import config, gait, planner, srb
    cfg = config.MPCConfig(linearized_friction=lin)
    g = gait.GAITS[cfg.gait_type](cfg.stance_time, cfg.swing_time)
    from altro_tpu_torch.models.quadruped import controller
    prob, x_des = controller.build_mpc_problem(cfg, device="cpu")
    x_curr = x_des + torch.tensor(
        np.random.default_rng(3).standard_normal(12)) * 0.01
    x_ref = x_des.expand(cfg.N, 12)
    feet = planner.nominal_foot_locations() + x_des[0:3][None, :]
    contacts, foot_locs, _ = planner.foot_history(
        torch.tensor(0.05, dtype=F64), x_ref, feet, feet, g, x_des, cfg.N,
        cfg.dynamics_discretization)
    u0 = torch.zeros(12, dtype=F64)
    u0[2::3] = srb.SPRUNG_MASS * 9.81 / 4
    U0 = u0.expand(1, cfg.N - 1, 12).clone()
    duals = dataclasses.replace(prob, x0=x_des[None]).init_duals(10.0)
    return (cfg, prob, x_curr[None], x_ref, contacts, foot_locs, U0, duals,
            controller)


def test_altro_vs_admm_qp_same_forces():
    """test_same_solution (mujoco_test.jl:95-183): ALTRO with linearized
    friction against the OSQP-role dense ADMM QP on one instance, both
    solutions inside the friction pyramids, and cost parity."""
    (cfg, prob, x, x_ref, c, f, U0, duals, ctl) = _scenario(True)
    tight = tt.SolverOptions(**dict(QUAD, cost_tolerance=1e-6,
                                    constraint_tolerance=1e-6,
                                    gradient_tolerance=1e-8))
    fa, Ua, _, _, sa, _ = ctl.mpc_solve_forces(
        "altro", prob, tight, x, x_ref, c, f, cfg.dynamics_discretization,
        U0, duals)
    fq, Uq, _, _, sq, _ = ctl.mpc_solve_forces(
        "admm_qp", prob, dataclasses.replace(tight, cost_tolerance=1e-8), x,
        x_ref, c, f, cfg.dynamics_discretization, U0, duals)
    assert int(sa[0]) == 1 and int(sq[0]) == 1
    np.testing.assert_allclose(fa, fq, atol=2e-3, rtol=1e-3)
    for U in (Ua, Uq):
        F = U[0].numpy().reshape(-1, 4, 3)
        fz = np.maximum(F[:, :, 2], 0.0)
        assert np.all(np.abs(F[:, :, 0]) <= cfg.mu * fz + 1e-3)
        assert np.all(np.abs(F[:, :, 1]) <= cfg.mu * fz + 1e-3)
    from altro_tpu_torch.models.quadruped.srb import linearize_horizon
    dyn = linearize_horizon(x_ref, torch.zeros((cfg.N, 12), dtype=F64), f,
                            c, cfg.dynamics_discretization)

    def cost(U):
        return float(prob.cost.total(dyn.rollout(x[0], U[0]), U[0]))

    ca, cq = cost(Ua), cost(Uq)
    assert abs(ca - cq) / max(abs(ca), 1.0) < 1e-3


def test_altro_soc_vs_admm_conic_same_forces():
    (cfg, prob, x, x_ref, c, f, U0, duals, ctl) = _scenario(False)
    tight = tt.SolverOptions(**dict(QUAD, cost_tolerance=1e-6,
                                    constraint_tolerance=1e-6,
                                    gradient_tolerance=1e-8))
    fa, _, _, _, sa, _ = ctl.mpc_solve_forces(
        "altro", prob, tight, x, x_ref, c, f, cfg.dynamics_discretization,
        U0, duals)
    fc, _, _, _, sc, _ = ctl.mpc_solve_forces(
        "admm_conic", prob, dataclasses.replace(tight, cost_tolerance=1e-8),
        x, x_ref, c, f, cfg.dynamics_discretization, U0, duals)
    assert int(sa[0]) == 1 and int(sc[0]) == 1
    np.testing.assert_allclose(fa, fc, atol=5e-3, rtol=5e-3)


@pytest.mark.parametrize("backend,lin", [("admm_qp", True),
                                         ("admm_conic", False)])
def test_simulate_host_admm_matches_jax(backend, lin):
    from altro_tpu.models.quadruped import config as jc
    from altro_tpu.models.quadruped import controller as jctl
    from altro_tpu_torch.models.quadruped import config as tc
    from altro_tpu_torch.models.quadruped import controller as tctl
    tf = 0.09
    jres = jctl.simulate_host(jc.MPCConfig(linearized_friction=lin),
                              at.SolverOptions(**QUAD), tf=tf,
                              backend=backend, native=False)
    res = tctl.simulate_host(tc.MPCConfig(linearized_friction=lin),
                             tt.SolverOptions(**QUAD), tf=tf,
                             backend=backend, device="cpu", native=False)
    np.testing.assert_array_equal(res["status"].numpy(),
                                  np.asarray(jres["status"]))
    np.testing.assert_array_equal(res["iters"].numpy(),
                                  np.asarray(jres["iters"]))
    assert int(res["status"].min()) == 1
    np.testing.assert_allclose(res["forces"].numpy(),
                               np.asarray(jres["forces"]), atol=1e-6)
    # one chunk per 25 iterations of every solve, the warm-up's included
    assert res["admm_chunks"] > int(res["iters"].sum()) // 25


def test_native_entrants_raise(tmp_path, monkeypatch):
    """The C++ entrants (the quadruped's native workspace and race, the
    four-solver studies' truth solves) raise when the native library does
    not build, with the compiler's output: nothing falls back to a PyTorch
    solver."""
    from altro_tpu_torch.models.quadruped import config, controller
    from altro_tpu_torch.native import qp as native_qp
    bad = tmp_path / "broken.cpp"
    bad.write_text("int broken( { return 0; }\n")
    monkeypatch.setattr(native_qp, "_lib", None)
    monkeypatch.setattr(native_qp, "_SRCS", (str(bad),))
    monkeypatch.setattr(native_qp, "BUILD_DIR", str(tmp_path / "build"))
    cfg = config.MPCConfig()
    prob, x_des = controller.build_mpc_problem(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="broken.cpp"):
        controller.make_baseline_state("admm_qp", prob, cfg, x_des)
    for backend in ("admm_qp", "altro"):
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            controller.simulate_host(cfg, tt.SolverOptions(**QUAD), tf=0.03,
                                     backend=backend, device="cpu")
    for name in ("rocket_multibaseline_tol", "grasp_multibaseline_tol"):
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            getattr(tdrv, name)(tols=(1e-4,), T=1, device="cpu")


# ----------------------------------------------------------------------------
# harness (tests/test_harness.py)
# ----------------------------------------------------------------------------

def test_boxplot_stats_quartiles():
    x = np.arange(1, 101, dtype=float)
    s = boxplot_stats(x)
    assert abs(s["median"] - 50.5) < 1e-9
    assert s["q1"] < s["median"] < s["q3"]
    assert s["lower_whisker"] <= s["q1"]
    assert s["upper_whisker"] >= s["q3"]
    assert s["outliers"] == []


def test_boxplot_outlier_filter():
    x = np.concatenate([np.random.default_rng(0).normal(0, 1, 200), [50.0]])
    s = boxplot_stats(x, outlier_sigmas=3.0)
    assert 50.0 in s["outliers"]
    assert s["upper_whisker"] < 50.0


def test_benchmark_fn_and_persistence(tmp_path):
    res = benchmark_fn(lambda: torch.ones(4) * 2, samples=2, evals=2,
                       name="toy", extra="meta")
    assert res.median_ms > 0
    assert res.meta["extra"] == "meta"
    path = str(tmp_path / "r.json")
    save_results(path, {"toy": res, "arr": torch.arange(3)})
    loaded = load_results(path)
    assert loaded["toy"]["name"] == "toy"
    assert loaded["arr"] == [0, 1, 2]


# ----------------------------------------------------------------------------
# drivers at a tiny size, with the JAX package's result layout
# ----------------------------------------------------------------------------

class _Stats(NamedTuple):
    iterations: jnp.ndarray
    status: jnp.ndarray


class _Sol(NamedTuple):
    X: jnp.ndarray
    U: jnp.ndarray
    duals: tuple
    stats: _Stats


def _fake_solve(prob, opts, U0=None, duals=None, **kw):
    z = jnp.zeros((), jnp.int32)
    return _Sol(X=jnp.zeros((prob.N, prob.n), prob.x0.dtype),
                U=jnp.zeros((prob.N - 1, prob.m), prob.x0.dtype),
                duals=prob.init_duals(1.0) if duals is None else duals,
                stats=_Stats(iterations=z, status=z + 1))


def _fake_rows(prob_mpc, opts, X, U, noise, **kw):
    T = noise.shape[0]
    return dict(altro_ms=[1.0] * T, baseline_ms=[1.0] * T, err_X=[0.0] * T,
                err_U=[0.0] * T, iters=[[1, 1]] * T, status=[[1, 1]] * T,
                cost_altro=[1.0] * T, cost_baseline=[1.0] * T,
                baseline_dyn_viol=[0.0] * T)


def _fake_admm(work, **kw):
    z = jnp.zeros((), jnp.int32)
    return _Stats(iterations=z, status=z + 1)


def _fake_sim(cfg, opts, tf=2.0, backend="altro", **kw):
    P = int(round(tf / cfg.update_dt))
    return dict(status=jnp.ones(P), mpc_ms=[1.0] * P, prep_ms=[1.0] * P,
                tick_ms=[1.0] * P, iters=jnp.ones(P))


class _FakeConicWork(NamedTuple):
    prob: object = None

    def replace(self, prob):
        return _FakeConicWork(prob)


class _FakeAdmmSol(NamedTuple):
    x: jnp.ndarray
    U: jnp.ndarray
    status: jnp.ndarray


def _fake_conic_solve(work, **kw):
    return _FakeAdmmSol(x=jnp.zeros(work.prob.P.shape[-1]), U=None,
                        status=jnp.ones((), jnp.int32))


def _fake_knot_solve(prob_k, **kw):
    return _FakeAdmmSol(x=None, U=jnp.zeros((prob_k.N - 1, prob_k.m)),
                        status=jnp.ones((), jnp.int32))


def _fake_native_conic(P, q, A, b, segments, **kw):
    return _FakeAdmmSol(x=np.zeros(P.shape[0]), U=None, status=1)


def _fake_make_mpc_step(prob_mpc, opts, X_track, U_track, *a, **kw):
    """The JAX package's step, as a stub: the carry's step index advances,
    the solution is zeros with status 1."""
    from altro_tpu.mpc import MPCResults

    def step(carry, noise_i):
        x0, X, U, duals, k = carry
        one = jnp.ones((), jnp.int32)
        return (x0, X, U, duals, k + 1), MPCResults(
            X=X, U=U, iters=one, status=one, viol=jnp.zeros(()), x0=x0)

    def init_carry():
        N, n, m = prob_mpc.N, prob_mpc.n, prob_mpc.m
        return (prob_mpc.x0, jnp.zeros((N, n)), jnp.zeros((N - 1, m)),
                prob_mpc.init_duals(1.0), jnp.zeros((), jnp.int32))
    return step, init_carry


def _stub_multibaseline(monkeypatch):
    """Stub the compute of the JAX package's four-solver studies (ALTRO's
    step, both ADMM solvers, the native solver): only their result layout
    is read."""
    import altro_tpu.mpc as jmpc
    from altro_tpu import native as jnative
    from altro_tpu.solver import admm_conic as jconic
    from altro_tpu.solver import knot_admm as jknot
    monkeypatch.setattr(jmpc, "make_mpc_step", _fake_make_mpc_step)
    monkeypatch.setattr(jconic, "setup", lambda data, **kw: _FakeConicWork())
    monkeypatch.setattr(jconic, "refactor",
                        lambda work, data: _FakeConicWork(data))
    monkeypatch.setattr(jconic, "solve", _fake_conic_solve)
    monkeypatch.setattr(jknot, "to_knot_qp", lambda prob: prob)
    monkeypatch.setattr(jknot, "setup", lambda kqp, **kw: None)
    monkeypatch.setattr(jknot, "refactor", lambda work, kqp: kqp)
    monkeypatch.setattr(jknot, "solve", _fake_knot_solve)
    monkeypatch.setattr(jnative, "solve_conic", _fake_native_conic)


DRIVERS = {
    "random_linear_horizon": (
        lambda m, **kw: m.random_linear_sweep("horizon", T=2, xs=[11], **kw)),
    "random_linear_state_dim": (
        lambda m, **kw: m.random_linear_sweep("state_dim", T=2, xs=[2],
                                              **kw)),
    "random_linear_control_dim": (
        lambda m, **kw: m.random_linear_sweep("control_dim", T=2, xs=[2],
                                              **kw)),
    "rocket": lambda m, **kw: m.rocket_tol_sweep(tols=(1e-4,), T=2, **kw),
    "grasp": lambda m, **kw: m.grasp_horizon_sweep(Ns=(11,), T=2, **kw),
    "flexsat": lambda m, **kw: m.flexsat_benchmark(T=1, trials=1, **kw),
    "quadruped": lambda m, **kw: m.quadruped_benchmark(tf=0.06, **kw),
    "rocket_multibaseline": (
        lambda m, **kw: m.rocket_multibaseline_tol(tols=(1e-2,), T=1, **kw)),
    "grasp_multibaseline": (
        lambda m, **kw: m.grasp_multibaseline_tol(tols=(1e-2,), T=1, **kw)),
}


def _keys(res):
    """Top-level keys, and the keys of the first nested row dict."""
    out = {"": set(res)}
    for k, v in res.items():
        if isinstance(v, dict) and v and isinstance(
                next(iter(v.values())), dict):
            out[k] = set(next(iter(v.values())))
        elif isinstance(v, list) and v and isinstance(v[0], dict):
            out[k] = set(v[0])
        elif isinstance(v, dict) and "ms_per_solve" in v:
            out[k] = set(v)
    return out


# the keys the port adds to the JAX package's, by driver and row level:
# the success rates that chip_smoke.py gates, and the quadruped's second
# race (the JAX package reports one)
EXTRA_KEYS = {("rocket", "rows"): {"success", "baseline_success"},
              ("flexsat", ""): {"altro_success", "qp_success"},
              ("quadruped", ""): {"cpp_race", "cpp_table_md"}}


@pytest.mark.parametrize("name", list(DRIVERS))
def test_driver_result_keys_match_jax(name, monkeypatch):
    import altro_tpu.bench.drivers as jdrv
    from altro_tpu.models.quadruped import controller as jctl
    from altro_tpu.solver import admm_qp as jqp
    monkeypatch.setattr(at, "solve", _fake_solve)
    monkeypatch.setattr(jdrv, "host_lockstep", _fake_rows)
    monkeypatch.setattr(jqp, "solve", _fake_admm)
    monkeypatch.setattr(jctl, "simulate_host", _fake_sim)
    if name.endswith("multibaseline"):
        _stub_multibaseline(monkeypatch)
    jres = DRIVERS[name](jdrv)
    res = DRIVERS[name](tdrv, device="cpu")
    jk, tk = _keys(jres), _keys(res)
    for k, v in jk.items():
        want = v | EXTRA_KEYS.get((name, k), set())
        if name == "quadruped" and k:
            # the port's quadruped rows add launch counts, replays and the
            # closed loop's final attitude to the JAX package's keys
            assert v <= tk[k], (k, v, tk[k])
        else:
            assert tk[k] == want, (k, want, tk[k])
