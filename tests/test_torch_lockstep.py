"""The ALTRO-vs-baseline oracles of the port in float64 on the CPU:
``run_mpc_lockstep`` on ``tests/test_random_linear_mpc.py``'s problem against
the JAX package's run (equal iterations and status, and the JAX test's
gates), ``run_mpc_lockstep_conic`` on the rocket (the tolerance sweep of
``tests/test_rocket.py``, T cut to 5) and on grasp (``tests/test_grasp.py``),
both also beside the JAX package's on the same tracking data,
the flexible satellite's cold solve against ``admm_qp``, the quadruped's
ALTRO against ``admm_qp`` and ``admm_conic`` (``tests/test_quadruped.py``),
``simulate_host`` with each ADMM backend for 3 periods against the JAX
package's ``native=False`` run (equal status and iterations, forces within
1e-6 N), the native entrants raising, the three harness tests of
``tests/test_harness.py``, and every benchmark driver at a tiny size with
the result keys of the JAX package's (whose compute is stubbed out: only
its result layout is read).
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
                             backend=backend, device="cpu")
    np.testing.assert_array_equal(res["status"].numpy(),
                                  np.asarray(jres["status"]))
    np.testing.assert_array_equal(res["iters"].numpy(),
                                  np.asarray(jres["iters"]))
    assert int(res["status"].min()) == 1
    np.testing.assert_allclose(res["forces"].numpy(),
                               np.asarray(jres["forces"]), atol=1e-6)
    # one chunk per 25 iterations of every solve, the warm-up's included
    assert res["admm_chunks"] > int(res["iters"].sum()) // 25


def test_native_entrants_raise():
    from altro_tpu_torch.models.quadruped import config, controller
    cfg = config.MPCConfig()
    prob, x_des = controller.build_mpc_problem(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="C\\+\\+-oracle"):
        controller.make_baseline_state("admm_qp", prob, cfg, x_des,
                                       native=True)
    with pytest.raises(NotImplementedError, match="C\\+\\+-oracle"):
        controller.simulate_host(cfg, tt.SolverOptions(**QUAD), tf=0.03,
                                 backend="admm_qp", device="cpu",
                                 native=True)
    for name in ("rocket_multibaseline", "grasp_multibaseline"):
        with pytest.raises(NotImplementedError, match="C\\+\\+-oracle"):
            tdrv.BENCHMARKS[name]("cpu", None)


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
# the success rates that chip_smoke.py gates
EXTRA_KEYS = {("rocket", "rows"): {"success", "baseline_success"},
              ("flexsat", ""): {"altro_success", "qp_success"}}


@pytest.mark.parametrize("name", list(DRIVERS))
def test_driver_result_keys_match_jax(name, monkeypatch):
    import altro_tpu.bench.drivers as jdrv
    from altro_tpu.models.quadruped import controller as jctl
    from altro_tpu.solver import admm_qp as jqp
    monkeypatch.setattr(at, "solve", _fake_solve)
    monkeypatch.setattr(jdrv, "host_lockstep", _fake_rows)
    monkeypatch.setattr(jqp, "solve", _fake_admm)
    monkeypatch.setattr(jctl, "simulate_host", _fake_sim)
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
