"""The port's copy of the native C++ oracles (``altro_tpu_torch/native``)
against the JAX package's (``altro_tpu.native``): the same sources and g++
flags, so identical numpy inputs give bit-equal results (dense ADMM QP, the
conic solver on the rocket window's transcription, the knot ADMM on a
quadruped trot QP, the AL-iLQR on a random-linear MPC step); its build
(its own library name, under the repository's ``build/``) and a failed
build raising with the compiler's output; and the port's ``osqp_ref``
against the JAX package's on ``tests/test_osqp_ref.py``'s instances."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from altro_tpu.native import qp as jnq  # noqa: E402

from altro_tpu_torch.convert import (numpy_tree,  # noqa: E402
                                     problem_from_numpy)
from altro_tpu_torch.native import qp as tnq  # noqa: E402

torch.set_num_threads(1)


def _box_qp(seed=0, n=24, m=40, n_eq=8):
    """``tests/test_osqp_ref.py``'s instance."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    P = M @ M.T + 0.1 * np.eye(n)
    q = rng.standard_normal(n)
    A = rng.standard_normal((m, n))
    l = -rng.random(m) - 0.1
    u = rng.random(m) + 0.1
    l[:n_eq] = u[:n_eq] = 0.1 * rng.standard_normal(n_eq)
    return P, q, A, l, u


def _equal(a, b, fields):
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)


SOLUTION = ("x", "y", "iterations", "r_prim", "r_dual", "status")


def test_build_and_library_name():
    tnq.load()
    assert tnq.available()
    path = tnq.lib_path()
    assert path.startswith(tnq.BUILD_DIR)
    assert "libaltro_tpu_torch_native_" in path
    assert path != jnq._lib_path()
    assert tnq._FLAGS == jnq._FLAGS
    for src in ("qp_solver.cpp", "knot_solver.cpp", "ilqr_solver.cpp"):
        with open(f"altro_tpu_torch/native/{src}", "rb") as a, \
                open(f"altro_tpu/native/{src}", "rb") as b:
            assert a.read() == b.read(), src


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    """A source g++ cannot compile: ``load`` raises with g++'s stderr,
    ``available`` reports it, and nothing is loaded."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("int broken( { return 0; }\n")
    monkeypatch.setattr(tnq, "_lib", None)
    monkeypatch.setattr(tnq, "_SRCS", (str(bad),))
    monkeypatch.setattr(tnq, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="broken.cpp"):
        tnq.load()
    assert not tnq.available()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnq.solve_qp(*_box_qp())


@pytest.mark.parametrize("seed", [0, 3, 5])
def test_solve_qp_bit_equal(seed):
    P, q, A, l, u = _box_qp(seed)
    if seed == 5:
        l[-5:], u[-5:] = -np.inf, np.inf
    _equal(tnq.solve_qp(P, q, A, l, u, eps_abs=1e-7),
           jnq.solve_qp(P, q, A, l, u, eps_abs=1e-7), SOLUTION)


@pytest.fixture(scope="module")
def rocket_window():
    """The rocket MPC window (N=21) tracking the hover rollout of the
    N=301 problem, in the port (no cold solve: the window's program class
    does not depend on the tracked trajectory)."""
    from altro_tpu_torch.models import rocket
    from altro_tpu_torch.mpc import gen_tracking_mpc, one_scenario
    N = 301
    prob = rocket.rocket_problem(N=N, tf=(N - 1) * 0.05,
                                 dtype=torch.float64, device="cpu")
    U = rocket.hover_controls(prob)
    X = prob.dynamics.rollout(prob.x0, U)
    return one_scenario(gen_tracking_mpc(prob, X, U, 21, dt=0.05))


def test_solve_conic_bit_equal_on_rocket_window(rocket_window):
    """The port's transcription of the window, through the port's thin
    helper (``conic_arrays``: lane 0, on the CPU, float64), into both
    copies."""
    from altro_tpu_torch.transcribe import to_batch_conic
    data = to_batch_conic(rocket_window)
    P, q, A, b, segments = tnq.conic_arrays(data)
    assert P.shape == (data.num_vars,) * 2 and P.dtype == np.float64
    for eps in (1e-4, 1e-9):
        got = tnq.solve_conic(P, q, A, b, segments, eps_abs=eps,
                              max_iter=300000)
        assert got.status == 1
        _equal(got, jnq.solve_conic(P, q, A, b, segments, eps_abs=eps,
                                    max_iter=300000), SOLUTION)


def _jax_knot_qp(kqp, lane=0):
    """The JAX package's KnotQP of lane ``lane`` of the port's, from the
    same numpy arrays."""
    from altro_tpu.cones import Cone as JCone
    from altro_tpu.solver.knot_admm import KnotQP as JKnotQP

    def arr(t):
        return np.asarray(t.detach().cpu().numpy()[lane])
    return JKnotQP(Q=arr(kqp.Q), q=arr(kqp.q), R=arr(kqp.R), r=arr(kqp.r),
                   A=arr(kqp.A), B=arr(kqp.B), d=arr(kqp.d),
                   x0=arr(kqp.x0), Cx=tuple(arr(c) for c in kqp.Cx),
                   Cu=tuple(arr(c) for c in kqp.Cu),
                   l=tuple(arr(c) for c in kqp.l),
                   u=tuple(arr(c) for c in kqp.u),
                   cones=tuple(JCone(c.value) for c in kqp.cones))


@pytest.mark.parametrize("lin", [True, False], ids=["qp", "socp"])
def test_knot_admm_bit_equal_on_trot_qp(lin):
    """The closed loop's workspace (set up on the all-stance linearization)
    updated with a trot instance (two legs about to swing), then solved
    from zero, warm, and with the polish, in both copies from the same
    arrays."""
    from altro_tpu_torch.models.quadruped import config, controller, planner
    from altro_tpu_torch.models.quadruped.gait import GAITS
    from altro_tpu_torch.solver import knot_admm
    cfg = config.MPCConfig(linearized_friction=lin)
    prob, x_des = controller.build_mpc_problem(cfg, device="cpu")
    work = controller.make_baseline_state("admm_qp", prob, cfg, x_des)
    assert isinstance(work, tnq.NativeKnotWork)
    jwork = jnq.knot_setup(_jax_knot_qp(controller.baseline_knot_qp(
        prob, cfg, x_des)), rho=0.1)
    gait = GAITS[cfg.gait_type](cfg.stance_time, cfg.swing_time)
    x_ref = x_des.expand(cfg.N, 12)
    feet = x_des[0:3][None, :] + planner.nominal_foot_locations(
        dtype=torch.float64, device="cpu")
    contacts, locs, _ = planner.foot_history(
        torch.tensor(0.05, dtype=torch.float64), x_ref, feet, feet, gait,
        x_des, cfg.N, cfg.dynamics_discretization)
    x_curr = x_des + 0.01 * torch.as_tensor(
        np.random.default_rng(3).standard_normal(12))
    pk = controller._linearized_problem(prob, x_curr[None], x_ref, contacts,
                                        locs, cfg.dynamics_discretization)
    kqp = knot_admm.to_knot_qp(pk)
    work.update(kqp)
    jwork.update(_jax_knot_qp(kqp))
    fields = ("X", "U", "iterations", "r_prim", "r_dual", "status")
    for kw in (dict(eps_abs=1e-4, check_every=10),
               dict(eps_abs=1e-4, check_every=10, warm=True),
               dict(eps_abs=1e-3, check_every=5, warm=True, polish=True)):
        got = work.solve(**kw)
        assert got.status == 1
        _equal(got, jwork.solve(**kw), fields)


def test_ilqr_bit_equal_on_random_linear_step():
    """A cold solve and one warm MPC step (retargeted window, shifted
    controls and multipliers) of the random-linear problem (n=12, m=6,
    N=21), the JAX problem converted to the port's, so both copies read the
    same arrays."""
    import altro_tpu as at
    from altro_tpu.costs import retarget_tracking
    from altro_tpu.models import random_linear as jrl
    from altro_tpu.mpc import track_window

    import altro_tpu_torch as tt
    rng = np.random.default_rng(0)
    prob = jrl.gen_random_linear(rng, 12, 6, 33, dtype=jnp.float64)
    X_track, U_track = jrl.gen_trajectory(rng, prob, 33)
    pm = jrl.gen_tracking_mpc(prob, X_track, U_track, 21)
    kw = dict(cost_tolerance=1e-4, gradient_tolerance=1e-4,
              constraint_tolerance=1e-4, penalty_initial=1e3,
              penalty_scaling=100.0, reset_duals=False)
    jw, tw = jnq.ilqr_setup(pm), tnq.ilqr_setup(
        problem_from_numpy(numpy_tree(pm)))
    fields = ("X", "U", "lam", "iterations", "outer_iterations", "viol",
              "gradient", "status")
    js, ts = jw.solve(at.SolverOptions(**kw)), tw.solve(tt.SolverOptions(**kw))
    assert ts.status == 1
    _equal(ts, js, fields)
    Xw, Uw = track_window(X_track, U_track, 1, 21)
    pk = pm.replace(cost=retarget_tracking(pm.cost, Xw, Uw),
                    x0=jnp.asarray(js.X[1]))
    jw.update(pk)
    tw.update(problem_from_numpy(numpy_tree(pk)))
    U0 = np.concatenate([js.U[1:], js.U[-1:]], 0)
    lam0 = np.concatenate([js.lam[1:], js.lam[-1:]], 0)
    _equal(tw.solve(tt.SolverOptions(**kw), U0=torch.as_tensor(U0),
                    lam0=lam0),
           jw.solve(at.SolverOptions(**kw), U0=U0, lam0=lam0), fields)


# ------------------------------------------------------------ osqp_ref

@pytest.mark.parametrize("seed,loose", [(0, False), (3, False), (5, True)])
def test_osqp_ref_matches_jax_copy(seed, loose):
    """The port's copy against the JAX package's on the same instances:
    a cold solve, and (seed 3) the warm resume after an update of q, equal
    bit for bit."""
    from altro_tpu.solver.osqp_ref import OSQPRef as JRef

    from altro_tpu_torch.solver.osqp_ref import OSQPRef as TRef
    P, q, A, l, u = _box_qp(seed)
    if loose:
        l[-5:], u[-5:] = -np.inf, np.inf
    kw = dict(eps_abs=1e-6, eps_rel=1e-6, max_iter=50000)
    jo, to = JRef(P, q, A, l, u, **kw), TRef(P, q, A, l, u, **kw)
    fields = ("x", "y", "iterations", "status")
    got = to.solve()
    assert got.status == 1
    _equal(got, jo.solve(), fields)
    if seed == 3:
        q2 = q + 1e-3 * np.random.default_rng(9).standard_normal(q.shape)
        jo.update(q=q2)
        to.update(q=q2)
        _equal(to.solve(), jo.solve(), fields)


def test_osqp_ref_matches_native_oracle():
    """``tests/test_osqp_ref.py``'s check on the port's pair: the OSQP
    reference against the port's native dense ADMM at a tight
    tolerance."""
    from altro_tpu_torch.solver.osqp_ref import OSQPRef
    P, q, A, l, u = _box_qp()
    r = OSQPRef(P, q, A, l, u, eps_abs=1e-7, eps_rel=1e-7,
                max_iter=50000).solve()
    rn = tnq.solve_qp(P, q, A, l, u, eps_abs=1e-8, max_iter=200000)
    assert r.status == 1 and rn.status == 1
    assert np.max(np.abs(r.x - rn.x)) < 1e-4


def test_single_latency_rows():
    """``bench/single_latency.py``: the native AL-iLQR's warm loop takes the
    JAX package's driver's iterations and violations (its ``native_row``,
    same seed) at N=11 over 5 steps; the graphed row runs the port's warm
    step at B=1 (on the CPU here: the fixed-buffer route)."""
    from altro_tpu.bench import single_latency as jsl

    from altro_tpu_torch.bench import single_latency as tsl
    got, ref = tsl.native_row(11, T=5), jsl.native_row(11, T=5)
    assert got["mean_iters"] == ref["mean_iters"]
    assert got["max_viol"] == pytest.approx(ref["max_viol"], rel=1e-9)
    row = tsl.graphed_row(11, T=2, device="cpu")
    assert row["success"] == 1.0 and row["step_ms_mean"] > 0
