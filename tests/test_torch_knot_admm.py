"""The port's knot-structured ADMM (``solver/knot_admm.py``) in float64 on
the CPU: the four cases of ``tests/test_knot_admm.py`` (against the dense
solvers on the random-linear QP and grasp's conic problem, refactor against
a fresh setup, a batch of scenarios against single solves), parity with the
JAX package's knot ADMM on the quadruped's QP and SOCP from its closed
loop's workspace, on bit-equal data carried over as numpy arrays
(``convert.knot_qp_from_numpy``; gates: equal iterations and status,
max|dX| and max|dU| <= 1e-8), a refactor whose band is not finite keeping
the old band and rho, and the fixed-buffer route (``graphed=True`` on the
CPU) bit for bit against the eager loop.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from altro_tpu.solver import knot_admm as jknot  # noqa: E402

from altro_tpu_torch import convert  # noqa: E402
from altro_tpu_torch.models import random_linear as rl  # noqa: E402
from altro_tpu_torch.solver import admm_conic, admm_qp  # noqa: E402
from altro_tpu_torch.solver import knot_admm  # noqa: E402
from altro_tpu_torch.transcribe import (extract_traj,  # noqa: E402
                                        to_batch_conic, to_batch_qp)

torch.set_num_threads(1)


def _rl(seed, n, m, N):
    rng = np.random.default_rng(seed)
    prob = rl.gen_random_linear(rng, n, m, N)
    X, U = rl.gen_trajectory(rng, prob, N)
    pm = rl.gen_tracking_mpc(prob, X, U, N)
    return dataclasses.replace(pm, x0=pm.x0[None]), rng


def test_knot_matches_dense_on_random_linear():
    pm, _ = _rl(7, 8, 3, 21)
    qp = to_batch_qp(pm)
    dense = admm_qp.solve(admm_qp.setup(qp), eps_abs=1e-8, max_iter=40000)
    Xd, Ud = extract_traj(qp, dense.x)
    ks = knot_admm.solve(knot_admm.setup(knot_admm.to_knot_qp(pm)),
                         eps_abs=1e-8, max_iter=40000)
    assert int(dense.status[0]) == 1 and int(ks.status[0]) == 1
    np.testing.assert_allclose(ks.X, Xd, atol=1e-6)
    np.testing.assert_allclose(ks.U, Ud, atol=1e-6)


def test_knot_matches_dense_conic_on_grasp():
    """The SOC path: torque-balance equality, max-force inequality and two
    SOC friction cones per knot."""
    from altro_tpu_torch.models import grasp
    N, tf = 31, 3.0
    prob = grasp.grasp_problem(grasp.make_grasp_object(N, tf), N, tf)
    prob = dataclasses.replace(prob, x0=prob.x0[None])
    cp = to_batch_conic(prob)
    dense = admm_conic.solve(admm_conic.setup(cp), eps_abs=1e-7,
                             max_iter=100000)
    _, Ud = extract_traj(cp, dense.x)
    ks = knot_admm.solve(knot_admm.setup(knot_admm.to_knot_qp(prob)),
                         eps_abs=1e-7, max_iter=100000)
    assert int(dense.status[0]) == 1 and int(ks.status[0]) == 1
    np.testing.assert_allclose(ks.U, Ud, atol=1e-4)


def test_knot_refactor_matches_fresh_setup():
    """refactor() (setup-once scalings + banded refactor) solves a
    perturbed instance to the same answer as a fresh setup()."""
    pm, _ = _rl(3, 6, 2, 15)
    work0 = knot_admm.setup(knot_admm.to_knot_qp(pm))
    dyn = pm.dynamics
    pm2 = dataclasses.replace(pm, dynamics=dataclasses.replace(
        dyn, A=dyn.A * 1.01, d=dyn.d + 0.01), x0=pm.x0 + 0.05)
    kqp2 = knot_admm.to_knot_qp(pm2)
    s_ref = knot_admm.solve(knot_admm.refactor(work0, kqp2), eps_abs=1e-8,
                            max_iter=40000)
    s_fresh = knot_admm.solve(knot_admm.setup(kqp2), eps_abs=1e-8,
                              max_iter=40000)
    assert int(s_ref.status[0]) == 1 and int(s_fresh.status[0]) == 1
    np.testing.assert_allclose(s_ref.U, s_fresh.U, atol=1e-6)


def test_knot_batch_matches_single_solves():
    """Four scenarios (their own x0) as one batch: each lane is its single
    solve, iterations and all."""
    pm, rng = _rl(11, 6, 2, 15)
    x0s = pm.x0 + torch.tensor(0.1 * rng.standard_normal((4, pm.n)))
    batch = knot_admm.solve(knot_admm.setup(knot_admm.to_knot_qp(
        dataclasses.replace(pm, x0=x0s))), eps_abs=1e-6)
    assert int(batch.status.min()) == 1
    for lane in (0, 2):
        single = knot_admm.solve(knot_admm.setup(knot_admm.to_knot_qp(
            dataclasses.replace(pm, x0=x0s[lane:lane + 1]))), eps_abs=1e-6)
        assert int(single.iterations[0]) == int(batch.iterations[lane])
        np.testing.assert_allclose(batch.U[lane], single.U[0], atol=1e-8)


@pytest.fixture(scope="module")
def jax_quadruped():
    """The JAX package's quadruped problem at t = 0.05 s from a perturbed
    stance (the test_quadruped scenario) in both friction models, with its
    closed loop's setup-once workspace: {lin: (knot QP, workspace)}."""
    from altro_tpu.models.quadruped import config, controller, gait, planner
    out = {}
    for lin in (True, False):
        cfg = config.MPCConfig(linearized_friction=lin)
        g = gait.trot(cfg.stance_time, cfg.swing_time)
        prob, x_des = controller.build_mpc_problem(cfg)
        x_curr = x_des + jnp.asarray(
            np.random.default_rng(3).standard_normal(12)) * 0.01
        x_ref = jnp.tile(x_des, (cfg.N, 1))
        feet = planner.nominal_foot_locations() + x_des[0:3][None, :]
        c, f, _ = jax.jit(planner.foot_history, static_argnums=(6, 7))(
            0.05, x_ref, feet, feet, g, x_des, cfg.N,
            cfg.dynamics_discretization)
        pk = jax.jit(controller._linearized_problem, static_argnums=5)(
            prob, x_curr, x_ref, c, f, cfg.dynamics_discretization)
        work = jax.jit(lambda p, x, cfg=cfg: controller.make_baseline_state(
            "admm_qp", p, cfg, x, native=False))(prob, x_des)
        out[lin] = (jax.jit(jknot.to_knot_qp)(pk), work)
    return out


@pytest.mark.parametrize("lin", [True, False], ids=["qp", "socp"])
def test_knot_matches_jax_on_quadruped(jax_quadruped, lin):
    """The closed loop's solve: the workspace (scalings from the JAX
    package's, carried over with its factor) refactored for the instance,
    from zero, at the closed loop's eps_abs 1e-4."""
    kqp, jwork = jax_quadruped[lin]
    jsol = jax.jit(lambda w, q: jknot.solve(jknot.refactor(w, q),
                                            eps_abs=1e-4))(jwork, kqp)
    tq = convert.knot_qp_from_numpy(convert.numpy_tree(kqp))
    tree = convert.numpy_tree(jwork)
    tq0 = convert.knot_qp_from_numpy(tree["qp"])

    def lane(a):
        return torch.tensor(np.asarray(a))[None]
    twork = knot_admm.KnotADMMWork(
        qp=tq0, Linv=lane(tree["Linv"]), F=lane(tree["F"]),
        Dx=lane(tree["Dx"]), Du=lane(tree["Du"]), E_dyn=lane(tree["E_dyn"]),
        E_x0=lane(tree["E_x0"]),
        E_blk=tuple(lane(e) for e in tree["E_blk"]),
        csc=lane(tree["csc"]), rho=lane(tree["rho"]),
        eq_blk=tuple(tree["eq_blk"]))
    tsol = knot_admm.solve(knot_admm.refactor(twork, tq), eps_abs=1e-4)
    assert int(jsol.iterations) == int(tsol.iterations[0])
    assert int(jsol.status) == int(tsol.status[0]) == 1
    for f in ("X", "U"):
        err = np.abs(np.asarray(getattr(jsol, f))
                     - getattr(tsol, f)[0].numpy()).max()
        assert err <= 1e-8, (f, err)
    # the port's own workspace from its own build agrees too
    from altro_tpu_torch.bench.baselines import quadruped_instance
    prob_k, own = quadruped_instance(lin, "cpu")
    osol = knot_admm.solve(knot_admm.refactor(
        own, knot_admm.to_knot_qp(prob_k)), eps_abs=1e-4)
    assert int(osol.iterations[0]) == int(jsol.iterations)
    np.testing.assert_allclose(osol.U[0], np.asarray(jsol.U), atol=1e-8)


def test_failed_refactor_keeps_old_band_and_rho():
    """``knot_admm._refactor`` on two lanes whose rho both adapt: lane 0's
    band is made indefinite (Q = -I dominates at rho = 1e-6), so it keeps
    its band and rho; lane 1 takes the new ones."""
    pm, _ = _rl(5, 4, 2, 6)
    pm = dataclasses.replace(pm, x0=pm.x0.expand(2, -1))
    kqp = knot_admm.to_knot_qp(pm)
    Q = kqp.Q.clone()
    Q[0] = -torch.eye(4, dtype=Q.dtype)
    kqp = dataclasses.replace(kqp, Q=Q)
    work = knot_admm.setup(kqp, rho=1e3)
    assert torch.isfinite(work.Linv).all()
    st = knot_admm._scaled_stacks(kqp, work.Dx, work.Du, work.E_dyn,
                                  work.E_x0, work.E_blk, work.csc)
    d = dataclasses.make_dataclass("D", ["st", "qp"])(st, kqp)
    s = (None,) * 4 + (work.rho, work.Linv, work.F) + (None,) * 4
    prop = (torch.tensor([1e-6, 2e3], dtype=torch.float64),
            torch.tensor([True, True]))
    out = knot_admm._refactor(((None,), work.eq_blk), d, s, prop)
    L_new, _ = knot_admm._factor(st, kqp.dims, prop[0], work.eq_blk)
    assert not torch.isfinite(L_new[0]).all() and torch.isfinite(
        L_new[1]).all()
    assert torch.equal(out[4], torch.tensor([1e3, 2e3], dtype=torch.float64))
    assert torch.equal(out[5][0], work.Linv[0])
    assert torch.equal(out[6][0], work.F[0])
    assert torch.equal(out[5][1], L_new[1])


def test_fixed_buffer_route_matches_eager_loop():
    """``graphed=True`` on the CPU against the eager loop, bit for bit, on
    two scenarios of the grasp window (SOC blocks), then on a refactored
    instance of the same structure (new x0), which reuses the route's
    buffers."""
    from altro_tpu_torch.models import grasp
    from altro_tpu_torch.mpc import gen_tracking_mpc
    N, tf = 31, 3.0
    o = grasp.make_grasp_object(N, tf)
    prob = grasp.grasp_problem(o, N, tf)
    rng = np.random.default_rng(2)
    pm = gen_tracking_mpc(prob, torch.tensor(rng.standard_normal((N, 6))),
                          torch.tensor(rng.standard_normal((N - 1, 6))), 11)
    pm = dataclasses.replace(pm, constraints=grasp.grasp_constraints(o, 11),
                             x0=torch.tensor(rng.standard_normal((2, 6))))
    work = knot_admm.setup(knot_admm.to_knot_qp(pm))
    for x0 in (pm.x0, torch.tensor(rng.standard_normal((2, 6)))):
        work = knot_admm.refactor(work, knot_admm.to_knot_qp(
            dataclasses.replace(pm, x0=x0)))
        e = knot_admm.solve(work, eps_abs=1e-6, graphed=False)
        g = knot_admm.solve(work, eps_abs=1e-6, graphed=True)
        for f in ("X", "U", "iterations", "r_prim", "r_dual", "status"):
            assert torch.equal(getattr(e, f), getattr(g, f)), f
        assert e.chunks == g.chunks
    assert len(work.graphs) == 1
