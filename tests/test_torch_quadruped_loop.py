"""The quadruped closed loop of the port against the JAX package in float64
on the CPU: the new model pieces (inverse kinematics with the FK round trip,
the leg Jacobian, force to torque, the RK4 plant with non-unit scales, the
MRP of a quaternion, the swing splines and PD forces), the YAML loaders, one
and 30 control ticks across a stance-to-swing release and the replans after
it, one MPC solve per friction model, 10 periods of the closed loop on the
nominal plant and 5 on the mismatched one, the fixed-buffer route against
the eager loop bit for bit, the LQR oracles and the solver against the
finite-horizon LQR recursion; the repair that lets the pieces run on any
device (the flat bench's float64 build unchanged bit for bit, float32 in,
float32 out); and, marked ``cuda``, the pieces on the card against the CPU,
kernels B, C and A at the closed loop's shapes against their plain
versions, and the closed loop graphed against eager on the card.

Tolerances: the pieces to 1e-12, except where a value is computed from a
swing spline. A spline is a monomial cubic in absolute time: its 4 x 4
system has a condition number of 1e6-1e9 over the first seconds, so two
LU factorizations (LAPACK's in the port, XLA's in the JAX package) agree on
its coefficients only to ~1e-12 of their size (up to ~2e3 here); the
coefficients are compared to 1e-12 of their size and through the splines'
positions and slopes on their interval (to 1e-12 of max(1, their size)),
and the PD force, whose gain kp = 1e4 scales the last bits of a position,
to 1e-12 of its own size. The ticks to 1e-10
(their torques to 1e-10 of their size, as they carry the PD force); the
closed loop to 1e-8 in x and 1e-6 in forces.
"""
import dataclasses
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax
    import jax.numpy as jnp

    import altro_tpu as at
    from altro_tpu.models.quadruped import config as jconfig
    from altro_tpu.models.quadruped import controller as jctl
    from altro_tpu.models.quadruped import gait as jgait
    from altro_tpu.models.quadruped import kinematics as jkin
    from altro_tpu.models.quadruped import planner as jplanner
    from altro_tpu.models.quadruped import srb as jsrb
    from altro_tpu.models.quadruped import swing as jswing
    from altro_tpu.utils import lqr as jlqr
except ImportError:
    # the machine with the card has no JAX: only the cuda-marked tests,
    # which read none of it, run there
    jax = None

import altro_tpu_torch as tt  # noqa: E402
from altro_tpu_torch.bench.families import quadruped_setup  # noqa: E402
from altro_tpu_torch.models.quadruped import config as tconfig  # noqa: E402
from altro_tpu_torch.models.quadruped import controller as tctl  # noqa: E402
from altro_tpu_torch.models.quadruped import gait as tgait  # noqa: E402
from altro_tpu_torch.models.quadruped import kinematics as tkin  # noqa: E402
from altro_tpu_torch.models.quadruped import planner as tplanner  # noqa: E402
from altro_tpu_torch.models.quadruped import srb as tsrb  # noqa: E402
from altro_tpu_torch.models.quadruped import swing as tswing  # noqa: E402
from altro_tpu_torch.solver.graph import tensors  # noqa: E402
from altro_tpu_torch.utils import lqr as tlqr  # noqa: E402

torch.set_num_threads(1)
F64 = torch.float64
OPTS = dict(cost_tolerance=1e-4, constraint_tolerance=1e-4,
            penalty_initial=10.0, penalty_scaling=100.0, reset_duals=False)
LOOP_TF, MISMATCH_TF = 0.3, 0.15        # 10 and 5 periods of 30 ms
PLANT = dict(mass_scale=1.10, inertia_scale=0.90,
             foot_offset=[0.003, 0.0015, 0.0], kick_impulse=[0.0, 0.1, 0.0],
             kick_t=0.06)
# the float64 flat bench setup (families.quadruped_setup, B=16) as built
# before the pieces became device-aware: sha256 of every tensor's bytes and
# one x0 draw
FLAT_DIGEST = {
    True: "1adb23e9a591a75b94eae5733166f46a3b42e1077c9a0aa3737ff1fcf0c68f93",
    False: "3014e2ef017413d4b85391fb48795bff5458418d670a36fed9b1db185b75ceef"}


def T(a, dtype=F64, device="cpu"):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def J(a):
    return jnp.asarray(np.asarray(a))


def close(t, j, atol=1e-12):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(t).cpu()),
                               np.asarray(j), atol=atol, rtol=0)


def close_rel(t, j, rel):
    """|t - j| <= rel * max(1, max|j|)."""
    j = np.asarray(j)
    close(t, j, atol=rel * max(1.0, float(np.abs(j).max())))


# ------------------------------------------------------------------ pieces

def test_inverse_kinematics_and_round_trip():
    rng = np.random.default_rng(0)
    for _ in range(10):
        alpha = rng.uniform(-0.4, 0.4, 12)
        feet = tkin.forward_kinematics_all(T(alpha))
        a_t = tkin.inverse_kinematics_all(feet)
        close(a_t, jkin.inverse_kinematics_all(J(feet)))
        close(tkin.forward_kinematics_all(a_t), feet, atol=1e-8)
        for leg in range(4):
            close(tkin.inverse_kinematics(feet[3 * leg:3 * leg + 3], leg),
                  jkin.inverse_kinematics(J(feet[3 * leg:3 * leg + 3]), leg))
    # out of reach: the floors and the clip before arccos
    far = T(np.tile([0.0, 0.0, -2.0], 4))
    close(tkin.inverse_kinematics_all(far), jkin.inverse_kinematics_all(
        J(far)))


def test_leg_jacobian_and_force_to_torque():
    rng = np.random.default_rng(1)
    for _ in range(5):
        alpha = rng.uniform(-0.5, 0.5, 12)
        f = 30.0 * rng.standard_normal(12)
        for leg in range(4):
            a = alpha[3 * leg:3 * leg + 3]
            close(tkin.leg_jacobian(T(a), leg), jkin.leg_jacobian(J(a), leg))
        close(tkin.force_to_torque(T(f), T(alpha)),
              jkin.force_to_torque(J(f), J(alpha)))


def test_rk4_plant_and_mrp_from_quat():
    rng = np.random.default_rng(2)
    for scales in ((1.0, 1.0), (1.1, 0.9), (0.8, 1.3)):
        x = np.concatenate([[0.0, 0.0, 0.28], 0.05 * rng.standard_normal(9)])
        u = np.tile([0.0, 0.0, 40.0], 4) + 5.0 * rng.standard_normal(12)
        locs = np.asarray(jplanner.nominal_foot_locations()) \
            + 0.01 * rng.standard_normal((4, 3))
        contacts = np.asarray([1.0, 0.0, 0.0, 1.0])
        args = (x, u, locs, contacts)
        close(tsrb.rk4_plant(*map(T, args), 1e-3, *map(T, scales)),
              jsrb.rk4_plant(*map(J, args), 1e-3, *map(J, scales)))
        close(tsrb.continuous_dynamics(*map(T, args), *scales),
              jsrb.continuous_dynamics(*map(J, args), *scales))
    for w in (0.9, -0.9):
        q = np.concatenate([[w], rng.standard_normal(3)])
        q /= np.linalg.norm(q)
        close(tsrb.mrp_from_quat(T(q)), jsrb.mrp_from_quat(J(q)))


def _swing_case(rng, t0):
    x = np.concatenate([[0.01, -0.02, 0.28], 0.02 * rng.standard_normal(3),
                        0.1 * rng.standard_normal(6)])
    rot = np.asarray(jsrb.mrp_rotation(J(x[3:6])))
    fb = np.asarray([0.23, -0.17, -0.26]) + 0.01 * rng.standard_normal(3)
    fv = 0.1 * rng.standard_normal(3)
    nf = np.asarray([0.25, -0.17, 0.02]) + 0.02 * rng.standard_normal(3)
    return x, rot, fb, fv, nf, t0, t0 + rng.uniform(0.05, 0.2)


def test_swing_splines_targets_and_pd_forces():
    rng = np.random.default_rng(3)
    for t0 in (0.0, 0.2, 0.23, 0.6, 0.61):
        x, rot, fb, fv, nf, t0, tf = _swing_case(rng, t0)
        args = (x, rot, fb, fv, nf, t0, tf)
        cj = np.asarray(jswing.foot_trajectory_coeffs(*map(J, args), 0.05))
        ct = tswing.foot_trajectory_coeffs(*map(T, args), 0.05)
        close_rel(ct, cj, 1e-12)
        # the splines the coefficients define, on their interval
        for s in np.linspace(t0, tf, 5):
            close_rel(torch.stack(tswing.swing_foot_target(ct, T(s))),
                      np.stack(jswing.swing_foot_target(J(cj), s)), 1e-12)
        # the height cubic kept on a replan
        prev = rng.standard_normal(4)
        close_rel(tswing.foot_trajectory_coeffs(*map(T, args), 0.05,
                                                prev_z_coeffs=T(prev),
                                                regen_z=False),
                  jswing.foot_trajectory_coeffs(*map(J, args), 0.05,
                                                prev_z_coeffs=J(prev),
                                                regen_z=False), 1e-12)
        # PD force around the same spline (the JAX package's coefficients)
        s = t0 + 0.3 * (tf - t0)
        close_rel(tswing.swing_pd_force(T(x), T(rot), T(cj), T(fb), T(fv),
                                        T(s), omega=100.0, zeta=1.0),
                  jswing.swing_pd_force(J(x), J(rot), J(cj), J(fb), J(fv), s,
                                        omega=100.0, zeta=1.0), 1e-12)
    # four legs at once equal the legs one by one
    cases = [_swing_case(rng, 0.2) for _ in range(4)]
    legs = [T(np.stack([c[i] for c in cases])) for i in (2, 3, 4, 6)]
    x, rot = T(cases[0][0]), T(cases[0][1])
    batched = tswing.foot_trajectory_coeffs(x, rot, legs[0], legs[1],
                                            legs[2], T(0.2), legs[3], 0.05)
    for i, c in enumerate(cases):
        one = tswing.foot_trajectory_coeffs(x, rot, *map(T, c[2:5]), T(0.2),
                                            T(c[6]), 0.05)
        close_rel(batched[i], one.numpy(), 1e-12)


def test_yaml_loaders(tmp_path):
    pytest.importorskip("yaml")
    from examples.quadruped_yaml import YAML_TEMPLATE
    from altro_tpu_torch.examples.quadruped_yaml import (
        YAML_TEMPLATE as PORT_TEMPLATE)
    assert PORT_TEMPLATE == YAML_TEMPLATE
    for solver, lin in (("ALTRO", "true"), ("ECOS", "false")):
        p = tmp_path / f"mpc_{solver}.yaml"
        p.write_text(YAML_TEMPLATE.format(solver=solver, linearized=lin)
                     + "q: [" + ", ".join(["2.0"] * 12) + "]\n")
        assert (dataclasses.asdict(tconfig.mpc_config_from_yaml(str(p)))
                == dataclasses.asdict(jconfig.mpc_config_from_yaml(str(p))))
    w = tmp_path / "woofer.yaml"
    w.write_text("inertial:\n  frame_mass: 3.5\n  body_ix: 0.03\n  extra: 1\n"
                 "geometry:\n  hip_center_x: 0.25\n"
                 "actuator:\n  max_joint_torque: 10.0\n")
    assert (dataclasses.asdict(tconfig.WooferConfig.from_yaml(str(w)))
            == dataclasses.asdict(jconfig.WooferConfig.from_yaml(str(w))))


# ------------------------------------------------------------ control ticks

def _random_states(seed: int, t_start: float):
    """A seeded SimState just before the stance -> swing release at 0.2 s
    (phase 0, all feet down), in both packages."""
    rng = np.random.default_rng(seed)
    cfg = jconfig.MPCConfig()
    jprob, jx_des = jctl.build_mpc_problem(cfg)
    s = jctl.initial_state(jprob, jx_des, at.SolverOptions(**OPTS))
    fields = dict(
        x=np.asarray(s.x) + np.concatenate([0.01 * rng.standard_normal(6),
                                            0.05 * rng.standard_normal(6)]),
        feet_w=np.asarray(s.feet_w) + 0.005 * rng.standard_normal((4, 3)),
        prev_feet_b=np.asarray(s.prev_feet_b)
        + 0.005 * rng.standard_normal((4, 3)),
        swing_coeffs=rng.standard_normal((4, 12)),
        planner_foot_loc=np.asarray(s.planner_foot_loc)
        + 0.01 * rng.standard_normal((4, 3)),
        next_foot_loc=np.asarray(s.next_foot_loc)
        + 0.01 * rng.standard_normal((4, 3)),
        swing_tf=rng.uniform(0.0, 0.2, 4),
        last_replan_t=np.asarray(t_start - 0.003),
        forces=np.asarray(s.forces) + 3.0 * rng.standard_normal(12))
    js = s.replace(**{k: jnp.asarray(v) for k, v in fields.items()},
                   prev_phase=jnp.asarray(0, jnp.int32))
    tprob, tx_des = tctl.build_mpc_problem(tconfig.MPCConfig(), device="cpu")
    ts = tctl.initial_state(tprob, tx_des, tt.SolverOptions(**OPTS))
    ts = dataclasses.replace(ts, **{k: T(v) for k, v in fields.items()})
    return cfg, js, jx_des, ts, tx_des


def _compare_states(ts, js, atol):
    for f in ("x", "feet_w", "prev_feet_b", "swing_coeffs",
              "planner_foot_loc", "next_foot_loc", "swing_tf",
              "last_replan_t"):
        close_rel(getattr(ts, f), getattr(js, f), atol)
    assert int(ts.prev_phase) == int(js.prev_phase)


@pytest.mark.parametrize("ticks, t_start", [(1, 0.2), (30, 0.19)])
def test_control_ticks_match_jax(ticks, t_start):
    cfg, js, jx_des, ts, tx_des = _random_states(ticks, t_start)
    jg = jgait.GAITS[cfg.gait_type](cfg.stance_time, cfg.swing_time)
    tg = tgait.GAITS[cfg.gait_type](cfg.stance_time, cfg.swing_time)
    tcfg = tconfig.MPCConfig()
    jtick = jax.jit(lambda s, t: jctl.control_tick(s, t, jg, cfg, jx_des))
    released = replans = 0
    for j in range(ticks):
        t = t_start + j * jctl.DT_SIM
        phase = int(tg.phase_at(T(t)))
        released += int(phase != int(ts.prev_phase))
        replans += int(phase in (1, 3) and t - float(ts.last_replan_t)
                       > cfg.footstep_replan)
        js, jtau = jtick(js, jnp.asarray(t))
        ts, ttau = tctl.control_tick(ts, T(t), tg, tcfg, tx_des)
        _compare_states(ts, js, 1e-10)
        close_rel(ttau, jtau, 1e-10)
    assert released >= 1 and (ticks == 1 or replans >= 2)


# ----------------------------------------------------------- one MPC solve

@pytest.mark.parametrize("lin", [True, False])
def test_mpc_solve_forces_matches_jax(lin):
    cfg = jconfig.MPCConfig(linearized_friction=lin)
    jprob, jx_des = jctl.build_mpc_problem(cfg)
    x_curr = np.asarray(jx_des) + 0.01 * np.random.default_rng(3) \
        .standard_normal(12)
    x_ref = jnp.tile(jx_des, (cfg.N, 1))
    feet_w = jplanner.nominal_foot_locations() + jx_des[0:3][None, :]
    jg = jgait.trot(cfg.stance_time, cfg.swing_time)
    contacts, locs, _ = jplanner.foot_history(
        0.05, x_ref, feet_w, feet_w, jg, jx_des, cfg.N,
        cfg.dynamics_discretization)
    U0 = np.tile(np.tile([0.0, 0.0, jsrb.SPRUNG_MASS * 9.81 / 4], 4),
                 (cfg.N - 1, 1))
    jduals = jprob.init_duals(OPTS["penalty_initial"])
    f_j, U_j, _, it_j, st_j, _ = jctl.mpc_solve_forces(
        "altro", jprob, at.SolverOptions(**OPTS), J(x_curr), x_ref, contacts,
        locs, cfg.dynamics_discretization, J(U0), jduals)

    tcfg = tconfig.MPCConfig(linearized_friction=lin)
    tprob, tx_des = tctl.build_mpc_problem(tcfg, device="cpu")
    tduals = tuple(tt.DualState(lam=d.lam[None], rho=d.rho[None])
                   for d in tprob.init_duals(OPTS["penalty_initial"]))
    f_t, U_t, _, it_t, st_t, _ = tctl.mpc_solve_forces(
        "altro", tprob, tt.SolverOptions(**OPTS), T(x_curr)[None],
        tx_des.expand(cfg.N, 12), T(contacts), T(locs),
        cfg.dynamics_discretization, T(U0)[None], tduals)
    assert int(st_t[0]) == int(st_j) == 1
    assert int(it_t[0]) == int(it_j)
    close(f_t[0], f_j, atol=1e-8)
    close(U_t[0], U_j, atol=1e-8)
    # the ADMM backend of this friction model through its closed loop's
    # workspace (the knot ADMM; its agreement with the JAX package is
    # tests/test_torch_lockstep.py's): solved, the duals passed through
    backend = "admm_qp" if lin else "admm_conic"
    work = tctl.make_baseline_state(backend, tprob, tcfg, tx_des)
    f_a, U_a, d_a, _, st_a, w_a = tctl.mpc_solve_forces(
        backend, tprob, tt.SolverOptions(**OPTS), T(x_curr)[None],
        tx_des.expand(cfg.N, 12), T(contacts), T(locs),
        cfg.dynamics_discretization, T(U0)[None], tduals, work)
    assert int(st_a[0]) == 1 and d_a is tduals and w_a is work
    assert U_a.shape == U_t.shape and torch.equal(f_a, U_a[:, 0])
    with pytest.raises(ValueError, match="backend"):
        tctl.mpc_solve_forces("osqp", tprob, tt.SolverOptions(**OPTS),
                              T(x_curr)[None], None, None, None, 0.03, None,
                              None)


# --------------------------------------------------------- the closed loop

def _jax_plant(**kw):
    return jctl.PlantParams.nominal().replace(
        **{k: jnp.asarray(v) for k, v in kw.items()})


def _port_plant(**kw):
    return dataclasses.replace(tctl.PlantParams.nominal(device="cpu"),
                               **{k: T(v) for k, v in kw.items()})


@pytest.fixture(scope="module")
def jax_loops():
    """The JAX package's closed loop, float64, QP: 10 periods on the
    nominal plant and 5 on the mismatched one."""
    cfg, opts = jconfig.MPCConfig(), at.SolverOptions(**OPTS)
    return (jctl.simulate(cfg, opts, tf=LOOP_TF, backend="altro"),
            jctl.simulate(cfg, opts, tf=MISMATCH_TF, backend="altro",
                          plant=_jax_plant(**PLANT)))


def _compare_loops(res, ref):
    np.testing.assert_array_equal(res["status"].numpy(),
                                  np.asarray(ref["status"]))
    np.testing.assert_array_equal(res["iters"].numpy(),
                                  np.asarray(ref["iters"]))
    assert int(res["status"].min()) == 1
    close(res["x"], ref["x"], atol=1e-8)
    close(res["forces"], ref["forces"], atol=1e-6)


def test_closed_loop_matches_jax(jax_loops):
    """10 periods (0.3 s, two of them past the first release) of the QP
    closed loop: equal status and iterations on every period, x to 1e-8
    and forces to 1e-6. No round-off split of a line-search decision
    occurs in this window."""
    res = tctl.simulate(tconfig.MPCConfig(), tt.SolverOptions(**OPTS),
                        tf=LOOP_TF, device="cpu")
    assert res["status"].numel() == 10
    _compare_loops(res, jax_loops[0])


def test_closed_loop_mismatch_matches_jax(jax_loops):
    """The mismatched plant (+10% mass, -10% inertia, a foot-position
    error, the kick moved to 0.06 s so that the 5 periods see it)."""
    res = tctl.simulate(tconfig.MPCConfig(), tt.SolverOptions(**OPTS),
                        tf=MISMATCH_TF, device="cpu",
                        plant=_port_plant(**PLANT))
    assert res["status"].numel() == 5
    _compare_loops(res, jax_loops[1])


@pytest.mark.parametrize("lin", [True, False])
def test_fixed_buffer_route_matches_eager(lin):
    """The graphed route's functions over their fixed buffers (no capture
    on the CPU) against the eager loop, bit for bit; and simulate_host's
    records against simulate's."""
    cfg, opts = tconfig.MPCConfig(linearized_friction=lin), \
        tt.SolverOptions(**OPTS)
    eager = tctl.simulate(cfg, opts, tf=0.15, device="cpu", graphed=False)
    fixed = tctl.simulate(cfg, opts, tf=0.15, device="cpu", graphed=True)
    for k in eager:
        assert torch.equal(eager[k], fixed[k]), k
    host = tctl.simulate_host(cfg, opts, tf=0.15, device="cpu")
    assert torch.equal(host["status"], eager["status"])
    assert len(host["mpc_ms"]) == len(host["tick_ms"]) == 5
    close(host["x"], eager["x"].numpy(), atol=1e-8)


def test_loop_entry_points_refuse_other_backends():
    """Unknown backends, and the JAX package's native C++ entrants (not
    ported: they come with the C++-oracle slice)."""
    cfg, opts = tconfig.MPCConfig(), tt.SolverOptions(**OPTS)
    with pytest.raises(NotImplementedError, match="oracle"):
        tctl.simulate_host(cfg, opts, tf=0.03, backend="admm_qp",
                           device="cpu", native=True)
    with pytest.raises(ValueError, match="backend"):
        tctl.simulate(cfg, opts, tf=0.03, backend="osqp", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        tctl.simulate_host(cfg, opts, tf=0.03, backend="osqp", device="cpu")


# ------------------------------------------------------------- LQR oracles

def test_lqr_oracles_match_jax():
    rng = np.random.default_rng(4)
    n, m, N = 5, 2, 20
    A = 0.3 * rng.standard_normal((n, n)) + 0.7 * np.eye(n)
    B = 0.5 * rng.standard_normal((n, m))
    Q, R, Qf = 2.0 * np.eye(n), 0.5 * np.eye(m), 10.0 * np.eye(n)
    q, r, qf = (rng.standard_normal(k) for k in (n, m, n))
    np.testing.assert_array_equal(tlqr.dare(A, B, Q, R),
                                  jlqr.dare(A, B, Q, R))
    np.testing.assert_array_equal(tlqr.dlqr(A, B, Q, R),
                                  jlqr.dlqr(A, B, Q, R))
    for a, b in zip(tlqr.finite_lqr(A, B, Q, R, Qf, q, r, qf, N),
                    jlqr.finite_lqr(A, B, Q, R, Qf, q, r, qf, N)):
        np.testing.assert_array_equal(a, b)


def test_solver_matches_finite_lqr():
    """The port's solve (B=1) of an unconstrained LQR problem against the
    exact Riccati recursion (as the JAX package's test_solver_lqr)."""
    rng = np.random.default_rng(5)
    n, m, N = 6, 3, 25
    A = 0.3 * rng.standard_normal((n, n)) + 0.7 * np.eye(n)
    B = 0.5 * rng.standard_normal((n, m))
    Q, R, Qf = 2.0 * np.eye(n), 0.5 * np.eye(m), 10.0 * np.eye(n)
    x0 = rng.standard_normal(n)
    prob = tt.Problem(dynamics=tt.lti_dynamics(T(A), T(B), N),
                      cost=tt.lqr_objective(T(Q), T(R), T(Qf),
                                            torch.zeros(n, dtype=F64), N,
                                            dt=1.0),
                      constraints=(), x0=T(x0)[None])
    sol = tt.solve(prob, tt.SolverOptions(cost_tolerance=1e-10,
                                          gradient_tolerance=1e-10))
    Ks, ds = tlqr.finite_lqr(A, B, Q, R, Qf, np.zeros(n), np.zeros(m),
                             np.zeros(n), N)
    x, Xs, Us = x0, [x0], []
    for k in range(N - 1):
        u = Ks[k] @ x + ds[k]
        x = A @ x + B @ u
        Us.append(u)
        Xs.append(x)
    close(sol.U[0], np.stack(Us), atol=1e-6)
    close(sol.X[0], np.stack(Xs), atol=1e-6)
    assert int(sol.stats.status[0]) == 1


# ------------------------------------------------- the repair: any device

@pytest.mark.parametrize("lin", [True, False])
def test_flat_bench_setup_unchanged(lin):
    su = quadruped_setup(16, lin, F64, "cpu")
    h = hashlib.sha256()
    for t in tensors(su):
        h.update(t.contiguous().numpy().tobytes())
    h.update(su.draw_x0().numpy().tobytes())
    assert h.hexdigest() == FLAT_DIGEST[lin]


def test_pieces_keep_the_input_dtype():
    f32 = torch.float32
    rng = np.random.default_rng(6)
    alpha = T(rng.uniform(-0.3, 0.3, 12), f32)
    feet = tkin.forward_kinematics_all(alpha)
    x = T(np.concatenate([[0, 0, 0.28], 0.01 * rng.standard_normal(9)]), f32)
    u, c = T(np.tile([0, 0, 40.0], 4), f32), T([1, 0, 0, 1], f32)
    locs = tplanner.nominal_foot_locations(dtype=f32)
    rot = tsrb.mrp_rotation(x[3:6])
    g = tgait.trot(0.2, 0.2)
    coeffs = tswing.foot_trajectory_coeffs(
        x, rot, feet.reshape(4, 3), torch.zeros(4, 3), locs,
        T(0.2, f32), T([0.4] * 4, f32), 0.05)
    outs = [feet, tkin.inverse_kinematics_all(feet),
            tkin.leg_jacobian(alpha[:3], 0), tkin.force_to_torque(u, alpha),
            tsrb.continuous_dynamics(x, u, locs, c),
            tsrb.rk4_plant(x, u, locs, c, 1e-3),
            tsrb.mrp_from_quat(T([0.9, 0.1, 0.2, 0.3], f32)),
            tplanner.footstep_locations(x, rot, g.phase_at(0.3), g), coeffs,
            *tswing.swing_foot_target(coeffs, T(0.3, f32)),
            tswing.swing_pd_force(x, rot, coeffs, locs, torch.zeros(4, 3),
                                  T(0.3, f32))]
    assert all(o.dtype == f32 for o in outs), [o.dtype for o in outs]


# --------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_pieces_on_the_card_match_the_cpu(cuda):
    rng = np.random.default_rng(7)
    alpha = rng.uniform(-0.3, 0.3, 12)
    close(tkin.forward_kinematics_all(T(alpha, device=cuda)),
          tkin.forward_kinematics_all(T(alpha)))
    cfg = tconfig.MPCConfig()
    out = []
    for dev in (cuda, torch.device("cpu")):
        g = tgait.trot(0.2, 0.2).to(dev)
        prob, x_des = tctl.build_mpc_problem(cfg, device=dev)
        feet = x_des[0:3] + tplanner.nominal_foot_locations(dev, F64)
        t = torch.tensor(0.27, dtype=F64, device=dev)
        hist = tplanner.foot_history(t, x_des.expand(cfg.N, 12), feet, feet,
                                     g, x_des, cfg.N, 0.03)
        s = tctl.initial_state(prob, x_des, tt.SolverOptions(**OPTS))
        s, tau = tctl.control_tick(s, t, g, cfg, x_des)
        out.append([g.phase_at(t), g.contacts_at(t), *hist, s.x, s.feet_w,
                    s.swing_coeffs, tau])
    for a, b in zip(*out):
        close(a, b.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("lin", [True, False])
def test_kernels_at_the_closed_loop_shapes(cuda, lin):
    from altro_tpu_torch.bench.kernels import quadloop_inputs
    from altro_tpu_torch.ops import riccati_fused, rollout, rollout_al
    q = quadloop_inputs(F64, cuda, lin)
    out = riccati_fused.fused_expand_backward(*q["fused"], packed=q["packed"])
    for a, b in zip(out, q["fused_ref"]):
        close_rel(a, b.cpu().numpy(), 1e-9)
    Xs, Us, Jl = rollout_al.batched_ls_rollout_al(*q["ladder_al"],
                                                  packed=q["packed"])
    for a, b in zip((Xs, Us, Jl),
                    rollout_al.batched_ls_rollout_al_reference(
                        *q["ladder_al"])):
        close_rel(a, b.cpu().numpy(), 1e-9)
    for a, b in zip(rollout.batched_ls_rollout(*q["init"]),
                    rollout.batched_ls_rollout_reference(*q["init"])):
        close_rel(a, b.cpu().numpy(), 1e-9)


@pytest.mark.cuda
def test_closed_loop_graphed_matches_eager_on_the_card(cuda):
    cfg, opts = tconfig.MPCConfig(), tt.SolverOptions(**OPTS)
    g = tctl.simulate(cfg, opts, tf=LOOP_TF, device=cuda, graphed=True)
    e = tctl.simulate(cfg, opts, tf=LOOP_TF, device=cuda, graphed=False)
    assert torch.equal(g["status"], e["status"])
    assert torch.equal(g["iters"], e["iters"])
    close(g["x"], e["x"].cpu().numpy(), atol=1e-10)
