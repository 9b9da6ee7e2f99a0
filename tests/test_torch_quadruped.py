"""The quadruped trot-MPC model pieces of the port against the JAX package
in float64: gait phases, leg forward kinematics, the single-rigid-body
dynamics and its MRP attitude, the footstep planner's horizon schedules and
the linearized dynamics stacks of the benchmark's 8 contact schedules (all
to atol 1e-12), the MPC problem in both friction modes and the friction
blocks' rows; the benchmark's flat batched setup against the JAX package's
construction; per-lane dynamics; and a batched JAX problem carried across
by ``convert.problem_from_numpy`` (bit-equal stacks).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from altro_tpu import constraints as jcons  # noqa: E402
from altro_tpu.models.quadruped import config as jconfig  # noqa: E402
from altro_tpu.models.quadruped import controller as jcontroller  # noqa: E402
from altro_tpu.models.quadruped import gait as jgait  # noqa: E402
from altro_tpu.models.quadruped import kinematics as jkin  # noqa: E402
from altro_tpu.models.quadruped import planner as jplanner  # noqa: E402
from altro_tpu.models.quadruped import srb as jsrb  # noqa: E402

import altro_tpu_torch as tt  # noqa: E402
from altro_tpu_torch import convert  # noqa: E402
from altro_tpu_torch.bench.families import quadruped_setup  # noqa: E402
from altro_tpu_torch.models.quadruped import config as tconfig  # noqa: E402
from altro_tpu_torch.models.quadruped import controller as tcontroller  # noqa: E402,E501
from altro_tpu_torch.models.quadruped import gait as tgait  # noqa: E402
from altro_tpu_torch.models.quadruped import kinematics as tkin  # noqa: E402
from altro_tpu_torch.models.quadruped import planner as tplanner  # noqa: E402
from altro_tpu_torch.models.quadruped import srb as tsrb  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-12
N, DT, CYCLE = 15, 0.03, 0.4   # the MPC config's horizon, step, trot cycle


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=atol,
                               rtol=0)


def _jax_schedules():
    """The benchmark's 8 contact schedules built by the JAX package in
    float64 (jit of a vmap over the sample times): linearized problems
    [8, ...], contacts [8, N, 4], foot locations [8, N, 4, 3] and planner
    locations [8, 4, 3]."""
    cfg = jconfig.MPCConfig()
    gait = jgait.GAITS[cfg.gait_type](cfg.stance_time, cfg.swing_time)
    prob, x_des = jcontroller.build_mpc_problem(cfg, jnp.float64)
    feet0 = (x_des[0:3][None, :] + jplanner.nominal_foot_locations()
             ).at[:, 2].set(jconfig.woofer.geometry.foot_radius)
    x_ref = jnp.tile(x_des, (N, 1))

    def one(t):
        contacts, locs, ploc = jplanner.foot_history(
            t, x_ref, feet0, feet0, gait, x_des, N, DT)
        return (jcontroller._linearized_problem(prob, x_des, x_ref, contacts,
                                                locs, DT),
                contacts, locs, ploc)

    ts = jnp.asarray([i * CYCLE / 8 for i in range(8)])
    return jax.jit(jax.vmap(one))(ts)


@pytest.fixture(scope="module")
def jax_schedules():
    return _jax_schedules()


def _port_schedule(i):
    cfg = tconfig.MPCConfig()
    gait = tgait.GAITS[cfg.gait_type](cfg.stance_time, cfg.swing_time)
    prob, x_des = tcontroller.build_mpc_problem(cfg)
    feet0 = x_des[0:3][None, :] + tplanner.nominal_foot_locations()
    feet0[:, 2] = tconfig.woofer.geometry.foot_radius
    x_ref = x_des.expand(N, 12)
    t = torch.tensor(i * CYCLE / 8, dtype=torch.float64)
    contacts, locs, ploc = tplanner.foot_history(t, x_ref, feet0, feet0,
                                                 gait, x_des, N, DT)
    p = tcontroller._linearized_problem(prob, x_des, x_ref, contacts, locs,
                                        DT)
    return p, contacts, locs, ploc


@pytest.mark.parametrize("name", sorted(tgait.GAITS))
def test_gait_phases_match_jax(name):
    jg, tg = jgait.GAITS[name](), tgait.GAITS[name]()
    # a grid over several cycles plus the benchmark's knot times, which land
    # on phase boundaries
    ts = np.concatenate([np.arange(0.0, 3.0, 0.0125),
                         [i * CYCLE / 8 + k * DT for i in range(8)
                          for k in range(N)]])
    tp = tg.phase_at(torch.tensor(ts))
    jp = jax.vmap(jg.phase_at)(jnp.asarray(ts))
    assert tp.tolist() == np.asarray(jp).tolist()
    close(tg.phase_time(torch.tensor(ts), tp),
          jax.vmap(jg.phase_time)(jnp.asarray(ts), jp))
    assert (tg.next_phase(tp).tolist()
            == np.asarray(jax.vmap(jg.next_phase)(jp)).tolist())
    close(tg.contacts_at(torch.tensor(ts)),
          jax.vmap(jg.contacts_at)(jnp.asarray(ts)), atol=0)


def test_kinematics_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(5):
        a = 0.4 * rng.standard_normal(12)
        close(tkin.forward_kinematics_all(torch.tensor(a)),
              jkin.forward_kinematics_all(jnp.asarray(a)))
    close(tkin._rotx(torch.tensor(0.3, dtype=torch.float64)),
          jkin._rotx(jnp.asarray(0.3)))
    close(tplanner.nominal_foot_locations(),
          jplanner.nominal_foot_locations())


def test_srb_pieces_match_jax():
    rng = np.random.default_rng(1)
    for _ in range(3):
        phi, omega = 0.3 * rng.standard_normal(3), rng.standard_normal(3)
        x, u = rng.standard_normal(12), 30.0 * rng.standard_normal(12)
        locs = rng.standard_normal((4, 3))
        contacts = (rng.random(4) < 0.5).astype(float)
        close(tsrb.skew(torch.tensor(phi)), jsrb.skew(jnp.asarray(phi)))
        close(tsrb.mrp_rotation(torch.tensor(phi)),
              jsrb.mrp_rotation(jnp.asarray(phi)))
        close(tsrb.mrp_kinematics(torch.tensor(phi), torch.tensor(omega)),
              jsrb.mrp_kinematics(jnp.asarray(phi), jnp.asarray(omega)))
        close(tsrb.continuous_dynamics(*map(torch.tensor,
                                            (x, u, locs, contacts))),
              jsrb.continuous_dynamics(*map(jnp.asarray,
                                            (x, u, locs, contacts))))


@pytest.mark.parametrize("i", range(8))
def test_schedule_and_linearization_match_jax(jax_schedules, i):
    """foot_history and linearize_horizon at the benchmark's sample time
    t = i * cycle / 8 (the knot times cross phase boundaries)."""
    jprob, jcontacts, jlocs, jploc = jax.tree_util.tree_map(
        lambda a: a[i], jax_schedules)
    p, contacts, locs, ploc = _port_schedule(i)
    close(contacts, jcontacts, atol=0)
    close(locs, jlocs)
    close(ploc, jploc)
    for k in ("A", "B", "d"):
        close(getattr(p.dynamics, k), getattr(jprob.dynamics, k))


@pytest.mark.parametrize("lin", [True, False], ids=["qp", "socp"])
def test_build_mpc_problem_matches_jax(lin):
    jp, jx = jcontroller.build_mpc_problem(
        jconfig.MPCConfig(linearized_friction=lin), jnp.float64)
    tp, tx = tcontroller.build_mpc_problem(
        tconfig.MPCConfig(linearized_friction=lin))
    close(tx, jx)
    close(tp.x0, jp.x0)
    for k in ("Q", "q", "R", "r", "H", "c"):
        close(getattr(tp.cost, k), getattr(jp.cost, k))
    assert len(tp.constraints) == len(jp.constraints) == 5
    for tc, jc in zip(tp.constraints, jp.constraints):
        assert tc.cone.value == jc.cone.value
        for k in ("Cx", "Cu", "b", "mask"):
            close(getattr(tc, k), getattr(jc, k), atol=0)
    for k in ("A", "B", "d"):
        close(getattr(tp.dynamics, k), getattr(jp.dynamics, k), atol=0)


def test_friction_rows_match_jax():
    mask = np.zeros(7)
    mask[2:5] = 1.0
    for mk in (None, mask):
        for tf, jf in ((tt.linearized_friction, jcons.linearized_friction),
                       (tt.friction_cone, jcons.friction_cone)):
            tc = tf(7, 4, 6, 0.7, (3, 4, 5), dtype=torch.float64,
                    mask=None if mk is None else torch.tensor(mk))
            jc = jf(7, 4, 6, 0.7, (3, 4, 5), dtype=jnp.float64,
                    mask=None if mk is None else jnp.asarray(mk))
            assert tc.cone.value == jc.cone.value and tc.p == jc.p
            for k in ("Cx", "Cu", "b", "mask"):
                close(getattr(tc, k), getattr(jc, k), atol=0)


def _jax_flat(jax_schedules, lin, B, dtype=jnp.float64):
    """The flat benchmark layout as the JAX package builds it: every leaf
    of the problem with a lane axis, schedule i on lanes i*B/8 .. ."""
    jprob = jax_schedules[0]
    base, _ = jcontroller.build_mpc_problem(
        jconfig.MPCConfig(linearized_friction=lin), jnp.float64)
    stack = base.replace(
        dynamics=jprob.dynamics, x0=jprob.x0,
        cost=jax.tree_util.tree_map(lambda a: jnp.broadcast_to(
            a, (8,) + a.shape), base.cost),
        constraints=jax.tree_util.tree_map(lambda a: jnp.broadcast_to(
            a, (8,) + a.shape), base.constraints))
    return jax.tree_util.tree_map(
        lambda a: jnp.repeat(a, B // 8, axis=0).astype(dtype), stack)


@pytest.mark.parametrize("lin", [True, False], ids=["qp", "socp"])
def test_quadruped_setup_matches_jax(jax_schedules, lin):
    """The port's float64 benchmark setup: the JAX package's per-lane
    problem, the stance-force warm start and the seeded x0 draws."""
    B = 16
    su = quadruped_setup(B, lin, torch.float64, "cpu")
    jprob = _jax_flat(jax_schedules, lin, B)
    for k in ("A", "B", "d"):
        close(getattr(su.prob.dynamics, k), getattr(jprob.dynamics, k))
    carried = convert.problem_from_numpy(convert.numpy_tree(jprob))
    for k in ("Q", "q", "R", "r", "H", "c"):
        assert torch.equal(getattr(su.prob.cost, k),
                           getattr(carried.cost, k))
    for tc, cc in zip(su.prob.constraints, carried.constraints):
        assert tc.cone == cc.cone
        for k in ("Cx", "Cu", "b", "mask"):
            assert torch.equal(getattr(tc, k), getattr(cc, k))
    fz = tcontroller.SPRUNG_MASS * 9.81 / 4.0
    assert su.U0.shape == (B, N - 1, 12)
    assert torch.equal(su.U0[..., 2::3],
                       torch.full((B, N - 1, 4), fz, dtype=torch.float64))
    rng = np.random.default_rng(3)
    scale = np.array([.02, .02, .02, .05, .05, .05] * 2)
    for _ in range(2):
        close(su.draw_x0(), np.asarray(su.x_des)[None]
              + rng.standard_normal((B, 12)) * scale, atol=0)
    s32 = quadruped_setup(B, lin, torch.float32, "cpu")
    assert torch.equal(s32.prob.dynamics.A, su.prob.dynamics.A.float())


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32],
                         ids=["f64", "f32"])
def test_problem_from_numpy_carries_batched_problem(jax_schedules, dtype):
    """A JAX batched problem carried across: per-lane dynamics and x0 stay
    per lane, bit-equal; the lane-equal cost and constraint stacks come from
    lane 0; stacks that differ between lanes raise."""
    jprob = _jax_flat(jax_schedules, False, 16, dtype)
    tdtype = torch.float64 if dtype == jnp.float64 else torch.float32
    tp = convert.problem_from_numpy(convert.numpy_tree(jprob), dtype=tdtype)
    for k in ("A", "B", "d"):
        t, j = getattr(tp.dynamics, k), np.asarray(getattr(jprob.dynamics, k))
        assert t.dtype == tdtype and t.shape == j.shape
        assert np.array_equal(t.numpy(), j)
    assert np.array_equal(tp.x0.numpy(), np.asarray(jprob.x0))
    assert tp.dynamics.per_lane and tp.N == N
    for k in ("Q", "q", "R", "r", "H", "c"):
        assert np.array_equal(getattr(tp.cost, k).numpy(),
                              np.asarray(getattr(jprob.cost, k))[0])
    for tc, jc in zip(tp.constraints, jprob.constraints):
        for k in ("Cx", "Cu", "b", "mask"):
            assert np.array_equal(getattr(tc, k).numpy(),
                                  np.asarray(getattr(jc, k))[0])
    tree = convert.numpy_tree(jprob)
    tree["cost"]["q"] = tree["cost"]["q"].copy()
    tree["cost"]["q"][3] += 1.0
    with pytest.raises(ValueError, match="q"):
        convert.problem_from_numpy(tree)


def test_per_lane_dynamics_step_and_rollout():
    """Per-lane stacks [B, N-1, ...] step and roll out each lane with its
    own dynamics."""
    rng = np.random.default_rng(2)
    Bt, n, m = 3, 4, 2
    A = torch.tensor(rng.standard_normal((Bt, N - 1, n, n)) * 0.4)
    Bm = torch.tensor(rng.standard_normal((Bt, N - 1, n, m)))
    d = torch.tensor(rng.standard_normal((Bt, N - 1, n)))
    x0 = torch.tensor(rng.standard_normal((Bt, n)))
    U = torch.tensor(rng.standard_normal((Bt, N - 1, m)))
    dyn = tt.LTVDynamics(A=A, B=Bm, d=d)
    assert dyn.per_lane and dyn.N == N and dyn.n == n and dyn.m == m
    X = dyn.rollout(x0, U)
    for b in range(Bt):
        lane = tt.LTVDynamics(A=A[b], B=Bm[b], d=d[b])
        assert not lane.per_lane
        close(X[b], lane.rollout(x0[b], U[b]), atol=1e-13)
        close(dyn.step(x0, U[:, 3], 3)[b], lane.step(x0[b], U[b, 3], 3),
              atol=1e-13)
    assert dataclasses.replace(dyn, A=A[0]).N == N
