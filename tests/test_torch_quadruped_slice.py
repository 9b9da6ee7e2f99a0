"""The flat batched quadruped trot MPC as a whole against the JAX package in
float64: B=16 lanes (2 per contact schedule), each with its own dynamics,
both friction modes, solved cold from the stance forces at the benchmark's
options, with ``ls_fused`` "auto" (on the CPU both packages take the
classical ladder) and "on" (the fused branch, which the per-lane route runs
as the ladder rollout plus the merit in PyTorch). The JAX package solves
``jax.vmap(solve_one)`` over its batched problem; the port solves the same
problem carried across by ``convert.problem_from_numpy``.

Tolerances: status and iteration counts equal; X within atol 1e-8; U within
atol 1e-8 plus rtol 1e-9. The forces reach 60 N and R weights the vertical
ones at 1e-3, so Quu is ill-conditioned: on the same float64 expansion
(bit-equal in both packages) the two backward passes' Cholesky solves
differ by ~1e-8 in K and d from rounding alone, and the last knot's
vertical force of one lane lands 1.007e-8 apart.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import altro_tpu as at  # noqa: E402
from altro_tpu.models.quadruped import config as jconfig  # noqa: E402
from altro_tpu.models.quadruped import controller as jcontroller  # noqa: E402
from altro_tpu.models.quadruped import planner as jplanner  # noqa: E402
from altro_tpu.models.quadruped.gait import GAITS  # noqa: E402

import altro_tpu_torch as tt  # noqa: E402
from altro_tpu_torch import convert  # noqa: E402
from altro_tpu_torch.bench.families import OPTS, quadruped_setup  # noqa: E402
from altro_tpu_torch.ops import (riccati, riccati_fused, rollout,  # noqa: E402
                                 rollout_al)

torch.set_num_threads(1)
B = 16


def _jax_problem(lin):
    """The JAX package's flat per-lane problem in float64, built as its
    ``quadruped_setup`` builds it (every leaf stacked per lane)."""
    cfg = jconfig.MPCConfig(linearized_friction=lin)
    gait = GAITS[cfg.gait_type](cfg.stance_time, cfg.swing_time)
    prob, x_des = jcontroller.build_mpc_problem(cfg, jnp.float64)
    N, dt = cfg.N, cfg.dynamics_discretization
    cycle = cfg.stance_time + cfg.swing_time
    feet0 = (x_des[0:3][None, :] + jplanner.nominal_foot_locations()
             ).at[:, 2].set(jconfig.woofer.geometry.foot_radius)
    x_ref = jnp.tile(x_des, (N, 1))

    def one(t):
        contacts, locs, _ = jplanner.foot_history(t, x_ref, feet0, feet0,
                                                  gait, x_des, N, dt)
        return jcontroller._linearized_problem(prob, x_des, x_ref, contacts,
                                               locs, dt)

    ts = jnp.asarray([i * cycle / 8 for i in range(8)])
    stack = jax.jit(jax.vmap(one))(ts)
    return jax.tree_util.tree_map(lambda a: jnp.repeat(a, B // 8, axis=0),
                                  stack)


@pytest.fixture(scope="module", params=[True, False], ids=["qp", "socp"])
def instance(request):
    lin = request.param
    jprob = _jax_problem(lin)
    su = quadruped_setup(B, lin, torch.float64, "cpu")
    x0 = su.draw_x0()
    tprob = dataclasses.replace(
        convert.problem_from_numpy(convert.numpy_tree(jprob)), x0=x0)
    return jprob, tprob, su.U0, x0


def _counts():
    return (rollout.launch_count, riccati_fused.launch_count,
            rollout_al.launch_count, riccati.launch_count)


@pytest.mark.parametrize("ls_fused", ["auto", "on"])
def test_flat_batched_solve_matches_jax(instance, ls_fused):
    jprob, tprob, U0, x0 = instance
    kw = dict(OPTS, ls_fused=ls_fused)
    jopts = at.SolverOptions(**kw)
    u0 = jnp.asarray(U0[0].numpy())

    def solve_one(prob_k, x0_k):
        sol = at.solve(prob_k.replace(x0=x0_k), jopts, U0=u0)
        return sol.X, sol.U, sol.stats.status, sol.stats.iterations

    jX, jU, jstatus, jiters = jax.jit(jax.vmap(solve_one))(
        jprob, jnp.asarray(x0.numpy()))
    counts = _counts()
    sol = tt.solve(tprob, tt.SolverOptions(**kw), U0=U0)
    assert _counts() == counts          # the CPU takes the plain versions
    assert sol.stats.status.tolist() == np.asarray(jstatus).tolist()
    assert int(sol.stats.status.sum()) == B
    assert sol.stats.iterations.tolist() == np.asarray(jiters).tolist()
    np.testing.assert_allclose(sol.X.numpy(), np.asarray(jX), atol=1e-8,
                               rtol=0)
    np.testing.assert_allclose(sol.U.numpy(), np.asarray(jU), atol=1e-8,
                               rtol=1e-9)


def test_per_lane_route_matches_shared_route():
    """Per-lane dynamics equal on every lane take the unfused route
    (expansion, then the Riccati pass) and give what the fused route gives
    for the same shared dynamics, to round-off."""
    su = quadruped_setup(8, True, torch.float64, "cpu")
    x0 = su.draw_x0()
    lane0 = dataclasses.replace(
        su.prob, x0=x0,
        dynamics=tt.LTVDynamics(A=su.prob.dynamics.A[0],
                                B=su.prob.dynamics.B[0],
                                d=su.prob.dynamics.d[0]))
    per_lane = dataclasses.replace(
        lane0, dynamics=tt.LTVDynamics(
            **{k: getattr(lane0.dynamics, k).expand(
                (8,) + tuple(getattr(lane0.dynamics, k).shape)).contiguous()
               for k in ("A", "B", "d")}))
    opts = tt.SolverOptions(**OPTS)
    a = tt.solve(lane0, opts, U0=su.U0)
    b = tt.solve(per_lane, opts, U0=su.U0)
    assert torch.equal(a.stats.iterations, b.stats.iterations)
    assert torch.equal(a.stats.status, b.stats.status)
    np.testing.assert_allclose(b.U.numpy(), a.U.numpy(), atol=1e-8,
                               rtol=1e-9)


def test_fused_kernels_refuse_per_lane_dynamics():
    """Kernels B and C take shared dynamics only: their wrappers' shape
    checks refuse per-lane stacks (the solver routes those to the Riccati
    pass and the ladder rollout)."""
    su = quadruped_setup(8, True, torch.float64, "cpu")
    p, dyn = su.prob, su.prob.dynamics
    X = p.dynamics.rollout(su.draw_x0(), su.U0)
    duals = p.init_duals(10.0)
    lams = tuple(d.lam for d in duals)
    rhos = tuple(d.rho for d in duals)
    with pytest.raises(ValueError, match="A"):
        riccati_fused.fused_expand_backward(
            p.cost, dyn.A, dyn.B, p.constraints, X, su.U0, lams, rhos,
            torch.zeros(8, dtype=torch.float64))
    K = torch.zeros((8, p.N - 1, 12, 12), dtype=torch.float64)
    with pytest.raises(ValueError, match="A"):
        rollout_al.batched_ls_rollout_al(
            p.cost, dyn.A, dyn.B, dyn.d, p.constraints, X, su.U0, K,
            torch.zeros_like(su.U0), lams, rhos[0], (1.0, 0.0))
