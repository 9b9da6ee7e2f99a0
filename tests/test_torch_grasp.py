"""The grasp slice against the JAX package in float64: the object's stacks,
the dynamics, ``linear_constraint`` and the constraint windows at
k0 = 0, 7 and a k0 past the end (clamped as ``lax.dynamic_slice`` clamps
it) to 1e-12; the cold N=61 solve at ``tests/test_grasp.py``'s options with
the classical and the fused ladder (equal iterations and status, X/U to
atol 1e-8); three warm MPC steps of the N_mpc=21 window with the
benchmark's warm options, shifted warm start and per-step constraint
windows (per-step iterations and status equal, X/U/viol to atol 1e-8);
the cone and constraint helpers grasp needs."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import altro_tpu as at  # noqa: E402
from altro_tpu.models import grasp as jgrasp  # noqa: E402
from altro_tpu.mpc import gen_tracking_mpc as j_gen  # noqa: E402
from altro_tpu.mpc import make_mpc_step as j_make_mpc_step  # noqa: E402

import altro_tpu_torch as tt  # noqa: E402
from altro_tpu_torch import convert  # noqa: E402
from altro_tpu_torch.bench.conic import GRASP_WARM_OPTS  # noqa: E402
from altro_tpu_torch.cones import Cone, in_cone  # noqa: E402
from altro_tpu_torch.models import grasp as tgrasp  # noqa: E402
from altro_tpu_torch.mpc import gen_tracking_mpc, make_mpc_step  # noqa: E402
from altro_tpu_torch.ops import riccati_fused, rollout, rollout_al  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-8
N, TF = 61, 6.0
COLD_OPTS = dict(cost_tolerance=1e-6, gradient_tolerance=1e-8,
                 constraint_tolerance=1e-6, penalty_initial=10.0,
                 penalty_scaling=10.0, iterations_outer=30,
                 iterations_inner=50)


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=atol,
                               rtol=0)


def _counts():
    return (rollout.launch_count, riccati_fused.launch_count,
            rollout_al.launch_count)


def _blocks_close(tb, jb):
    assert len(tb) == len(jb)
    for t, j in zip(tb, jb):
        assert t.cone.value == j.cone.value and t.name == j.name
        for k in ("Cx", "Cu", "b", "mask"):
            close(getattr(t, k), getattr(j, k), 1e-12)


@pytest.fixture(scope="module")
def objects():
    return (tgrasp.make_grasp_object(N, TF),
            jgrasp.make_grasp_object(N, TF))


def test_object_and_dynamics_match_jax(objects):
    to, jo = objects
    for k in ("theta", "thdd", "v1", "v2", "B1", "B2"):
        close(getattr(to, k), getattr(jo, k), 1e-12)
    assert (to.mu, to.mass, to.f_max) == (jo.mu, jo.mass, jo.f_max)
    td, jd = tgrasp.grasp_dynamics(to, N, 0.1), jgrasp.grasp_dynamics(
        jo, N, 0.1)
    for k in ("A", "B", "d"):
        close(getattr(td, k), getattr(jd, k), 1e-12)
    tp, jp = tgrasp.grasp_problem(to, N, TF), jgrasp.grasp_problem(jo, N, TF)
    _blocks_close(tp.constraints, jp.constraints)
    for k in ("Q", "q", "R", "r", "H", "c"):
        close(getattr(tp.cost, k), getattr(jp.cost, k), 1e-12)
    close(tp.x0, jp.x0, 0)
    close(tgrasp.hover_controls(to, N), jgrasp.hover_controls(jo, N), 0)


@pytest.mark.parametrize("k0", [0, 7, 50], ids=["k0=0", "k0=7",
                                                "k0=50-clamped"])
def test_constraint_windows_match_jax(objects, k0):
    """The 21-knot window; k0 = 50 lies past Nt - N = 40 and clamps."""
    to, jo = objects
    _blocks_close(tgrasp.grasp_constraints(to, 21, k0),
                  jgrasp.grasp_constraints(jo, 21, k0))
    if k0 > N - 21:
        _blocks_close(tgrasp.grasp_constraints(to, 21, k0),
                      tgrasp.grasp_constraints(to, 21, N - 21))


def test_linear_constraint_matches_jax():
    """2-D inputs broadcast over the knots; the default mask and a range."""
    from altro_tpu.cones import Cone as JCone
    from altro_tpu.constraints import linear_constraint as j_lin

    rng = np.random.default_rng(3)
    Ax, Au, rhs = (rng.standard_normal(s) for s in ((4, 5), (4, 3), (4,)))
    for kw in ({}, dict(start=2, stop=6)):
        t = tt.linear_constraint(9, 5, 3, Ax, Au, rhs, Cone.NONPOS,
                                 dtype=torch.float64, **kw)
        j = j_lin(9, 5, 3, Ax, Au, rhs, JCone.NONPOS, dtype=jnp.float64,
                  **kw)
        _blocks_close((t,), (j,))
    stacked = rng.standard_normal((9, 4, 3))
    t = tt.linear_constraint(9, 5, 3, Ax, stacked, rhs, Cone.ZERO,
                             dtype=torch.float64)
    j = j_lin(9, 5, 3, Ax, stacked, rhs, JCone.ZERO, dtype=jnp.float64)
    _blocks_close((t,), (j,))


def test_cone_and_constraint_helpers():
    """in_cone, ConicConstraint.is_affine and max_violation against the
    JAX package's."""
    from altro_tpu.cones import Cone as JCone
    from altro_tpu.cones import in_cone as j_in_cone

    rng = np.random.default_rng(4)
    c = rng.standard_normal((5, 7, 4))
    for cone in Cone:
        for tol in (0.0, 0.5):
            assert (in_cone(cone, torch.as_tensor(c), tol).tolist()
                    == np.asarray(j_in_cone(JCone(cone.value), c,
                                            tol)).tolist())
    to, jo = tgrasp.make_grasp_object(N, TF), jgrasp.make_grasp_object(N, TF)
    X = rng.standard_normal((21, 6))
    U = rng.standard_normal((20, 6))
    for t, j in zip(tgrasp.grasp_constraints(to, 21, 3),
                    jgrasp.grasp_constraints(jo, 21, 3)):
        assert t.is_affine and j.is_affine
        close(t.max_violation(torch.as_tensor(X), torch.as_tensor(U)),
              j.max_violation(X, U), 1e-12)
    # batched: one violation per lane
    Xb = torch.as_tensor(rng.standard_normal((3, 21, 6)))
    Ub = torch.as_tensor(rng.standard_normal((3, 20, 6)))
    blk = tgrasp.grasp_constraints(to, 21, 3)[2]
    assert blk.max_violation(Xb, Ub).shape == (3,)
    close(blk.max_violation(Xb, Ub)[1], blk.max_violation(Xb[1], Ub[1]), 0)


@pytest.fixture(scope="module")
def jax_cold(objects):
    """The JAX package's cold solves, classical and fused ladder."""
    _, jo = objects
    jp = jgrasp.grasp_problem(jo, N, TF)
    U0 = jgrasp.hover_controls(jo, N)
    return {f: jax.jit(at.solve)(jp, at.SolverOptions(**COLD_OPTS,
                                                      ls_fused=f), U0=U0)
            for f in ("off", "on")}


@pytest.mark.parametrize("ls_fused", ["off", "on"])
def test_cold_solve_matches_jax(objects, jax_cold, ls_fused):
    to, _ = objects
    jsol = jax_cold[ls_fused]
    tp = tgrasp.grasp_problem(to, N, TF)
    counts = _counts()
    tsol = tt.solve(dataclasses.replace(tp, x0=tp.x0[None]),
                    tt.SolverOptions(**COLD_OPTS, ls_fused=ls_fused),
                    U0=tgrasp.hover_controls(to, N)[None])
    assert _counts() == counts          # the CPU takes the plain versions
    assert int(tsol.stats.status[0]) == int(jsol.stats.status) == 1
    assert int(tsol.stats.iterations[0]) == int(jsol.stats.iterations)
    assert (int(tsol.stats.outer_iterations[0])
            == int(jsol.stats.outer_iterations))
    close(tsol.X[0], jsol.X)
    close(tsol.U[0], jsol.U)
    close(tsol.stats.viol[0], jsol.stats.viol)


def test_mpc_steps_match_jax(objects, jax_cold):
    """B=8, three steps of the benchmark's warm options (penalty 1e3 x10,
    an L=2 ladder, the exact-step stop) with the shifted warm start, the
    seam corrector and the constraint window refreshed every step."""
    to, jo = objects
    T, B, N_mpc = 3, 8, 21
    jsol = jax_cold["off"]
    X_tr, U_tr = jsol.X, jsol.U
    jw = j_gen(jgrasp.grasp_problem(jo, N, TF), X_tr, U_tr, N_mpc, Qk=1e3,
               Rk=1.0, Qfk=10.0, dt=TF / (N - 1))
    jw = jw.replace(constraints=jgrasp.grasp_constraints(jo, N_mpc, 0))
    noise = np.random.default_rng(0).standard_normal((T, B, 6))
    jstep, jinit = j_make_mpc_step(
        jw, at.SolverOptions(**GRASP_WARM_OPTS), X_tr, U_tr,
        constraints_fn=lambda k: jgrasp.grasp_constraints(jo, N_mpc, k),
        shared_k=True, warm_start="shift")
    vstep = jax.jit(jax.vmap(jstep, in_axes=(0, 0, None)))
    jcarry = jax.vmap(lambda _: jinit())(jnp.arange(B))

    X_t, U_t = (torch.tensor(np.asarray(a)) for a in (X_tr, U_tr))
    tw = gen_tracking_mpc(tgrasp.grasp_problem(to, N, TF), X_t, U_t, N_mpc,
                          Qk=1e3, Rk=1.0, Qfk=10.0, dt=TF / (N - 1))
    tw = dataclasses.replace(tw, constraints=tgrasp.grasp_constraints(
        to, N_mpc, 0))
    # the window as the JAX package builds it, blocks and cost alike
    jtw = convert.problem_from_numpy(convert.numpy_tree(jw))
    _blocks_close(tw.constraints, jw.constraints)
    for k in ("Q", "q", "R", "r", "c"):
        close(getattr(tw.cost, k), getattr(jtw.cost, k), 1e-12)
    tstep, tinit = make_mpc_step(
        tw, tt.SolverOptions(**GRASP_WARM_OPTS), X_t, U_t,
        constraints_fn=lambda k: tgrasp.grasp_constraints(to, N_mpc, k),
        warm_start="shift")
    tcarry = tinit(B)
    close(tcarry[1], jcarry[1])
    close(tcarry[2], jcarry[2])
    for t in range(T):
        # the step index as a 64-bit integer: grasp_constraints slices with
        # it beside Python ints, which are 64-bit in float64 mode
        jcarry, jout = vstep(jcarry, jnp.asarray(noise[t]),
                             jnp.asarray(t, jnp.int64))
        tcarry, tout = tstep(tcarry, torch.as_tensor(noise[t]), t)
        assert tout.iters.tolist() == np.asarray(jout.iters).tolist(), t
        assert tout.status.tolist() == np.asarray(jout.status).tolist(), t
        assert int(tout.status.sum()) == B
        for k in ("X", "U", "viol", "x0"):
            close(getattr(tout, k), getattr(jout, k))


def test_bench_baselines_parse_the_reference_rows():
    """The conic bench divides by the reference ALTRO's mean ms per solve:
    grasp at N=21 (0.460 ms), the rocket at tolerance 1e-4 (0.581 ms)."""
    from altro_tpu_torch.bench import conic

    assert conic.grasp_baseline_solves_per_s() == pytest.approx(1000 / 0.460)
    assert conic.rocket_baseline_solves_per_s() == pytest.approx(1000 / 0.581)


def test_grasp_bench_plain_and_compacted_on_the_cpu():
    """``grasp_batched`` at B=8, T=2 on the CPU, plain and with a schedule
    small enough to gather (cap 1, block 4, level (1, 2)): the same solves
    and iterations, the passes counted over every batch the steps ran, and
    no kernel launched."""
    from altro_tpu_torch.bench import conic

    su = conic.grasp_setup(torch.float64, device="cpu")
    assert su.cold_status == 1 and su.cold_viol <= 1e-5 and su.cold_iters > 0
    counts = _counts()
    plain = conic.grasp_batched(B=8, T=2, device="cpu", setup=su)
    comp = conic.grasp_batched(B=8, T=2, device="cpu", setup=su,
                               compact_cap=1, compact_block=4,
                               compact_levels=((1, 2),))
    assert _counts() == counts
    for res in (plain, comp):
        assert res["success_rate"] == 1.0 and res["max_viol"] <= 1e-4
        assert res["solves"] == 1 + 2 + 2 + 2 and res["cold_solves"] == 2
    for k in ("mean_iters", "iters_max", "success_rate", "max_viol"):
        assert comp[k] == plain[k], k
    assert plain["compaction"] is None
    assert comp["compaction"] == [1, 4, [[1, 2]]]
    assert plain["passes_per_step"] == plain["iters_max_per_step_mean"]
    assert comp["passes_per_step"] >= plain["passes_per_step"]
