"""The flexible-satellite regulator in the port against the JAX package in
float64 on the CPU:

- ``flexsat_AB`` and the N=80 problem's stacks to 1e-12, and the float32
  problem as the float64 build cast;
- the cold N=80 solve with the classical and the fused ladder (the fused
  one through kernel C's plain version, the JAX package's through its XLA
  composition): equal iterations and status, X/U within 1e-8;
- ``run_regulator_mpc`` for 3 steps on 2 lanes, each lane against the JAX
  package's single-scenario run (equal iterations and status, X/U within
  1e-8);
- 3 benchmark steps (re-based states, the benchmark's options) at B=4
  against the JAX benchmark's vmapped step: per-step status and iterations
  equal, X/U/viol within 1e-8;
- the compacted step against the plain step bit for bit, at a schedule
  (cap 1, block 2, level (1, 1)) whose innermost level runs a single lane;
- the fixed-buffer route (``graphed=True`` on the CPU) against the eager
  step bit for bit, plain and compacted;
- the kernel benchmark's inputs, the benchmark's row and the agreement
  gate at a tiny size;

and, on a CUDA device, the graphed step against the eager one and the
compacted step against the plain one (equal status and iterations on every
lane-step).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import altro_tpu_torch as tt  # noqa: E402
from altro_tpu_torch import convert  # noqa: E402
from altro_tpu_torch.bench import families  # noqa: E402
from altro_tpu_torch.models import flexible_satellite as tfs  # noqa: E402
from altro_tpu_torch.solver import altro, graph  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-8


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=atol,
                               rtol=0)


@pytest.fixture(scope="module")
def jprob():
    pytest.importorskip("jax")
    from altro_tpu.models import flexible_satellite as jfs
    return jfs.flexsat_problem()


@pytest.fixture(scope="module")
def tprob():
    return tfs.flexsat_problem()


def _jopts(**kw):
    import altro_tpu as at
    return at.SolverOptions(**dict(families.FLEXSAT_OPTS, **kw))


def _topts(**kw):
    return tt.SolverOptions(**dict(families.FLEXSAT_OPTS, **kw))


def test_model_matches_jax(jprob, tprob):
    """The discretization and every stack of the problem within 1e-12."""
    from altro_tpu.models import flexible_satellite as jfs

    for t, j in zip(tfs.flexsat_AB(), jfs.flexsat_AB()):
        close(t, j, 1e-12)
    tree = convert.numpy_tree(jprob)
    assert (tprob.n, tprob.m, tprob.N) == (12, 3, 80)
    for k in ("A", "B", "d"):
        close(getattr(tprob.dynamics, k), tree["dynamics"][k], 1e-12)
    for k in ("Q", "q", "R", "r", "H", "c"):
        close(getattr(tprob.cost, k), tree["cost"][k], 1e-12)
    (con,), (jcon,) = tprob.constraints, tree["constraints"]
    assert con.cone.value == jcon["cone"] and con.p == 6
    for k in ("Cx", "Cu", "b", "mask"):
        close(getattr(con, k), jcon[k], 1e-12)
    close(tprob.x0, tree["x0"], 0.0)


def test_float32_problem_is_the_float64_build_cast(tprob):
    p32 = tfs.flexsat_problem(dtype=torch.float32)
    assert p32.dynamics.A.dtype == torch.float32
    assert torch.equal(p32.dynamics.A, tprob.dynamics.A.float())
    assert torch.equal(p32.dynamics.B, tprob.dynamics.B.float())
    assert torch.equal(p32.cost.Q, tprob.cost.Q.float())


@pytest.mark.parametrize("ls_fused", ["off", "on"],
                         ids=["classical", "fused"])
def test_cold_solve_matches_jax(jprob, tprob, ls_fused):
    import jax

    import altro_tpu as at

    jsol = jax.jit(at.solve)(jprob, _jopts(ls_fused=ls_fused))
    tsol = tt.solve(dataclasses.replace(tprob, x0=tprob.x0[None]),
                    _topts(ls_fused=ls_fused))
    assert int(tsol.stats.status[0]) == int(jsol.stats.status) == 1
    assert int(tsol.stats.iterations[0]) == int(jsol.stats.iterations)
    assert (int(tsol.stats.outer_iterations[0])
            == int(jsol.stats.outer_iterations))
    close(tsol.X[0], jsol.X)
    close(tsol.U[0], jsol.U)
    close(tsol.stats.viol[0], jsol.stats.viol)


def test_run_regulator_mpc_matches_jax(jprob, tprob):
    """3 steps on 2 lanes (each lane's noise its own), the JAX package's
    test options; every solve runs its own init rollout."""
    import jax
    import jax.numpy as jnp

    import altro_tpu as at
    from altro_tpu.models import flexible_satellite as jfs

    T, B = 3, 2
    kw = dict(cost_tolerance=1e-4, constraint_tolerance=1e-4,
              penalty_initial=100.0, penalty_scaling=100.0)
    noise = np.random.default_rng(2).standard_normal((T, B, 12))
    jrun = jax.jit(jfs.run_regulator_mpc)
    jres = [jrun(jprob, at.SolverOptions(**kw), jnp.asarray(noise[:, b]))
            for b in range(B)]
    tres = tfs.run_regulator_mpc(tprob, tt.SolverOptions(**kw),
                                 tprob.x0.repeat(B, 1),
                                 torch.as_tensor(noise))
    assert tres.U.shape == (T, B, 79, 3)
    for b, jr in enumerate(jres):
        assert tres.iters[:, b].tolist() == np.asarray(jr.iters).tolist()
        assert tres.status[:, b].tolist() == np.asarray(jr.status).tolist()
        for k in ("X", "U", "viol", "x0"):
            close(getattr(tres, k)[:, b], getattr(jr, k))
    assert int(tres.status.sum()) == T * B


def _jax_astep(jprob, opts):
    """The JAX benchmark's regulator step (batched_families.py:78-96)."""
    import jax
    import jax.numpy as jnp

    import altro_tpu as at

    A0 = np.asarray(jprob.dynamics.A[0], np.float64)
    Ph = np.empty((jprob.N,) + A0.shape)
    Ph[0] = np.eye(A0.shape[0])
    for k in range(1, jprob.N):
        Ph[k] = A0 @ Ph[k - 1]
    Phis = jnp.asarray(Ph)

    def astep(carry, noise_i):
        x0, X, U, duals = carry
        x0n = jprob.dynamics.step(x0, U[0], 0) + 2e-4 * noise_i
        X0 = X + jnp.einsum("kij,j->ki", Phis, x0n - X[0])
        sol = at.solve(jprob.replace(x0=x0n), opts, U0=U, duals=duals,
                       X0=X0)
        return ((x0n, sol.X, sol.U, sol.duals),
                (sol.stats.status, sol.stats.viol, sol.stats.iterations,
                 sol.X, sol.U))

    sol0 = jax.jit(at.solve)(jprob, opts)
    return jax.jit(jax.vmap(astep)), (jprob.x0, sol0.X, sol0.U, sol0.duals)


def test_bench_steps_match_jax_vmapped_step(jprob):
    """3 steps of the benchmark's plain regulator step (re-based states,
    duals carried) at B=4 against the JAX benchmark's vmapped step."""
    import jax
    import jax.numpy as jnp

    T, B = 3, 4
    su = families.flexsat_setup(B, T, torch.float64, "cpu")
    vstep, jc0 = _jax_astep(jprob, _jopts())
    jcarry = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape), jc0)
    step, init_carry = families.flexsat_step(su, 0)
    tcarry = init_carry(B)
    close(tcarry[2], jcarry[2])
    for t in range(T):
        jcarry, (st, vl, it, X, U) = vstep(jcarry, jnp.asarray(
            su.noise[t].numpy()))
        tcarry, tout = step(tcarry, su.noise[t], t)
        assert tout.iters.tolist() == np.asarray(it).tolist(), t
        assert tout.status.tolist() == np.asarray(st).tolist(), t
        close(tout.X, X)
        close(tout.U, U)
        close(tout.viol, vl)
        close(tout.x0, jcarry[0])
    assert int(tout.status.sum()) == B


# (plain, compacted): the compacted step's innermost level gathers a single
# lane, which the plain step runs in a batch of four
SCHED_SMALL = (1, 2, ((1, 1),))


def _steps(step, carry, noise, T):
    outs = []
    for t in range(T):
        carry, out = step(carry, noise[t], t)
        outs.append((carry, out))
    return outs


def _assert_trees_equal(got, want):
    gl, wl = graph.tensors(got), graph.tensors(want)
    assert len(gl) == len(wl)
    for i, (g, w) in enumerate(zip(gl, wl)):
        assert g.dtype == w.dtype and torch.equal(g, w), i


@pytest.fixture(scope="module")
def small_su():
    return families.flexsat_setup(4, 3, torch.float64, "cpu")


@pytest.fixture(scope="module")
def plain_runs(small_su):
    step, init_carry = families.flexsat_step(small_su, 0, graphed=False)
    return _steps(step, init_carry(4), small_su.noise, 3)


def test_compacted_matches_plain_bit_for_bit(small_su, plain_runs):
    step, init_carry = families.flexsat_step(small_su, *SCHED_SMALL,
                                             graphed=False)
    carry = init_carry(4)
    for t, (pc, po) in enumerate(plain_runs):
        before = altro.pass_count
        carry, out = step(carry, small_su.noise[t], t)
        # the levels ran past their caps: more passes than the slowest
        # lane's iterations
        assert altro.pass_count - before > int(out.iters.max())
        _assert_trees_equal((carry, out), (pc, po))
    assert max(int(o.iters.max()) for _, o in plain_runs) > 2


@pytest.mark.parametrize("sched", [(0, 256, ()), SCHED_SMALL],
                         ids=["plain", "compacted"])
def test_fixed_buffer_route_matches_eager(small_su, plain_runs, sched):
    """The graphed form on the CPU (the same functions over the same fixed
    buffers, no capture) never enters the host loop and gives the eager
    step's bits."""
    step, init_carry = families.flexsat_step(small_su, *sched, graphed=True)
    entries = altro.eager_loop_count
    # the cold solve of init_carry runs through a GraphedSolve as well
    outs = _steps(step, init_carry(4), small_su.noise, 3)
    assert altro.eager_loop_count == entries
    assert step.loop_replays >= 3
    for got, want in zip(outs, plain_runs):
        _assert_trees_equal(got, want)


def test_kernel_inputs_run_through_the_wrappers():
    """The kernel benchmark's flexsat arguments (B=3 at N=80) through the
    wrappers' CPU routes, and the work counts of the bench shapes."""
    from altro_tpu_torch.bench.kernels import (FLEX_LADDER, bound_ms,
                                               flexsat_inputs, fused_work,
                                               rollout_al_work)
    from altro_tpu_torch.ops import riccati_fused, rollout_al

    f = flexsat_inputs(torch.float64, torch.device("cpu"), B=3)
    K, d, dV1, dV2 = riccati_fused.fused_expand_backward(*f["fused"],
                                                         packed=f["packed"])
    assert K.shape == (3, 79, 3, 12) and bool(torch.isfinite(K).all())
    assert f["ladder_al"][-1] == FLEX_LADDER
    Xs, Us, J = rollout_al.batched_ls_rollout_al(*f["ladder_al"],
                                                 packed=f["packed"])
    assert Xs.shape == (3, 6, 80, 12) and J.shape == (3, 6)
    assert bool(torch.isfinite(J).all())
    nbytes, flops = rollout_al_work(1024, 80, 12, 3, 6, 6, 4)
    assert bound_ms(nbytes, flops, 4)[1] == "bytes"
    assert fused_work(1024, 80, 12, 3, 6, (), 4)[1] > 0


def test_bench_row_on_the_cpu():
    """The benchmark's row at B=8, T=2 in the shipped schedule (its blocks
    clamp to the batch): the JAX row's keys, no kernel launch on the CPU,
    the passes of every solve counted."""
    res = families.flexsat_batched(B=8, T=2, device="cpu")
    for k in ("label", "batch", "steps", "solves_per_s", "success_rate",
              "max_viol", "mean_iters", "iters_p99", "wall_s"):
        assert k in res
    assert res["label"] == "flexsat_regulator_N80"
    assert res["success_rate"] == 1.0 and res["max_viol"] <= 1e-4
    assert res["cold_status"] == 1 and res["compaction"] == [8, 256,
                                                             [[8, 128]]]
    assert sum(res["launches"].values()) == 0
    assert res["loop_iterations"] >= res["cold_passes"] + 2


def test_agreement_phases_at_a_tiny_size():
    """The agreement gate's phases at B=4, 2 steps, 2 sampled lanes, all on
    the CPU: the float32 path succeeds within the violation gate, every
    float64 truth and tight solve succeeds, and each lane's relative
    true-cost gap is under 1e-2 (the gate's mean and p99 are statistics of
    3072 lane-steps on the card; 4 lane-steps of step 2 do not make
    them)."""
    from altro_tpu_torch.bench import agreement_flexsat as ag

    res = ag.run(B=4, device="cpu", sample=2, steps=2, check_steps=(2,))
    fb = res["fullbatch"]
    assert fb["lanes_x_windows"] == 4
    assert res["f32_success_rate"] == 1.0
    assert res["f32_max_viol"] <= ag.GATE_VIOL
    assert res["truth_success"] == 1 and fb["tight_success"] == 1.0
    assert max(abs(fb["gap_max"]), abs(fb["gap_min"])) < 1e-2
    assert res["err_U_max"] < 0.02


def test_agreement_check_fails_each_gate():
    """``check`` passes a result inside every gate and names each gate
    that a result misses."""
    from altro_tpu_torch.bench import agreement_flexsat as ag

    ok = dict(f32_success_rate=1.0, f32_max_viol=9e-5, truth_success=1,
              fullbatch=dict(gap_mean=2e-4, gap_abs_p99=3e-3))
    ag.check(ok)
    for change, what in ((dict(f32_success_rate=0.999), "success"),
                         (dict(f32_max_viol=2e-4), "max_viol"),
                         (dict(truth_success=0), "truth"),
                         (dict(fullbatch=dict(gap_mean=-2e-3,
                                              gap_abs_p99=3e-3)), "mean"),
                         (dict(fullbatch=dict(gap_mean=2e-4,
                                              gap_abs_p99=2e-2)), "p99")):
        with pytest.raises(AssertionError, match=what):
            ag.check(dict(ok, **change))


# ----------------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to run the hand-written kernels")
    return torch.device("cuda")


def _status_iters_equal(a, b):
    for (_, x), (_, y) in zip(a, b):
        assert torch.equal(x.status, y.status)
        assert torch.equal(x.iters, y.iters)
        assert float((x.U - y.U).abs().max()) <= 1e-4 * max(
            1.0, float(y.U.abs().max()))


@pytest.mark.cuda
def test_graphed_step_matches_eager_on_the_card(cuda):
    """B=512, three steps of the shipped schedule from one carry in
    float32 on the kernels: equal status and iterations on every
    lane-step."""
    su = families.flexsat_setup(512, 3, torch.float32, cuda)
    estep, init = families.flexsat_step(su, graphed=False)
    gstep, _ = families.flexsat_step(su, graphed=True)
    carry = init(512)
    entries = altro.eager_loop_count
    gouts = _steps(gstep, carry, su.noise, 3)
    assert altro.eager_loop_count == entries
    _status_iters_equal(gouts, _steps(estep, carry, su.noise, 3))


@pytest.mark.cuda
def test_compacted_matches_plain_on_the_card(cuda):
    """B=512, three steps from one carry in float32, the shipped schedule's
    levels at half the block: equal status and iterations on every
    lane-step."""
    su = families.flexsat_setup(512, 3, torch.float32, cuda)
    cap, block, levels = families.FLEXSAT_SCHEDULE
    pstep, init = families.flexsat_step(su, 0)
    cstep, _ = families.flexsat_step(su, cap, block // 2,
                                     tuple((c, b // 2) for c, b in levels))
    carry = init(512)
    _status_iters_equal(_steps(cstep, carry, su.noise, 3),
                        _steps(pstep, carry, su.noise, 3))
