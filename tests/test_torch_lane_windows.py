"""Per-lane constraint windows against the JAX package in float64 on the
CPU: ``make_mpc_step(shared_k=False, constraints_fn=...)`` on grasp (the
N_mpc=21 windows of the N=61 object, lanes at start windows 0-7, three
steps) against ``jax.vmap`` of the JAX package's default step with the same
``constraints_fn``; ``grasp_constraints`` with a [B] tensor of window
indices against its int branch lane by lane; the fixed-buffer route against
the eager step; and the refusals of compaction and ``take_lanes``.
"""
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
from altro_tpu_torch.bench.conic import (GRASP_COLD_OPTS,  # noqa: E402
                                         GRASP_WARM_OPTS)
from altro_tpu_torch.models import grasp as tgrasp  # noqa: E402
from altro_tpu_torch.mpc import (gen_tracking_mpc,  # noqa: E402
                                 make_mpc_step,
                                 make_mpc_step_device_compacted)
from altro_tpu_torch.ops import riccati_fused, rollout_al  # noqa: E402
from altro_tpu_torch.solver import altro  # noqa: E402
from altro_tpu_torch.solver.graph import tensors  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-8
N_OBJ, TF, N_MPC = 61, 6.0, 21
B, T = 8, 3
MPC_KW = dict(Qk=1e3, Rk=1.0, Qfk=10.0, dt=TF / (N_OBJ - 1))


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=atol,
                               rtol=0)


@pytest.fixture(scope="module")
def grasp():
    """Both packages' grasp MPC problems on one tracking reference: the
    port's cold N=61 solve from the hover controls (float64, CPU)."""
    to = tgrasp.make_grasp_object(N_OBJ, TF)
    tprob = tgrasp.grasp_problem(to, N_OBJ, TF)
    cold = tt.solve(dataclasses.replace(tprob, x0=tprob.x0[None]),
                    tt.SolverOptions(**GRASP_COLD_OPTS),
                    U0=tgrasp.hover_controls(to, N_OBJ)[None])
    assert int(cold.stats.status[0]) == 1
    X_t, U_t = cold.X[0], cold.U[0]
    pm_t = dataclasses.replace(
        gen_tracking_mpc(tprob, X_t, U_t, N_MPC, **MPC_KW),
        constraints=tgrasp.grasp_constraints(to, N_MPC, 0))
    jo = jgrasp.make_grasp_object(N_OBJ, TF)
    X_j, U_j = jnp.asarray(X_t.numpy()), jnp.asarray(U_t.numpy())
    pm_j = j_gen(jgrasp.grasp_problem(jo, N_OBJ, TF), X_j, U_j, N_MPC,
                 **MPC_KW).replace(
                     constraints=jgrasp.grasp_constraints(jo, N_MPC, 0))
    noise = np.random.default_rng(7).standard_normal((T, B, 6))
    return dict(to=to, jo=jo, pm_t=pm_t, pm_j=pm_j, X_t=X_t, U_t=U_t,
                X_j=X_j, U_j=U_j, noise=noise)


def _torch_step(g, graphed=False):
    to = g["to"]
    return make_mpc_step(
        g["pm_t"], tt.SolverOptions(**GRASP_WARM_OPTS), g["X_t"], g["U_t"],
        constraints_fn=lambda k: tgrasp.grasp_constraints(to, N_MPC, k),
        shared_k=False, graphed=graphed)


def test_lane_windows_match_jax_vmap(grasp):
    """Eight lanes at start windows 0-7, three steps: every lane-step's
    status and iterations equal, U, X, x0 and the violation within 1e-8,
    the carried window indices equal; the split route ran (kernels B and C
    never called)."""
    g = grasp
    jo = g["jo"]
    jstep, jinit = j_make_mpc_step(
        g["pm_j"], at.SolverOptions(**GRASP_WARM_OPTS), g["X_j"], g["U_j"],
        constraints_fn=lambda k: jgrasp.grasp_constraints(jo, N_MPC, k))
    vstep = jax.jit(jax.vmap(jstep))
    c0 = jax.jit(jinit)(0)
    jcarry = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (B,) + jnp.shape(a)), c0)
    jcarry = jcarry[:4] + (jnp.arange(B),)

    tstep, tinit = _torch_step(g)
    tcarry = tinit(B, torch.arange(B))
    close(tcarry[1], jcarry[1])
    b0, c0_ = riccati_fused.launch_count, rollout_al.launch_count
    for t in range(T):
        jcarry, jout = vstep(jcarry, jnp.asarray(g["noise"][t]))
        tcarry, tout = tstep(tcarry, torch.as_tensor(g["noise"][t]))
        assert tout.iters.tolist() == np.asarray(jout.iters).tolist(), t
        assert tout.status.tolist() == np.asarray(jout.status).tolist(), t
        assert int(tout.status.sum()) == B
        for k in ("U", "X", "x0", "viol"):
            close(getattr(tout, k), getattr(jout, k))
        assert tcarry[4].tolist() == np.asarray(jcarry[4]).tolist()
    assert (riccati_fused.launch_count, rollout_al.launch_count) == (b0, c0_)


def test_lane_windows_fixed_buffers_equal_eager(grasp):
    """The graphed form's route on the CPU (constraints_fn called inside
    the start function, its per-lane blocks copied into the loop's
    problem buffers) equals the host-driven step bit for bit."""
    g = grasp
    runs = {}
    for graphed in (False, True):
        step, init = _torch_step(g, graphed)
        carry = init(4, torch.tensor([5, 0, 7, 2]))
        for t in range(2):
            carry, out = step(carry, torch.as_tensor(g["noise"][t, :4]))
        runs[graphed] = (carry, out)
    (ce, oe), (cg, og) = runs[False], runs[True]
    for x, y in zip(tensors(ce), tensors(cg)):
        assert torch.equal(x, y)
    assert torch.equal(oe.U, og.U) and torch.equal(oe.iters, og.iters)
    assert ce[4].tolist() == [7, 2, 9, 4]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_grasp_constraints_lane_branch_equals_int_branch(dtype):
    """``grasp_constraints`` with a [B] tensor of window starts (negative
    and past-the-end ones clamped as ``lax.dynamic_slice`` clamps) equals
    the int branch lane by lane, bit for bit; the blocks are per lane."""
    o = tgrasp.make_grasp_object(N_OBJ, TF, dtype=dtype)
    ks = [0, 3, 7, 40, 45, -2, 99]
    lanes = tgrasp.grasp_constraints(o, N_MPC, torch.tensor(ks))
    assert all(c.per_lane and c.N == N_MPC for c in lanes)
    for b, k in enumerate(ks):
        for ref, c in zip(tgrasp.grasp_constraints(o, N_MPC, k), lanes):
            assert (ref.name, ref.cone, ref.p) == (c.name, c.cone, c.p)
            assert torch.equal(ref.mask, c.mask)
            for f in ("Cx", "Cu", "b"):
                got = getattr(c, f)[b]
                assert got.dtype == dtype
                assert torch.equal(getattr(ref, f), got), (c.name, f)
    with pytest.raises(ValueError):
        tgrasp.grasp_constraints(o, N_MPC, torch.tensor(ks),
                                 include_goal=True)


def test_per_lane_blocks_refused_by_compaction(grasp):
    """Compaction shares the window's problem between its level batches,
    so per-lane blocks raise in the compacted step and in ``take_lanes``;
    the same problem with shared blocks is accepted."""
    g = grasp
    opts = tt.SolverOptions(**GRASP_WARM_OPTS)
    lanes = tgrasp.grasp_constraints(g["to"], N_MPC, torch.arange(4))
    pm_l = dataclasses.replace(g["pm_t"], constraints=lanes)
    assert pm_l.per_lane and not g["pm_t"].per_lane
    with pytest.raises(NotImplementedError):
        make_mpc_step_device_compacted(pm_l, opts, g["X_t"], g["U_t"],
                                       it_cap=1, block=2, graphed=False)
    make_mpc_step_device_compacted(g["pm_t"], opts, g["X_t"], g["U_t"],
                                   it_cap=1, block=2, graphed=False)
    x0 = g["pm_t"].x0.expand(4, 6)
    take = torch.tensor([2, 0])
    with pytest.raises(ValueError):
        altro.take_lanes(dataclasses.replace(pm_l, x0=x0), take)
    sub = altro.take_lanes(dataclasses.replace(g["pm_t"], x0=x0), take)
    assert sub.x0.shape == (2, 6)
