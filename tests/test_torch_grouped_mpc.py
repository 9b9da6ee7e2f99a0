"""The MPC step on grouped dynamics (``LTVDynamics(grouped=True)``: stacks
[G, N-1, ...], lane b in group b // (B / G)) in float64 on the CPU:

- ``gen_tracking_mpc`` keeps the flag (a [G, N-1, ...] stack never comes
  back as a per-lane stack of G lanes);
- the exact seam corrector returns None for grouped stacks (the solve runs
  its init rollout) and the regulator step refuses them;
- the device-compacted step refuses them (its level batches would re-read
  the groups by their position in the block): G=2, n=4, m=2, N=8, B=8, a
  +-0.5 control bound, cap 1, block 2, while the same problem on one
  group's shared stacks compacts bit for bit;
- the plain grouped ``make_mpc_step(shared_k=True)``, two steps, against
  the JAX package's ``make_mpc_step(shared_k=True)`` run once per group on
  that group's lanes: equal status and iterations, U and X within 1e-8.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import altro_tpu as at  # noqa: E402
from altro_tpu.constraints import bound_constraint as j_bound  # noqa: E402
from altro_tpu.models import random_linear as jrl  # noqa: E402
from altro_tpu.mpc import make_mpc_step as j_make_mpc_step  # noqa: E402

import altro_tpu_torch as tt  # noqa: E402
from altro_tpu_torch.constraints import bound_constraint  # noqa: E402
from altro_tpu_torch.dynamics import LTVDynamics  # noqa: E402
from altro_tpu_torch.models import random_linear as trl  # noqa: E402
from altro_tpu_torch.mpc import (_xws_corrector, gen_tracking_mpc,  # noqa
                                 make_mpc_step,
                                 make_mpc_step_device_compacted,
                                 make_regulator_step)
from altro_tpu_torch.solver.graph import tensors  # noqa: E402

torch.set_num_threads(1)
G, n, m, N_MPC, B, T = 2, 4, 2, 8, 8, 2
N_TRACK = N_MPC + T + 2
BOUND = 0.5
KW = dict(cost_tolerance=1e-4, gradient_tolerance=1e-4,
          constraint_tolerance=1e-4, penalty_initial=1e3,
          penalty_scaling=100.0, reset_duals=False, iterations_linesearch=2)
SEEDS = (21, 22)


@pytest.fixture(scope="module")
def grouped():
    """Two random-linear systems (one per group) in both packages, the
    tracking reference of the first, a +-0.5 control bound; the port's
    grouped long problem and window, the JAX package's window per group."""
    t_probs = [trl.gen_random_linear(np.random.default_rng(s), n, m,
                                     N_TRACK) for s in SEEDS]
    j_probs = [jrl.gen_random_linear(np.random.default_rng(s), n, m,
                                     N_TRACK) for s in SEEDS]
    for tp, jp in zip(t_probs, j_probs):
        np.testing.assert_array_equal(tp.dynamics.A.numpy(),
                                      np.asarray(jp.dynamics.A))
    rng = np.random.default_rng(23)
    X_t, U_t = trl.gen_trajectory(rng, t_probs[0], N_TRACK)
    bound = (bound_constraint(N_TRACK, n, m, u_min=-BOUND, u_max=BOUND,
                              dtype=torch.float64),)
    dyns = [p.dynamics for p in t_probs]
    long = dataclasses.replace(
        t_probs[0], constraints=bound,
        dynamics=LTVDynamics(A=torch.stack([d.A for d in dyns]),
                             B=torch.stack([d.B for d in dyns]),
                             d=torch.stack([d.d for d in dyns]),
                             grouped=True))
    X_j, U_j = jnp.asarray(X_t.numpy()), jnp.asarray(U_t.numpy())
    jb = (j_bound(N_TRACK, n, m, u_min=-BOUND, u_max=BOUND),)
    j_windows = [jrl.gen_tracking_mpc(jp.replace(constraints=jb), X_j, U_j,
                                      N_MPC) for jp in j_probs]
    noise = np.random.default_rng(24).standard_normal((T, B, n))
    return dict(long=long, pm=gen_tracking_mpc(long, X_t, U_t, N_MPC),
                X_t=X_t, U_t=U_t, X_j=X_j, U_j=U_j, j_windows=j_windows,
                noise=noise)


def test_gen_tracking_mpc_keeps_grouped(grouped):
    dyn = grouped["pm"].dynamics
    assert dyn.grouped and not dyn.per_lane and dyn.groups == G
    assert dyn.A.shape == (G, N_MPC - 1, n, n)
    assert dyn.d.shape == (G, N_MPC - 1, n)
    for g in range(G):
        assert torch.equal(dyn.A[g], grouped["long"].dynamics.A[g,
                                                                :N_MPC - 1])


def test_grouped_refusals(grouped):
    """No seam corrector and no regulator step on grouped stacks, and the
    compacted step raises: the case that returned U 0.33 away from the
    plain step, every status 1."""
    pm = grouped["pm"]
    opts = tt.SolverOptions(**KW)
    assert _xws_corrector(pm.dynamics) is None
    with pytest.raises(ValueError, match="grouped"):
        make_regulator_step(pm, opts, graphed=False)
    with pytest.raises(NotImplementedError, match="grouped"):
        make_mpc_step_device_compacted(pm, opts, grouped["X_t"],
                                       grouped["U_t"], it_cap=1, block=2,
                                       graphed=False)


def test_shared_control_compacts_bit_for_bit(grouped):
    """The same window on group 0's shared stacks: compacted (cap 1, block
    2) equals the plain step bit for bit over two steps."""
    pm = grouped["pm"]
    dyn = pm.dynamics
    shared = dataclasses.replace(pm, dynamics=LTVDynamics(
        A=dyn.A[0], B=dyn.B[0], d=dyn.d[0]))
    assert _xws_corrector(shared.dynamics) is not None
    opts = tt.SolverOptions(**KW)
    args = (shared, opts, grouped["X_t"], grouped["U_t"])
    plain, init = make_mpc_step(*args, graphed=False)
    comp, _ = make_mpc_step_device_compacted(*args, it_cap=1, block=2,
                                             graphed=False)
    c1 = c2 = init(B)
    for t in range(T):
        nz = torch.as_tensor(grouped["noise"][t])
        c1, o1 = plain(c1, nz, t)
        c2, o2 = comp(c2, nz, t)
        for a, b in zip(tensors(c1), tensors(c2)):
            assert torch.equal(a, b)
        assert torch.equal(o1.iters, o2.iters)


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "buffers"])
def test_grouped_step_matches_jax_per_group(grouped, graphed):
    """The grouped plain step (B=8, 4 lanes a group), eagerly and on the
    fixed-buffer route, against the JAX package's shared-k step vmapped
    over each group's lanes with that group's window."""
    opts = tt.SolverOptions(**KW)
    step, init = make_mpc_step(grouped["pm"], opts, grouped["X_t"],
                               grouped["U_t"], graphed=graphed)
    carry = init(B)
    touts = []
    for t in range(T):
        carry, out = step(carry, torch.as_tensor(grouped["noise"][t]), t)
        touts.append(out)
    lanes = B // G
    for g, pm_j in enumerate(grouped["j_windows"]):
        jstep, jinit = j_make_mpc_step(pm_j, at.SolverOptions(**KW),
                                       grouped["X_j"], grouped["U_j"],
                                       shared_k=True)
        vstep = jax.jit(jax.vmap(jstep, in_axes=(0, 0, None)))
        jc = jax.tree_util.tree_map(
            lambda a: jnp.broadcast_to(a, (lanes,) + jnp.shape(a)),
            jax.jit(jinit)())
        sl = slice(g * lanes, (g + 1) * lanes)
        for t in range(T):
            jc, jout = vstep(jc, jnp.asarray(grouped["noise"][t, sl]),
                             jnp.asarray(t))
            tout = touts[t]
            assert (tout.iters[sl].tolist()
                    == np.asarray(jout.iters).tolist()), (g, t)
            assert (tout.status[sl].tolist()
                    == np.asarray(jout.status).tolist()), (g, t)
            for k in ("U", "X", "x0"):
                np.testing.assert_allclose(
                    getattr(tout, k)[sl].numpy(),
                    np.asarray(getattr(jout, k)), atol=1e-8, rtol=0)
    assert int(torch.stack([o.status for o in touts]).sum()) == T * B
