"""The four kernels at the TPU kernels' full width (n, m <= 64): on a CUDA
device each kernel's wide body (n or m above 32) against its plain version
at n in {33, 55, 64}, and each wrapper refusing n or m = 65; on the CPU the
wide inputs through the wrappers' plain dispatch, and the state_dim sweep's
widest point (n = 55, m = 2, N = 21) of the port's lockstep loop against
the JAX package's.

The kernel tests need no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_wide.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from altro_tpu_torch.bench import kernels as bk  # noqa: E402
from altro_tpu_torch.ops import (riccati, riccati_fused, rollout,  # noqa: E402
                                 rollout_al)

torch.set_num_threads(1)
# (n, m): past the group bodies by one, the state_dim sweep's widest point,
# the widest, and a wide state with a narrow control or the reverse
WIDTHS = [(33, 2), (55, 2), (64, 64), (33, 40), (12, 64)]
TOLS = [(torch.float32, 1e-3), (torch.float64, 1e-9)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to run the hand-written kernels")
    return torch.device("cuda")


def _close(got, ref, tol, truth=None):
    """max|got - ref| <= tol max(1, max|ref|), plus, given the float64
    answer on the same data (``truth``), four times the plain float32
    version's own distance from it: at these widths Quu reaches condition
    numbers where float32 rounding alone moves d by more than 1e-3 of its
    size (n = 12, m = 64: the plain version's d is 2.5e-2 off the float64
    answer, max|d| = 12.6), so the kernel is held to the plain version's
    accuracy there."""
    truth = ref if truth is None else truth
    for g, r, t in zip(got, ref, truth):
        assert torch.isfinite(r).all()
        r, t = r.double(), t.double().to(r.device)
        slack = 4.0 * float((r - t).abs().max())
        assert float((g.double() - r).abs().max()) <= tol * max(
            1.0, float(r.abs().max())) + slack


def test_wide_inputs_on_cpu():
    """The wide inputs' shapes and row cases, through every wrapper's plain
    dispatch (no launch)."""
    w = bk.wide_inputs(torch.float64, torch.device("cpu"), 3, 64, 64, N=5)
    assert w["packed"].P == 12 and w["packed"].meta == ((0, 8, 1),
                                                        (8, 4, 2))
    counts = [rollout.launch_count, riccati_fused.launch_count,
              rollout_al.launch_count, riccati.launch_count]
    K, d, dV1, dV2 = riccati_fused.fused_expand_backward(
        *w["fused"], packed=w["packed"])
    assert K.shape == (3, 4, 64, 64) and d.shape == (3, 4, 64)
    _close(riccati.batched_riccati(*w["riccati"]), w["fused_ref"], 1e-12)
    Xs, Us = rollout.batched_ls_rollout(*w["ladder"])
    assert Xs.shape == (3, 11, 5, 64) and Us.shape == (3, 11, 4, 64)
    Xa, Ua, J = rollout_al.batched_ls_rollout_al(*w["ladder_al"])
    assert torch.equal(Xa, Xs) and torch.equal(Ua, Us)
    assert J.shape == (3, 11) and torch.isfinite(J).all()
    assert counts == [rollout.launch_count, riccati_fused.launch_count,
                      rollout_al.launch_count, riccati.launch_count]
    nbytes, flops = bk.fused_work(1024, 21, 64, 64, 12, (4,), 8)
    assert nbytes > 0 and flops > 1024 * 21 * 2 * 64 ** 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("widths", WIDTHS, ids=lambda w: f"n{w[0]}m{w[1]}")
@pytest.mark.parametrize("Bt", [1, 37])
def test_wide_kernels_match_plain_versions(cuda, widths, Bt, dtype, tol):
    """Relative to max(1, max|plain|), the tolerances of the group bodies'
    tests (float32 rounding through the recursions; float64 summation
    order); J per lane against max(1, |J|)."""
    from altro_tpu_torch.convert import tree_to
    w = bk.wide_inputs(dtype, cuda, Bt, *widths, N=9)

    def truth(fn, args):    # the plain version in float64 on the same data
        return fn(*tree_to(args, cuda, torch.float64))
    counts = (rollout.launch_count, riccati_fused.launch_count,
              rollout_al.launch_count, riccati.launch_count)
    _close(riccati_fused.fused_expand_backward(*w["fused"],
                                               packed=w["packed"]),
           w["fused_ref"], tol,
           truth(riccati_fused.fused_expand_backward_reference, w["fused"]))
    _close(riccati.batched_riccati(*w["riccati"]),
           riccati.batched_riccati_reference(*w["riccati"]), tol,
           truth(riccati.batched_riccati_reference, w["riccati"]))
    for key in ("ladder", "init"):
        _close(rollout.batched_ls_rollout(*w[key]),
               rollout.batched_ls_rollout_reference(*w[key]), tol,
               truth(rollout.batched_ls_rollout_reference, w[key]))
    Xs, Us, J = rollout_al.batched_ls_rollout_al(*w["ladder_al"],
                                                 packed=w["packed"])
    Xr, Ur, Jr = rollout_al.batched_ls_rollout_al_reference(*w["ladder_al"])
    X6, U6, J6 = truth(rollout_al.batched_ls_rollout_al_reference,
                       w["ladder_al"])
    torch.cuda.synchronize()
    _close((Xs, Us), (Xr, Ur), tol, (X6, U6))
    slack = 4.0 * (Jr.double() - J6).abs()
    assert bool(((J - Jr).abs().double()
                 <= tol * Jr.abs().double().clamp(min=1.0) + slack).all())
    assert (rollout.launch_count, riccati_fused.launch_count,
            rollout_al.launch_count, riccati.launch_count) == (
        counts[0] + 2, counts[1] + 1, counts[2] + 1, counts[3] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("per_lane", [False, True],
                         ids=["shared", "per_lane"])
def test_wide_ladder_per_lane_dynamics(cuda, per_lane):
    """Kernel A's and D's wide bodies with per-lane dynamics."""
    w = bk.wide_inputs(torch.float64, cuda, 5, 40, 3, N=7)
    A, B, dd = w["ladder"][:3]
    if per_lane:
        rng = np.random.default_rng(3)
        scale = torch.as_tensor(1.0 + 0.1 * rng.standard_normal((5, 1, 1,
                                                                 1)),
                                dtype=A.dtype, device=cuda)
        A = (A[None] * scale).contiguous()
        B = (B[None] * scale).contiguous()
        dd = dd[None].expand(5, -1, -1).contiguous()
    largs = (A, B, dd) + w["ladder"][3:]
    _close(rollout.batched_ls_rollout(*largs),
           rollout.batched_ls_rollout_reference(*largs), 1e-9)
    rargs = (A, B) + w["riccati"][2:]
    _close(riccati.batched_riccati(*rargs),
           riccati.batched_riccati_reference(*rargs), 1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("widths", [(65, 2), (12, 65)])
def test_wide_kernels_refuse_past_64(cuda, widths):
    """Each wrapper raises for n or m = 65, before any launch."""
    w = bk.wide_inputs(torch.float32, cuda, 2, *widths, N=4)
    counts = (rollout.launch_count, riccati_fused.launch_count,
              rollout_al.launch_count, riccati.launch_count)
    with pytest.raises(ValueError, match="n, m <= 64"):
        riccati_fused.fused_expand_backward(*w["fused"])
    with pytest.raises(ValueError, match="n, m <= 64"):
        riccati.batched_riccati(*w["riccati"])
    with pytest.raises(ValueError, match="n, m <= 64"):
        rollout.batched_ls_rollout(*w["ladder"])
    with pytest.raises(ValueError, match="n, m <= 64"):
        rollout_al.batched_ls_rollout_al(*w["ladder_al"])
    assert counts == (rollout.launch_count, riccati_fused.launch_count,
                      rollout_al.launch_count, riccati.launch_count)


def test_state_dim_n55_matches_jax():
    """The state_dim sweep's widest point (n = 55, m = 2, N = 21, seed 10,
    the sweep's options) in float64 on the CPU, the port's plain path
    against the JAX package: the first window's solve (equal iterations and
    status, X and U within 1e-8), then T = 3 steps of the lockstep loop
    against the dense ADMM QP (equal iterations and status on both sides,
    err_X and err_U within 1e-8)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import altro_tpu as at
    import altro_tpu_torch as tt
    from altro_tpu.models import random_linear as jrl
    from altro_tpu.mpc import run_mpc_lockstep as jlock
    from altro_tpu_torch.models import random_linear as trl
    from altro_tpu_torch.mpc import run_mpc_lockstep

    n, m, N, T = 55, 2, 21, 3
    kw = dict(cost_tolerance=1e-4, constraint_tolerance=1e-4,
              gradient_tolerance=1e-4, penalty_initial=1e3,
              penalty_scaling=100.0, reset_duals=False)
    built = []
    for rl in (jrl, trl):
        rng = np.random.default_rng(10)
        p = rl.gen_random_linear(rng, n, m, N + T + 2)
        X, U = rl.gen_trajectory(rng, p, N + T + 2)
        noise = rng.standard_normal((T, n))
        built.append((rl.gen_tracking_mpc(p, X, U, N), X, U, noise))
    (jp, jX, jU, noise), (tp, tX, tU, tnoise) = built
    np.testing.assert_array_equal(noise, tnoise)

    jsol = at.solve(jp, at.SolverOptions(**kw))
    sol = tt.solve(tt.Problem(
        dynamics=tp.dynamics, cost=tp.cost, constraints=tp.constraints,
        x0=tp.x0[None]), tt.SolverOptions(**kw))
    assert int(sol.stats.iterations[0]) == int(jsol.stats.iterations)
    assert int(sol.stats.status[0]) == int(jsol.stats.status)
    np.testing.assert_allclose(sol.X[0].numpy(), np.asarray(jsol.X),
                               atol=1e-8)
    np.testing.assert_allclose(sol.U[0].numpy(), np.asarray(jsol.U),
                               atol=1e-8)

    jres = jlock(jp, at.SolverOptions(**kw), jX, jU, jnp.asarray(noise),
                 qp_eps=1e-6)
    res = run_mpc_lockstep(tp, tt.SolverOptions(**kw), tX, tU,
                           torch.tensor(noise), qp_eps=1e-6)
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(jres.iters))
    np.testing.assert_array_equal(res.status.numpy(),
                                  np.asarray(jres.status))
    assert int(res.status.sum()) == 2 * T
    for name in ("err_X", "err_U"):
        np.testing.assert_allclose(getattr(res, name).numpy(),
                                   np.asarray(getattr(jres, name)),
                                   atol=1e-8)
