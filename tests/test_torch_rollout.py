"""Ladder rollout: the port's plain ``batched_ls_rollout_reference`` against
the JAX package's batched ladder rollout (``jax.vmap(_ls_rollouts_fn)``, its
plain path on the CPU) in float64 to atol 1e-10, for shared and per-lane
dynamics and ladders of 1 and 3 rungs; the wrapper's CPU dispatch; and, on a
CUDA device, the kernel against the plain version.

JAX is imported only by the tests that compare with it, so the kernel tests
also run where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_rollout.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from altro_tpu_torch.ops import rollout  # noqa: E402

torch.set_num_threads(1)
LADDERS = {1: (1.0,), 3: (1.0, 0.5, 0.0)}


def _inputs(per_lane, n=5, m=3, N=13, Bt=4, seed=0):
    rng = np.random.default_rng(seed)
    lead = (Bt, N - 1) if per_lane else (N - 1,)
    return dict(
        A=0.3 * rng.standard_normal(lead + (n, n)),
        B=0.4 * rng.standard_normal(lead + (n, m)),
        dd=0.1 * rng.standard_normal(lead + (n,)),
        Xbar=rng.standard_normal((Bt, N, n)),
        Ubar=rng.standard_normal((Bt, N - 1, m)),
        K=0.2 * rng.standard_normal((Bt, N - 1, m, n)),
        d=0.5 * rng.standard_normal((Bt, N - 1, m)))


def _torch(inp, dtype=torch.float64, device="cpu"):
    return {k: torch.as_tensor(v, dtype=dtype, device=device)
            for k, v in inp.items()}


def _args(t, alphas):
    return (t["A"], t["B"], t["dd"], t["Xbar"], t["Ubar"], t["K"], t["d"],
            alphas)


@pytest.mark.parametrize("L", [1, 3])
@pytest.mark.parametrize("per_lane", [False, True], ids=["shared", "per_lane"])
def test_reference_matches_jax(per_lane, L):
    jax = pytest.importorskip("jax")
    from altro_tpu.solver.altro import _ls_rollouts_fn

    alphas = LADDERS[L]
    inp = _inputs(per_lane)
    shared_axes = (0,) * 3 if per_lane else (None,) * 3
    Xs_j, Us_j = jax.vmap(_ls_rollouts_fn(alphas),
                          in_axes=shared_axes + (0,) * 4)(
        *(jax.numpy.asarray(inp[k]) for k in ("A", "B", "dd", "Xbar", "Ubar",
                                              "K", "d")))
    Xs, Us = rollout.batched_ls_rollout_reference(*_args(_torch(inp), alphas))
    assert Xs.shape == (4, L, 13, 5) and Us.shape == (4, L, 12, 3)
    np.testing.assert_allclose(Xs.numpy(), np.asarray(Xs_j), atol=1e-10)
    np.testing.assert_allclose(Us.numpy(), np.asarray(Us_j), atol=1e-10)


def test_wrapper_takes_plain_version_on_cpu():
    t = _torch(_inputs(False))
    args = _args(t, LADDERS[3])
    before = rollout.launch_count
    got = rollout.batched_ls_rollout(*args)
    ref = rollout.batched_ls_rollout_reference(*args)
    assert rollout.launch_count == before
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    with pytest.raises(ValueError):
        rollout.batched_ls_rollout(*args[:5], t["K"][:, :-1], *args[6:])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to run the hand-written kernel")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("shape", [(5, 3, 13, 7), (12, 12, 15, 9),
                                   (20, 9, 6, 3), (12, 6, 30, 1023)])
@pytest.mark.parametrize("per_lane", [False, True], ids=["shared", "per_lane"])
def test_kernel_matches_plain_version(cuda, per_lane, shape, dtype, tol):
    """Relative tolerance: float32 rounding over the horizon; float64 only
    summation order. Bt = 1023 leaves the last block one scenario short."""
    n, m, N, Bt = shape
    args = _args(_torch(_inputs(per_lane, n, m, N, Bt), dtype, cuda),
                 (1.0, 0.5, 0.25, 0.0))
    before = rollout.launch_count
    got = rollout.batched_ls_rollout(*args)
    torch.cuda.synchronize()
    assert rollout.launch_count == before + 1
    for g, r in zip(got, rollout.batched_ls_rollout_reference(*args)):
        scale = max(1.0, float(r.abs().max()))
        assert float((g - r).abs().max()) <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("per_lane", [False, True], ids=["shared", "per_lane"])
def test_kernel_at_width_limits(cuda, per_lane, dtype, tol):
    """n = m = 32 (groups of 32 lanes) and L = 32 rungs: 1024 threads per
    block."""
    args = _args(_torch(_inputs(per_lane, 32, 32, 5, 3), dtype, cuda),
                 tuple(0.9 ** i for i in range(31)) + (0.0,))
    got = rollout.batched_ls_rollout(*args)
    torch.cuda.synchronize()
    for g, r in zip(got, rollout.batched_ls_rollout_reference(*args)):
        assert float((g - r).abs().max()) <= tol * max(1.0,
                                                      float(r.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-12)])
def test_kernel_nan_lane_stays_in_its_lane(cuda, dtype, tol):
    """A NaN gain of one lane at knot 2 makes that lane's later states NaN
    on every rung; the other lanes, which share its block and its staged
    dynamics, match the plain version."""
    inp = _inputs(False, 12, 6, 8, 9)
    inp["K"][4, 2, 1, 3] = np.nan
    args = _args(_torch(inp, dtype, cuda), (1.0, 0.5, 0.0))
    Xs, Us = rollout.batched_ls_rollout(*args)
    Xr, Ur = rollout.batched_ls_rollout_reference(*args)
    torch.cuda.synchronize()
    keep = torch.arange(9, device=cuda) != 4
    assert bool(torch.isnan(Xs[4, :, 3:]).all())
    for g, r in ((Xs, Xr), (Us, Ur)):
        assert torch.isfinite(g[keep]).all()
        assert float((g[keep] - r[keep]).abs().max()) <= tol * max(
            1.0, float(r[keep].abs().max()))
