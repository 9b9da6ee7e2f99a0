"""Fused AL expansion + Riccati backward pass: the port's plain
``fused_expand_backward_reference`` against the JAX package in float64

- its Pallas kernel in interpret mode at n=5, m=3, N=7, B=4 (atol 1e-10),
- its composed plain path ``jax.vmap(_expand_backward_base)`` at the
  flagship's widths n=12, m=6 on N=11 with NONPOS multipliers |lambda| and a
  nonzero per-lane regularization (atol 1e-9), and with a second, ZERO block;

the wrapper's CPU dispatch; and, on a CUDA device, the kernel against the
plain version.

JAX is imported only by the tests that compare with it, so the kernel tests
also run where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_riccati_fused.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import altro_tpu_torch as tt  # noqa: E402
from altro_tpu_torch import convert  # noqa: E402
from altro_tpu_torch.models import random_linear as trl  # noqa: E402
from altro_tpu_torch.ops import riccati_fused  # noqa: E402

torch.set_num_threads(1)


def _lane_data(rng, N, n, m, ps, Bt, reg_scale, u_scale):
    return (rng.standard_normal((Bt, N, n)),
            u_scale * rng.standard_normal((Bt, N - 1, m)),
            tuple(np.abs(rng.standard_normal((Bt, N, p))) for p in ps),
            tuple(np.full((Bt, N), 10.0) for _ in ps),
            reg_scale * rng.random(Bt))


def _case(n, m, N, Bt, seed, goal=False, reg_scale=0.0, u_scale=1.0,
          with_jax=False):
    """A random-linear tracking window (plus a terminal ZERO goal block if
    ``goal``) and per-lane X, U, |lambda|, rho, reg: the port's arguments
    and, if ``with_jax``, the same arrays as the JAX package's arguments
    (one seed builds the same problem in both packages)."""
    def window(rl, pkg, rng):
        prob = rl.gen_random_linear(rng, n, m, N + 2)
        X_track, U_track = rl.gen_trajectory(rng, prob, N + 2)
        pm = rl.gen_tracking_mpc(prob, X_track, U_track, N)
        xf = rng.standard_normal(n)
        if goal:
            gc = pkg.goal_constraint(N, n, m, xf, dtype=X_track.dtype)
            pm = pkg.Problem(dynamics=pm.dynamics, cost=pm.cost,
                             constraints=pm.constraints + (gc,), x0=pm.x0)
        return pm

    tp = window(trl, tt, np.random.default_rng(seed))
    lane = _lane_data(np.random.default_rng(seed + 100), N, n, m,
                      [c.p for c in tp.constraints], Bt, reg_scale, u_scale)
    X, U, lams, rhos, reg = lane
    t = torch.as_tensor
    targs = (tp.cost, tp.dynamics.A, tp.dynamics.B, tp.constraints, t(X),
             t(U), tuple(map(t, lams)), tuple(map(t, rhos)), t(reg))
    if not with_jax:
        return targs
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import altro_tpu as at
    from altro_tpu.models import random_linear as jrl
    jp = window(jrl, at, np.random.default_rng(seed))
    a = jnp.asarray
    jargs = (jp.cost, jp.dynamics.A, jp.dynamics.B, jp.constraints, a(X),
             a(U), tuple(map(a, lams)), tuple(map(a, rhos)), a(reg))
    return targs, jargs


def _assert_close(got, want, atol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=atol,
                                   rtol=0)


@pytest.fixture(scope="module")
def interpret_case():
    """One interpret-mode run of the JAX Pallas kernel (slow on the CPU)."""
    targs, jargs = _case(5, 3, 7, 4, seed=0, reg_scale=0.5, with_jax=True)
    from altro_tpu.ops.riccati_fused import fused_expand_backward
    return targs, fused_expand_backward(*jargs, interpret=True)


def test_reference_matches_jax_pallas_interpret(interpret_case):
    targs, want = interpret_case
    _assert_close(riccati_fused.fused_expand_backward_reference(*targs), want,
                  atol=1e-10)


def test_wrapper_takes_plain_version_on_cpu(interpret_case):
    targs, want = interpret_case
    before = riccati_fused.launch_count
    got = riccati_fused.fused_expand_backward(*targs)
    assert riccati_fused.launch_count == before
    _assert_close(got, want, atol=1e-10)
    with pytest.raises(ValueError):
        riccati_fused.fused_expand_backward(*targs[:4], targs[4][:, :-1],
                                            *targs[5:])


@pytest.mark.parametrize("goal", [False, True], ids=["nonpos", "nonpos+zero"])
def test_reference_matches_jax_base_flagship_widths(goal):
    targs, jargs = _case(12, 6, 11, 3, seed=1, goal=goal, reg_scale=1e-2,
                         u_scale=3.0, with_jax=True)
    import jax

    from altro_tpu.solver.altro import _expand_backward_base
    want = jax.vmap(_expand_backward_base,
                    in_axes=(None, None, None, None, 0, 0, 0, 0, 0))(*jargs)
    _assert_close(riccati_fused.fused_expand_backward_reference(*targs), want,
                  atol=1e-9)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to run the hand-written kernel")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.float64, 1e-9)])
@pytest.mark.parametrize("widths,goal", [((5, 3, 7, 5), False),
                                         ((12, 6, 11, 9), False),
                                         ((12, 6, 11, 9), True),
                                         ((20, 9, 6, 3), False)])
def test_kernel_matches_plain_version(cuda, widths, goal, dtype, tol):
    """Relative tolerance: float32 rounding through the recursion (the dV
    terms reach 1e3-1e4); float64 only summation order."""
    targs = convert.tree_to(_case(*widths, seed=2, goal=goal, reg_scale=1e-2,
                                  u_scale=3.0), cuda, dtype)
    before = riccati_fused.launch_count
    got = riccati_fused.fused_expand_backward(*targs)
    torch.cuda.synchronize()
    assert riccati_fused.launch_count == before + 1
    for g, r in zip(got, riccati_fused.fused_expand_backward_reference(*targs)):
        assert float((g - r).abs().max()) <= tol * max(1.0,
                                                      float(r.abs().max()))


@pytest.mark.cuda
def test_kernel_refuses_soc_blocks(cuda):
    targs = convert.tree_to(_case(5, 3, 7, 2, seed=3), cuda, torch.float32)
    (con,) = targs[3]
    soc = (tt.ConicConstraint(Cx=con.Cx, Cu=con.Cu, b=con.b, mask=con.mask,
                              cone=tt.Cone.SOC),)
    with pytest.raises(NotImplementedError):
        riccati_fused.fused_expand_backward(*targs[:3], soc, *targs[4:])
