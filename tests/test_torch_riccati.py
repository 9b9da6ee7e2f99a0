"""Riccati backward pass from precomputed expansions (kernel D): the port's
plain ``batched_riccati_reference`` against the JAX package

- its Pallas kernel ``batched_riccati`` in interpret mode at the shapes and
  tolerances of ``tests/test_riccati_kernel.py`` (float32 inputs), and in
  float64 at atol 1e-10,
- ``jax.vmap(backward_pass)`` (its plain scan on the CPU) in float64 at
  atol 1e-10, with per-lane and with shared A/B, at the quadruped's widths
  n = m = 12, N = 15;

the wrapper's CPU dispatch and its shape, dtype and contiguity checks; the
byte and FLOP counts that the kernel's bound is computed from; and, on a
CUDA device, the kernel against the plain version at every width of its
thread mapping, and its width limit.

The inputs are made by numpy from a seed: A near the identity, SPD lxx and
luu, so that Quu + reg I stays positive definite (where it is not, the
kernel clamps the pivots as the TPU kernel does and the plain version
returns NaN). JAX is imported only by the tests that compare with it, so the
kernel tests also run where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_riccati.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from altro_tpu_torch.ops import riccati  # noqa: E402
from altro_tpu_torch.solver.altro import backward_pass  # noqa: E402

torch.set_num_threads(1)
NAMES = ("A", "B", "lx", "lu", "lxx", "luu", "lux", "reg")


def _inputs(Bt, N, n, m, per_lane=True, seed=0, reg_scale=0.0):
    """Per-lane (or shared A/B) inputs; zero terminal control rows (the
    solver's convention)."""
    rng = np.random.default_rng(seed)
    lead = (Bt, N - 1) if per_lane else (N - 1,)
    A = 0.3 * rng.standard_normal(lead + (n, n)) + 0.8 * np.eye(n)
    B = 0.4 * rng.standard_normal(lead + (n, m))

    def spd(d):
        M = 0.3 * rng.standard_normal((Bt, N, d, d))
        return np.einsum("bkij,bklj->bkil", M, M) + np.eye(d)

    lxx, luu = spd(n), spd(m)
    lux = 0.1 * rng.standard_normal((Bt, N, m, n))
    lx = rng.standard_normal((Bt, N, n))
    lu = rng.standard_normal((Bt, N, m))
    lu[:, -1] = 0.0
    luu[:, -1] = 0.0
    lux[:, -1] = 0.0
    reg = reg_scale * rng.random(Bt)
    return dict(zip(NAMES, (A, B, lx, lu, lxx, luu, lux, reg)))


def _torch(inp, dtype=torch.float64, device="cpu"):
    return tuple(torch.as_tensor(inp[k], dtype=dtype, device=device)
                 for k in NAMES)


def _close(got, want, **tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **tol)


@pytest.mark.parametrize("dims", [(4, 12, 3, 2), (2, 8, 5, 3)])
def test_reference_matches_jax_pallas_interpret_f32(dims):
    """float32 inputs at the JAX kernel test's own tolerances."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from altro_tpu.ops.riccati import batched_riccati
    inp = _inputs(*dims)
    want = batched_riccati(*(jnp.asarray(inp[k], jnp.float32) for k in NAMES),
                           interpret=True)
    K, d, dV1, dV2 = riccati.batched_riccati_reference(
        *_torch(inp, torch.float32))
    _close((K, d), want[:2], atol=2e-4, rtol=1e-3)
    _close((dV1, dV2), want[2:], atol=1e-3, rtol=1e-3)


def test_reference_matches_jax_pallas_interpret_f64():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from altro_tpu.ops.riccati import batched_riccati
    inp = _inputs(3, 7, 5, 3, reg_scale=0.5, seed=1)
    want = batched_riccati(*(jnp.asarray(inp[k]) for k in NAMES),
                           interpret=True)
    _close(riccati.batched_riccati_reference(*_torch(inp)), want, atol=1e-10,
           rtol=0)


@pytest.mark.parametrize("per_lane", [True, False],
                         ids=["per_lane", "shared"])
def test_reference_matches_jax_scan(per_lane):
    """The quadruped's widths, with a nonzero per-lane regularization."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from altro_tpu.solver.altro import backward_pass as j_backward_pass
    inp = _inputs(3, 15, 12, 12, per_lane=per_lane, seed=2, reg_scale=1e-2)
    axes = (0, 0) if per_lane else (None, None)
    want = jax.vmap(j_backward_pass, in_axes=axes + (0,) * 6)(
        *(jnp.asarray(inp[k]) for k in NAMES))
    got = riccati.batched_riccati_reference(*_torch(inp))
    assert got[0].shape == (3, 14, 12, 12) and got[1].shape == (3, 14, 12)
    _close(got, want, atol=1e-10, rtol=0)


def test_wrapper_takes_plain_version_on_cpu():
    args = _torch(_inputs(4, 6, 5, 3, seed=3))
    before = riccati.launch_count
    got = riccati.batched_riccati(*args)
    via_solver = backward_pass(*args)
    assert riccati.launch_count == before
    for g, s, r in zip(got, via_solver,
                       riccati.batched_riccati_reference(*args)):
        assert torch.equal(g, r) and torch.equal(s, r)


def test_wrapper_takes_shared_hessians():
    """Shared [N, ...] Hessian stacks give what the same stacks broadcast
    to every lane give."""
    args = list(_torch(_inputs(3, 6, 5, 3, seed=4)))
    for i in (4, 5, 6):
        args[i] = args[i][0].contiguous()
    got = riccati.batched_riccati(*args)
    expanded = [a.expand((3,) + tuple(a.shape)) if i in (4, 5, 6) else a
                for i, a in enumerate(args)]
    _close(got, riccati.batched_riccati_reference(*expanded), atol=0, rtol=0)


def test_wrapper_checks():
    args = _torch(_inputs(4, 6, 5, 3, seed=5))

    def call(i, t):
        return riccati.batched_riccati(*args[:i], t, *args[i + 1:])

    with pytest.raises(ValueError, match="lux"):
        call(6, args[6][:, :-1])                     # wrong knot count
    with pytest.raises(ValueError, match="A"):
        call(0, args[0][:2])                         # per-lane A, wrong Bt
    with pytest.raises(TypeError, match="reg"):
        call(7, args[7].float())                     # mixed dtypes
    wide = torch.zeros(tuple(args[1].shape[:-1]) + (4,),
                       dtype=torch.float64)
    with pytest.raises(ValueError, match="contiguous"):
        call(1, wide[..., :3])                       # a strided view of B
    with pytest.raises(TypeError):
        riccati.batched_riccati(*(a.to(torch.float16) for a in args))


def test_work_counts_at_the_quadruped_shape():
    """The yardstick of the kernel's bound (bench/kernels.py): 53.5 MB and
    0.42 GFLOP (the upper triangles of Qxx and Quu) at B=1024, N=15,
    n=m=12 with per-lane dynamics in float32; shared dynamics save all but
    one copy of A and B."""
    from altro_tpu_torch.bench.kernels import bound_ms, riccati_work

    nbytes, flops = riccati_work(1024, 15, 12, 12, True, 4)
    assert (nbytes, flops) == (53_489_664, 423_198_720)
    ms, by = bound_ms(nbytes, flops, 4)
    assert by == "bytes" and abs(ms - 0.01597) < 1e-5
    shared = riccati_work(1024, 15, 12, 12, False, 4)
    assert nbytes - shared[0] == 1023 * 14 * 2 * 144 * 4
    assert shared[1] == flops


def test_bench_inputs_match_the_fused_kernels_plain_version():
    """The flagship arguments that the benchmark times the kernel on (shared
    dynamics, the solver's AL expansion of the inputs the fused kernel
    expands itself): the pass gives the fused kernel's plain version's
    gains."""
    from altro_tpu_torch.bench.kernels import flagship_inputs

    fl = flagship_inputs(torch.float64, torch.device("cpu"), B=3)
    assert fl["riccati"][0].shape == (29, 12, 12)          # shared A
    assert fl["riccati"][4].shape == (3, 30, 12, 12)       # per-lane lxx
    _close(riccati.batched_riccati(*fl["riccati"]), fl["fused_ref"],
           atol=1e-12, rtol=1e-12)


SPLIT_INPUTS = ("flagship", "rocket", "grasp")


def _split_inputs(name, dtype, dev, B):
    """Kernel D's arguments on the split route with shared dynamics
    (``bench/kernels.py``: the solver's AL expansion of the fused kernel's
    inputs) and the fused kernel's plain gains there."""
    from altro_tpu_torch.bench import kernels
    fn = {"flagship": kernels.flagship_inputs,
          "rocket": kernels.rocket_inputs,
          "grasp": kernels.grasp_inputs}[name]
    inp = fn(dtype, dev, B=B)
    return inp["riccati"], inp["fused_ref"]


@pytest.mark.parametrize("name", SPLIT_INPUTS[1:])
def test_split_inputs_match_the_fused_kernels_plain_version(name):
    """The rocket and grasp windows' split-route arguments (shared A/B,
    per-lane SOC curvature): the pass gives the fused kernel's plain
    version's gains."""
    args, fused_ref = _split_inputs(name, torch.float64,
                                    torch.device("cpu"), 3)
    assert args[0].dim() == 3 and args[4].dim() == 4   # shared A, lane lxx
    _close(riccati.batched_riccati(*args), fused_ref, atol=1e-9, rtol=1e-9)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to run the hand-written kernel")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.float64, 1e-9)])
# (Bt, N, n, m): the quadruped's shape; every padded width of the
# factorization (m up to 4, 8, 12, 16) with n < m and n > m, a tail block
# (Bt = 1023) and a single scenario; m + n at the warp's limit (15 + 16 + 1
# lanes) and one past it, which takes the generic body as n or m above 16 do.
@pytest.mark.parametrize("dims", [(1024, 15, 12, 12), (37, 7, 5, 3),
                                  (9, 6, 32, 32), (1, 5, 3, 4), (33, 6, 9, 6),
                                  (35, 5, 4, 7), (1023, 5, 7, 11),
                                  (21, 6, 12, 14), (5, 4, 15, 16),
                                  (6, 5, 16, 16), (7, 5, 20, 9),
                                  (7, 5, 9, 20)])
@pytest.mark.parametrize("per_lane", [True, False],
                         ids=["per_lane", "shared"])
def test_kernel_matches_plain_version(cuda, per_lane, dims, dtype, tol):
    """Relative to max(1, max|plain|): float32 rounding through the
    recursion; float64 only summation order."""
    args = _torch(_inputs(*dims, per_lane=per_lane, seed=6, reg_scale=1e-2),
                  dtype, cuda)
    before = riccati.launch_count
    got = riccati.batched_riccati(*args)
    torch.cuda.synchronize()
    assert riccati.launch_count == before + 1
    for g, r in zip(got, riccati.batched_riccati_reference(*args)):
        assert float((g - r).abs().max()) <= tol * max(1.0,
                                                      float(r.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.float64, 1e-9)])
@pytest.mark.parametrize("per_lane", [True, False],
                         ids=["per_lane", "shared"])
def test_kernel_nan_lane_stays_in_its_lane(cuda, per_lane, dtype, tol):
    """A NaN gradient of one lane at a middle knot makes that lane's gains
    NaN from that knot back to the first, and its dV; every other lane
    matches the plain version."""
    inp = _inputs(40, 8, 7, 6, per_lane=per_lane, seed=7, reg_scale=1e-2)
    inp["lx"][4, 5, 2] = np.nan
    args = _torch(inp, dtype, cuda)
    got = riccati.batched_riccati(*args)
    ref = riccati.batched_riccati_reference(*args)
    assert bool(torch.isnan(got[1][4, :5]).all())
    assert bool(torch.isfinite(got[1][4, 5:]).all())
    assert bool(torch.isnan(got[2][4]) & torch.isnan(got[3][4]))
    keep = torch.arange(40, device=cuda) != 4
    for g, r in zip(got, ref):
        assert float((g[keep] - r[keep]).abs().max()) <= tol * max(
            1.0, float(r[keep].abs().max()))


@pytest.mark.cuda
def test_kernel_refuses_wide_problems(cuda):
    args = _torch(_inputs(2, 4, 65, 3), torch.float32, cuda)
    with pytest.raises(ValueError, match="n, m <= 64"):
        riccati.batched_riccati(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.float64, 1e-9)])
@pytest.mark.parametrize("name", SPLIT_INPUTS[:2])
def test_kernel_shared_dynamics_on_the_split_route(cuda, name, dtype, tol):
    """Shared A/B with the solver's per-lane expansion at the flagship's
    (n=12, m=6, N=30) and the rocket window's (n=6, m=3, N=21, SOC
    curvature) shapes, B=1024: the kernel against the plain version."""
    args, _ = _split_inputs(name, dtype, cuda, 1024)
    got = riccati.batched_riccati(*args)
    ref = riccati.batched_riccati_reference(*args)
    assert all(bool(torch.isfinite(r).all()) for r in ref)
    for g, r in zip(got, ref):
        assert float((g - r).abs().max()) <= tol * max(1.0,
                                                      float(r.abs().max()))
