"""The layout probe of the port (``altro_tpu_torch/bench/layout.py``)
against the TPU probe ``tools/exp_layout.py`` and the JAX package:

- the probe's inputs (``layout.inputs`` at B=8, N=6, n=4, m=2, float64),
  through the port's ``batched_riccati``, equal ``jax.vmap`` of the JAX
  package's ``backward_pass`` and its Pallas kernel ``batched_riccati`` in
  interpret mode (the body the probe's ``raw_call`` times) on the same numpy
  arrays, to 1e-10;
- the inputs keep the probe's shapes and its shared, diagonal lxx; luu is
  symmetric;
- ``chain`` on the CPU over 3 repeats, run as it is and over the graphs'
  fixed buffers (no capture), gives d's mean within 1e-9 of one call's;
- the preparation hands the plain version its arguments as given on the
  CPU, and checks them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from altro_tpu_torch.bench import layout  # noqa: E402
from altro_tpu_torch.ops import riccati  # noqa: E402

SMALL = dict(B=8, N=6, n=4, m=2)


def test_inputs_through_the_port_equal_the_jax_package():
    import jax
    import jax.numpy as jnp

    from altro_tpu.ops.riccati import batched_riccati as j_kernel
    from altro_tpu.solver.altro import backward_pass as j_backward_pass

    args = layout.inputs(**SMALL, dtype=torch.float64, device="cpu")
    got = riccati.batched_riccati(*args)
    A1, B1, lx, lu, lxx, luu, lux, reg = (a.numpy() for a in args)
    B = SMALL["B"]
    A_b, B_b, lxx_b = (np.broadcast_to(t, (B,) + t.shape)
                       for t in (A1, B1, lxx))
    batched = tuple(jnp.asarray(t) for t in
                    (A_b, B_b, lx, lu, lxx_b, luu, lux, reg))
    for want in (jax.vmap(j_backward_pass)(*batched),
                 j_kernel(*batched, interpret=True)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-10,
                                       rtol=0)


def test_inputs_keep_the_probes_shapes():
    A1, B1, lx, lu, lxx, luu, lux, reg = layout.inputs(
        dtype=torch.float64, device="cpu")
    B, N, n, m = layout.B, layout.N, layout.n, layout.m
    assert (A1.shape, B1.shape) == ((N - 1, n, n), (N - 1, n, m))
    assert lxx.shape == (N, n, n)                  # shared: the wrapper copies
    assert torch.equal(lxx, torch.diag_embed(torch.diagonal(
        lxx, dim1=-2, dim2=-1)))
    assert luu.shape == (B, N, m, m) and torch.equal(luu, luu.mT)
    assert (lx.shape, lu.shape, lux.shape, reg.shape) == (
        (B, N, n), (B, N, m), (B, N, m, n), (B,))
    assert float(lxx.diagonal(dim1=-2, dim2=-1).min()) >= 1.0


@pytest.mark.parametrize("graphed", [False, True],
                         ids=["as_is", "fixed_buffers"])
def test_chain_equals_one_call(graphed):
    """Run as it is, and through ``Replayable``'s route over fixed buffers
    (on the CPU: no capture)."""
    args = layout.inputs(**SMALL, dtype=torch.float64, device="cpu")
    A1, B1, lx, lu, lxx, luu, lux, reg = args
    one = float(riccati.batched_riccati(*args)[1].mean())

    def fn(eps):
        return riccati.batched_riccati(A1, B1, lx + eps, lu, lxx, luu, lux,
                                       reg)[1].mean()
    ms, value = layout.chain(fn, repeats=3, samples=2, graphed=graphed,
                             dtype=torch.float64, device="cpu")
    assert ms > 0 and abs(value - one) <= 1e-9


def test_prepare_on_the_cpu_takes_the_arguments_as_given():
    """The preparation expands shared Hessians only for the kernel: on the
    CPU it hands the plain version what it was given."""
    args = layout.inputs(**SMALL, dtype=torch.float64, device="cpu")
    prep = riccati._prepare(*args)
    assert all(p is a for p, a in zip(prep, args))
    with pytest.raises(ValueError, match="lxx"):
        riccati._prepare(*args[:4], args[4][:-1], *args[5:])
