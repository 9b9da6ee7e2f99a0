"""Straggler compaction in the port, in float64 on the CPU, the cases of
``tests/test_compaction.py`` in the port's batched form:

- a rocket solve capped at 10 iterations, its unconverged lanes resumed in
  cycle-padded blocks of 4 and scattered back, equals the uncapped solve
  bit for bit (X, U, duals, iterations, status), and resuming a converged
  state runs no body pass;
- the device-compacted MPC step with a nested schedule (cap 1, block 4,
  level (1, 2)) on the rocket's tracking MPC (the random-linear window of
  the JAX test converges every lane in one iteration), in "shift" and
  "track" modes, equals the port's plain step bit for bit and the JAX
  package's compacted step to atol 1e-8 (iterations and status equal);
- the pieces of ``make_mpc_step_compacted`` (partial, block resume to an
  absolute cap, extract) give the plain step's results;

and, on a CUDA device, the compacted rocket and grasp steps against the
plain ones (equal status and iterations on every lane-step).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import altro_tpu_torch as tt  # noqa: E402
from altro_tpu_torch import convert  # noqa: E402
from altro_tpu_torch.models import rocket as trocket  # noqa: E402
from altro_tpu_torch.mpc import (make_mpc_step, make_mpc_step_compacted,  # noqa: E402
                                 make_mpc_step_device_compacted)
from altro_tpu_torch.solver import altro  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-8


def _leaves(state):
    out = []
    for a in state:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, tt.DualState):
            out += [a.lam, a.rho]
        else:
            out += _leaves(a)
    return out


def _gather(state, take):
    from altro_tpu_torch.mpc import _state_map
    return _state_map(lambda a: a[take], state)


def _scatter(state, take, sub):
    from altro_tpu_torch.mpc import _state_map
    return _state_map(lambda a, b: a.index_copy(0, take, b), state, sub)


def test_partial_resume_exact_conic():
    """Capped, then resumed in cycle-padded blocks of 4 unconverged lanes:
    bit for bit the uncapped solve."""
    tp = trocket.rocket_problem(N=31, tf=30 * 0.05)
    opts = tt.SolverOptions(cost_tolerance=1e-5, gradient_tolerance=1e-6,
                            constraint_tolerance=1e-4, penalty_initial=1e-2,
                            penalty_scaling=500.0, iterations_outer=40,
                            iterations_inner=100)
    rng = np.random.default_rng(0)
    x0s = tp.x0[None] + 0.1 * torch.as_tensor(rng.standard_normal((8, 6)))
    prob = dataclasses.replace(tp, x0=x0s)
    U0 = trocket.hover_controls(tp).expand(8, -1, -1).contiguous()

    ref = tt.solve(prob, opts, U0=U0)
    assert int(ref.stats.iterations.max()) > 10          # the cap binds

    before = altro.pass_count
    state = tt.solve_partial(prob, opts, U0=U0, it_cap=10)
    assert altro.pass_count - before == 10
    assert int(state[8].max()) == 10
    idx = torch.nonzero(~state[10])[:, 0]
    assert idx.numel() > 0
    for lo in range(0, idx.numel(), 4):
        take = idx[lo:lo + 4].repeat(4)[:4]              # cycle-padded
        sub = altro._flat_while(prob, opts, _gather(state, take))
        state = _scatter(state, take, sub)
    fin = altro._finalize(prob, state)
    for got, want in zip(_leaves((fin.X, fin.U, fin.K, fin.duals)),
                         _leaves((ref.X, ref.U, ref.K, ref.duals))):
        assert torch.equal(got, want)
    assert torch.equal(fin.stats.iterations, ref.stats.iterations)
    assert torch.equal(fin.stats.status, ref.stats.status)

    # a converged state resumes as a no-op: no body pass
    before = altro.pass_count
    again = tt.solve_resume(prob, opts, state)
    assert altro.pass_count == before
    assert torch.equal(again.U, ref.U)


@pytest.fixture(scope="module")
def rocket_window():
    """The rocket's MPC window at N_mpc=11 tracking the port's cold solve of
    the N=41 problem over 15 s, in both packages: (JAX window, port window,
    X_track, U_track). Its lanes take 2 to 50 iterations per step."""
    from altro_tpu.mpc import gen_tracking_mpc as j_gen
    from altro_tpu.models import rocket as jrocket
    import jax.numpy as jnp

    tp = trocket.rocket_problem(N=41, tf=15.0)
    cold = tt.solve(dataclasses.replace(tp, x0=tp.x0[None]), tt.SolverOptions(
        cost_tolerance=1e-5, gradient_tolerance=1e-6,
        constraint_tolerance=1e-4, penalty_initial=1e-2,
        penalty_scaling=500.0, iterations_outer=40, iterations_inner=100),
        U0=trocket.hover_controls(tp)[None])
    X_tr, U_tr = cold.X[0], cold.U[0]
    jw = j_gen(jrocket.rocket_problem(N=41, tf=15.0),
               jnp.asarray(X_tr.numpy()), jnp.asarray(U_tr.numpy()), 11,
               dt=0.05)
    return jw, convert.problem_from_numpy(convert.numpy_tree(jw)), X_tr, U_tr


# (warm start, noise seed): on this window one seed in twelve puts a lane at
# a line-search decision at round-off level in two steps, which the two
# packages take differently (tests/test_torch_rocket_slice.py); these do not
MODES = [("shift", 1), ("track", 1)]


@pytest.mark.parametrize("warm_start,seed", MODES)
def test_device_compacted_two_level_matches_plain(rocket_window, warm_start,
                                                  seed):
    """B=8 rocket lanes, two steps of the benchmark's warm options, with
    caps and blocks small enough that both levels and both catch-alls
    engage: bit for bit the port's plain step, and the JAX package's
    device-compacted step to 1e-8 with equal iterations and status."""
    import jax
    import jax.numpy as jnp
    import altro_tpu as at
    from altro_tpu.models import rocket as jrocket
    from altro_tpu.mpc import make_mpc_step_device_compacted as j_compacted

    from altro_tpu_torch.bench.conic import WARM_OPTS

    jw, tp, X_tr, U_tr = rocket_window
    B, T = 8, 2
    noise = np.random.default_rng(seed).standard_normal((T, B, 6))
    sched = dict(it_cap=1, block=4, levels=((1, 2),), warm_start=warm_start)

    jstep, jinit = j_compacted(jw, at.SolverOptions(**WARM_OPTS),
                               jnp.asarray(X_tr.numpy()),
                               jnp.asarray(U_tr.numpy()),
                               noise_model=jrocket.rocket_noise_model(),
                               **sched)
    jb = jax.jit(jstep)
    jcarry = jax.jit(jax.vmap(lambda _: jinit()))(jnp.arange(B))

    opts = tt.SolverOptions(**WARM_OPTS)
    noise_model = trocket.rocket_noise_model()
    pstep, pinit = make_mpc_step(tp, opts, X_tr, U_tr,
                                 noise_model=noise_model,
                                 warm_start=warm_start)
    cstep, cinit = make_mpc_step_device_compacted(
        tp, opts, X_tr, U_tr, noise_model=noise_model, **sched)
    pcarry = pinit(B)
    ccarry = cinit(B)
    for t in range(T):
        jcarry, jout = jb(jcarry, jnp.asarray(noise[t]),
                          jnp.asarray(t, jnp.int32))
        n_t = torch.as_tensor(noise[t])
        pcarry, pout = pstep(pcarry, n_t, t)
        before = altro.pass_count
        ccarry, cout = cstep(ccarry, n_t, t)
        # the block and the sub-block ran past the caps: the compacted step
        # makes more passes than its slowest lane's iterations
        assert int(cout.iters.max()) > 2
        assert altro.pass_count - before > int(cout.iters.max())
        for k in ("X", "U", "iters", "status", "viol", "x0"):
            assert torch.equal(getattr(cout, k), getattr(pout, k)), (t, k)
        for got, want in zip(_leaves(ccarry), _leaves(pcarry)):
            assert torch.equal(got, want)
        assert cout.iters.tolist() == np.asarray(jout.iters).tolist()
        assert cout.status.tolist() == np.asarray(jout.status).tolist()
        for k in ("X", "U", "viol"):
            np.testing.assert_allclose(getattr(cout, k).numpy(),
                                       np.asarray(getattr(jout, k)),
                                       atol=ATOL, rtol=0)


def test_compacted_pieces_match_plain(rocket_window):
    """partial (cap 1), a gathered block of 4 resumed to the absolute cap 3
    and then to completion, the rest resumed whole, extract: the plain
    step's results."""
    from altro_tpu_torch.bench.conic import WARM_OPTS

    _, tp, X_tr, U_tr = rocket_window
    opts = tt.SolverOptions(**WARM_OPTS)
    B, T = 8, 2
    noise = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (T, B, 6)))
    kw = dict(noise_model=trocket.rocket_noise_model(), warm_start="track")
    pstep, pinit = make_mpc_step(tp, opts, X_tr, U_tr, **kw)
    partial, resume, extract, cinit = make_mpc_step_compacted(
        tp, opts, X_tr, U_tr, it_cap=1, **kw)
    pcarry, ccarry = pinit(B), cinit(B)
    for t in range(T):
        pcarry, pout = pstep(pcarry, noise[t], t)
        state, x0n = partial(ccarry, noise[t], t)
        take = torch.argsort(state[10].to(torch.int32), stable=True)[:4]
        sub = resume(_gather(state, take), t, it_cap=3)
        assert int(sub[8].max()) == 3
        state = _scatter(state, take, resume(sub, t))
        ccarry, cout = extract(resume(state, t), x0n, t)
        for k in ("X", "U", "iters", "status", "viol"):
            assert torch.equal(getattr(cout, k), getattr(pout, k)), (t, k)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to run the hand-written kernels")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["rocket", "grasp"])
def test_compacted_matches_plain_on_the_card(cuda, family):
    """B=512, three steps from one carry in float32 on the kernels, with
    the shipped schedule's levels at half the block: equal status and
    iterations on every lane-step; controls within 1e-4 of the largest."""
    from altro_tpu_torch.bench import conic

    su = conic.SETUPS[family](torch.float32, device=cuda)
    cap, block, levels = conic.SCHEDULES[family]
    pstep, init = conic.make_step(su)
    cstep, _ = conic.make_step(su, cap, block // 2,
                               tuple((c, b // 2) for c, b in levels))
    carry = init(512)
    noise = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (3, 512, 6)), dtype=torch.float32, device=cuda)
    pc, cc = carry, carry
    for t in range(3):
        pc, pout = pstep(pc, noise[t], t)
        cc, cout = cstep(cc, noise[t], t)
        assert torch.equal(cout.status, pout.status)
        assert torch.equal(cout.iters, pout.iters)
        assert float((cout.U - pout.U).abs().max()) <= 1e-4 * max(
            1.0, float(pout.U.abs().max()))
