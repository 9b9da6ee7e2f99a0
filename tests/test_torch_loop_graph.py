"""The solver loop's on-device form (``altro_tpu_torch/solver/graph.py``)
on the CPU in float64, where the graphed route runs the same functions
over the same fixed buffers without capture:

- a bare ``LoopGraph`` (one body pass per replay) gives bit for bit the
  host loop's final state (X, U, K, duals, iterations, status) on the
  flagship, rocket, grasp and quadruped slices, with and without an
  iteration cap (the loop stops at the cap), its replays the passes
  counted;
- ``GraphedSolve`` with no compaction schedule, one level and two levels
  (a ``LoopSchedule``: shared problem buffers on the flagship, rocket and
  grasp, the lanes' own dynamics gathered on the quadruped) gives bit for
  bit the host-driven run of the same schedule (with no level, the plain
  solve) on the same four slices, and the plain solve's status and
  iterations;
- the fixed-buffer route over three consecutive steps equals the eager
  step bit for bit: the flagship (new cost targets every step), grasp (new
  constraint stacks every step), the rocket in a compaction schedule with
  three level batches, the pieces of ``make_mpc_step_compacted``, and the
  quadruped's ``GraphedSolve`` over two rounds with new initial states;
- a returned carry is not overwritten by the next step (no aliasing), and
  ``load`` rejects a mismatch in shape, dtype or tree structure;
- three flagship steps through the fixed-buffer route against the JAX
  package's ``make_mpc_step`` (equal iterations and status, X/U within
  1e-8);

and, on a CUDA device, graphed against eager at small sizes, the counters
after N replays, and the errors of a host sync in a captured body and of a
mismatched load.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import altro_tpu_torch as tt  # noqa: E402
from altro_tpu_torch.bench import conic  # noqa: E402
from altro_tpu_torch.bench.families import quadruped_setup  # noqa: E402
from altro_tpu_torch.bench.flagship import flagship_setup  # noqa: E402
from altro_tpu_torch.models import grasp as tgrasp  # noqa: E402
from altro_tpu_torch.models import rocket as trocket  # noqa: E402
from altro_tpu_torch.mpc import (gen_tracking_mpc, make_mpc_step,  # noqa: E402
                                 make_mpc_step_compacted,
                                 make_mpc_step_device_compacted)
from altro_tpu_torch.ops import pass_tail  # noqa: E402
from altro_tpu_torch.solver import altro, graph  # noqa: E402

torch.set_num_threads(1)
CAP = 2
ROCKET_COLD = dict(cost_tolerance=1e-5, gradient_tolerance=1e-6,
                   constraint_tolerance=1e-4, penalty_initial=1e-2,
                   penalty_scaling=500.0, iterations_outer=40,
                   iterations_inner=100)


def assert_trees_equal(got, want):
    gl, wl = graph.tensors(got), graph.tensors(want)
    assert len(gl) == len(wl)
    for i, (g, w) in enumerate(zip(gl, wl)):
        assert g.dtype == w.dtype and torch.equal(g, w), i


# ----------------------------------------------------------------------------
# the slices' cold batch solves: (prob, opts, U0)
# ----------------------------------------------------------------------------

def _flagship_cold():
    su = flagship_setup(8, 2, dtype=torch.float64, device="cpu")
    pm = su.prob_mpc
    x0 = pm.x0 + 0.5 * su.noise[0]
    return dataclasses.replace(pm, x0=x0), su.opts, None


def _rocket_cold():
    tp = trocket.rocket_problem(N=31, tf=30 * 0.05)
    rng = np.random.default_rng(0)
    x0 = tp.x0[None] + 0.1 * torch.as_tensor(rng.standard_normal((8, 6)))
    U0 = trocket.hover_controls(tp).expand(8, -1, -1).contiguous()
    return (dataclasses.replace(tp, x0=x0), tt.SolverOptions(**ROCKET_COLD),
            U0)


def _grasp_cold():
    """Grasp's cold N=61 problem (five blocks) on four perturbed lanes, on
    the fused ladder's branch."""
    o = tgrasp.make_grasp_object(conic.GRASP_N, conic.GRASP_TF)
    tp = tgrasp.grasp_problem(o, conic.GRASP_N, conic.GRASP_TF)
    rng = np.random.default_rng(1)
    x0 = tp.x0[None] + 0.01 * torch.as_tensor(rng.standard_normal((4, 6)))
    U0 = tgrasp.hover_controls(o, conic.GRASP_N).expand(4, -1, -1)
    return (dataclasses.replace(tp, x0=x0),
            tt.SolverOptions(**conic.GRASP_COLD_OPTS, ls_fused="on"),
            U0.contiguous())


def _quadruped_cold():
    su = quadruped_setup(16, False, torch.float64, "cpu")
    return dataclasses.replace(su.prob, x0=su.draw_x0()), su.opts, su.U0


SLICES = {"flagship": _flagship_cold, "rocket": _rocket_cold,
          "grasp": _grasp_cold, "quadruped": _quadruped_cold}


@pytest.fixture(scope="module")
def slices():
    """Per slice: (prob, opts, U0), built once."""
    made = {}

    def get(name):
        if name not in made:
            made[name] = SLICES[name]()
        return made[name]
    return get


@pytest.mark.parametrize("capped", [False, True], ids=["uncapped", "capped"])
@pytest.mark.parametrize("name", list(SLICES))
def test_loop_graph_matches_the_host_loop(slices, name, capped):
    """One body pass per replay: the final state is the host loop's, and
    the replays are the passes ``solver.altro.pass_count`` counted."""
    cap = CAP if capped else None
    prob, opts, U0 = slices(name)
    s0 = altro._warmstart_state(prob, opts, U0, None)
    ref = altro._flat_while(prob, opts, s0, cap)
    loop = graph.LoopGraph(prob, opts, s0)
    loop.set_cap(cap)
    before = altro.pass_count
    replays = loop.run()
    assert altro.pass_count - before == replays >= int(ref[8].max())
    assert_trees_equal(loop.state, ref)
    fin, want = altro._finalize(prob, loop.state), altro._finalize(prob, ref)
    assert_trees_equal((fin.X, fin.U, fin.K, fin.duals, fin.stats),
                       (want.X, want.U, want.K, want.duals, want.stats))
    if capped:
        # the loop stops at the cap, which binds on some lane
        assert int(loop.state[8].max()) == CAP
    else:
        assert int(loop.state[8].max()) > CAP


# compaction schedules small enough for the slices' batches of 4 to 16
SCHEDS = {"none": (), "one": ((2, 3),), "two": ((1, 4), (1, 2))}


def _host_schedule(prob, opts, U0, sched):
    """The cold solve in the compaction schedule ``sched`` driven from the
    host, as ``mpc._make_step``'s ``compact`` drives a step's and
    ``altro.solve_compacted`` one level: each level's lanes resumed as a
    batch of their own, with their dynamics where the problem has per-lane
    data, scattered back, then the level's catch-all."""
    def run(p, s, lvl, cum):
        if lvl == len(sched):
            return altro._flat_while(p, opts, s)
        cum += sched[lvl][0]
        s = altro._flat_while(p, opts, s, cum)
        take = torch.argsort(s[10].to(torch.int32),
                             stable=True)[:sched[lvl][1]]
        sub = run(altro.take_lanes(p, take) if p.per_lane else p,
                  altro.map_state(lambda a: a[take], s), lvl + 1, cum)
        s = altro.map_state(lambda a, b: a.index_copy(0, take, b), s, sub)
        return altro._flat_while(p, opts, s)
    s0 = altro._warmstart_state(prob, opts, U0, None)
    return altro._finalize(prob, run(prob, s0, 0, 0))


@pytest.fixture(scope="module")
def plain_solves(slices):
    """Per slice: the plain solve from the slice's controls."""
    made = {}

    def get(name):
        if name not in made:
            prob, opts, U0 = slices(name)
            made[name] = altro.solve(prob, opts, U0=U0)
        return made[name]
    return get


@pytest.mark.parametrize("sched", list(SCHEDS))
@pytest.mark.parametrize("name", list(SLICES))
def test_graphed_solve_schedule_matches_the_host_schedule(
        slices, plain_solves, name, sched):
    """A cold solve through a ``LoopSchedule`` of no, one and two levels,
    a level's lanes reading the parent's problem buffers (shared data) or
    their own gathered dynamics (the quadruped's per-lane stacks): the
    host-driven schedule's bits (with no level, the plain solve's), every
    lane's status and iterations the plain solve's; the replays are the
    passes counted. (The bits are held to the host-driven run of the same
    batches: on the CPU the plain version of kernel B rounds grasp's last
    bits differently at another batch size.)"""
    prob, opts, U0 = slices(name)
    plain = plain_solves(name)
    gs = graph.GraphedSolve(prob, opts, sched=SCHEDS[sched])
    levels = gs.levels.loops
    assert len(levels) == 1 + len(SCHEDS[sched])
    assert all((lp.prob is levels[0].prob) != prob.per_lane
               for lp in levels[1:])
    before = altro.pass_count
    got = gs(U0=U0)
    assert altro.pass_count - before == gs.replays
    assert_trees_equal(got, _host_schedule(prob, opts, U0, SCHEDS[sched])
                       if SCHEDS[sched] else plain)
    assert torch.equal(got.stats.status, plain.stats.status)
    assert torch.equal(got.stats.iterations, plain.stats.iterations)
    # the first cap binds: the schedule gathers unconverged lanes
    assert int(plain.stats.iterations.max()) > 2


# ----------------------------------------------------------------------------
# the fixed-buffer route against the eager step
# ----------------------------------------------------------------------------

def _run_steps(step, carry, noise, T):
    outs = []
    for t in range(T):
        carry, out = step(carry, noise[t], t)
        outs.append((carry, out))
    return outs


def _graphed_vs_eager(make, B, T, noise):
    """T steps of make(graphed=False) and make(graphed=True) from one cold
    carry each: bit for bit equal; the graphed route never enters the host
    loop."""
    estep, einit = make(graphed=False)
    eouts = _run_steps(estep, einit(B), noise, T)
    entries = altro.eager_loop_count
    gstep, ginit = make(graphed=True)
    gouts = _run_steps(gstep, ginit(B), noise, T)
    assert altro.eager_loop_count == entries
    assert gstep.loop_replays >= T
    for t, (g, e) in enumerate(zip(gouts, eouts)):
        assert_trees_equal(g, e)
    return gouts


def test_flagship_fixed_buffers_match_eager():
    su = flagship_setup(8, 3, dtype=torch.float64, device="cpu")
    _graphed_vs_eager(
        lambda graphed: make_mpc_step(su.prob_mpc, su.opts, su.X_track,
                                      su.U_track, graphed=graphed), 8, 3,
        su.noise)


@pytest.fixture(scope="module")
def grasp_su():
    return conic.grasp_setup(torch.float64, device="cpu")


def test_grasp_fixed_buffers_match_eager(grasp_su):
    """New constraint stacks every step (``constraints_fn``), copied into
    the start graph's buffers."""
    su = grasp_su
    noise = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (3, 8, 6)))
    outs = _graphed_vs_eager(
        lambda graphed: make_mpc_step(
            su.prob_mpc, su.opts, su.X_track, su.U_track,
            noise_model=su.noise_model, constraints_fn=su.constraints_fn,
            warm_start=su.warm_start, graphed=graphed), 8, 3, noise)
    assert int(outs[-1][1].status.sum()) == 8


@pytest.fixture(scope="module")
def rocket_window():
    """The rocket's N_mpc=11 window tracking the cold solve of the N=41
    problem over 15 s (``tests/test_torch_compaction.py``'s window: lanes
    take 2 to 50 iterations per step)."""
    tp = trocket.rocket_problem(N=41, tf=15.0)
    cold = tt.solve(dataclasses.replace(tp, x0=tp.x0[None]),
                    tt.SolverOptions(**ROCKET_COLD),
                    U0=trocket.hover_controls(tp)[None])
    X_tr, U_tr = cold.X[0], cold.U[0]
    return gen_tracking_mpc(tp, X_tr, U_tr, 11, dt=0.05), X_tr, U_tr


def test_rocket_compacted_fixed_buffers_match_eager(rocket_window):
    """Three level batches (8 lanes, a block of 4, a sub-block of 2), the
    gathers, scatters and catch-alls between them."""
    tp, X_tr, U_tr = rocket_window
    opts = tt.SolverOptions(**conic.WARM_OPTS)
    noise = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (3, 8, 6)))
    outs = _graphed_vs_eager(
        lambda graphed: make_mpc_step_device_compacted(
            tp, opts, X_tr, U_tr, noise_model=trocket.rocket_noise_model(),
            it_cap=1, block=4, levels=((1, 2),), warm_start="track",
            graphed=graphed), 8, 3, noise)
    assert max(int(o.iters.max()) for _, o in outs) > 2


def test_compacted_pieces_fixed_buffers_match_eager(rocket_window):
    """``make_mpc_step_compacted``'s partial, a gathered block resumed to an
    absolute cap and then to completion, and the rest resumed, on the
    fixed-buffer route: the eager pieces' results."""
    tp, X_tr, U_tr = rocket_window
    opts = tt.SolverOptions(**conic.WARM_OPTS)
    noise = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (2, 8, 6)))
    kw = dict(noise_model=trocket.rocket_noise_model(), warm_start="track",
              it_cap=1)
    runs = []
    for graphed in (False, True):
        partial, resume, extract, init = make_mpc_step_compacted(
            tp, opts, X_tr, U_tr, graphed=graphed, **kw)
        carry, outs = init(8), []
        for t in range(2):
            state, x0n = partial(carry, noise[t], t)
            take = torch.argsort(state[10].to(torch.int32), stable=True)[:4]
            sub = resume(tuple(_take(a, take) for a in state), t, it_cap=3)
            assert int(sub[8].max()) <= 3
            sub = resume(sub, t)
            state = tuple(_put(a, take, b) for a, b in zip(state, sub))
            carry, out = extract(resume(state, t), x0n, t)
            outs.append((carry, out))
        runs.append(outs)
    for g, e in zip(runs[1], runs[0]):
        assert_trees_equal(g, e)


def _take(a, idx):
    if isinstance(a, torch.Tensor):
        return a[idx]
    if isinstance(a, tt.DualState):
        return tt.DualState(lam=a.lam[idx], rho=a.rho[idx])
    return tuple(_take(x, idx) for x in a)


def _put(a, idx, b):
    if isinstance(a, torch.Tensor):
        return a.index_copy(0, idx, b)
    if isinstance(a, tt.DualState):
        return tt.DualState(lam=a.lam.index_copy(0, idx, b.lam),
                            rho=a.rho.index_copy(0, idx, b.rho))
    return tuple(_put(x, idx, y) for x, y in zip(a, b))


@pytest.mark.parametrize("linearized", [True, False], ids=["qp", "socp"])
def test_quadruped_graphed_solve_matches_eager(linearized):
    """Two rounds with new initial states through one GraphedSolve (the
    per-lane route: the PyTorch AL expansion and merit in the loop); the
    passes counted are the replays."""
    su = quadruped_setup(16, linearized, torch.float64, "cpu")
    gs = graph.GraphedSolve(su.prob, su.opts)
    entries = altro.eager_loop_count
    for _ in range(2):
        x0 = su.draw_x0()
        before, replays = altro.pass_count, gs.replays
        got = gs(x0, su.U0)
        assert altro.pass_count - before == gs.replays - replays
        assert altro.eager_loop_count == entries
        want = altro.solve(dataclasses.replace(su.prob, x0=x0), su.opts,
                           U0=su.U0)
        entries = altro.eager_loop_count
        assert_trees_equal(got, want)
        assert int(got.stats.status.sum()) == 16


def test_returned_carry_is_not_overwritten():
    """Step 1's carry and records are unchanged after step 2 has run from
    that carry on the fixed-buffer route."""
    su = flagship_setup(4, 2, dtype=torch.float64, device="cpu")
    step, init = make_mpc_step(su.prob_mpc, su.opts, su.X_track, su.U_track,
                               graphed=True)
    carry1, out1 = step(init(4), su.noise[0], 0)
    snap = graph.clone_tree((carry1, out1))
    carry2, out2 = step(carry1, su.noise[1], 1)
    assert_trees_equal((carry1, out1), snap)
    assert not torch.equal(out2.x0, out1.x0)
    ptrs = {t.data_ptr() for t in graph.tensors((carry2, out2))}
    assert not ptrs & {t.data_ptr() for t in graph.tensors((carry1, out1))}


def test_load_rejects_mismatches():
    prob, opts, U0 = _flagship_cold()
    s0 = altro._warmstart_state(prob, opts, U0, None)
    loop = graph.LoopGraph(prob, opts, s0)
    loop.load(prob, s0)
    with pytest.raises(ValueError, match="shape"):
        loop.load(state=tuple(a[:4] if isinstance(a, torch.Tensor) else a
                              for a in s0))
    with pytest.raises(ValueError, match="float32"):
        loop.load(state=(s0[0].float(),) + s0[1:])
    with pytest.raises(ValueError, match="tuple"):
        loop.load(state=s0[:3] + ((),) + s0[4:])
    with pytest.raises(ValueError):
        loop.load(prob=dataclasses.replace(prob, constraints=()))


def test_fixed_buffer_flagship_matches_jax():
    """Three flagship steps (the slice's random-linear MPC at n=6, m=3,
    N_mpc=11, B=4) through the fixed-buffer route against the JAX
    package's ``make_mpc_step`` in float64: equal iterations and status,
    X/U within 1e-8."""
    import jax
    import jax.numpy as jnp

    import altro_tpu as at
    from altro_tpu.models import random_linear as jrl
    from altro_tpu.mpc import make_mpc_step as j_make_mpc_step

    from altro_tpu_torch import convert

    T, B, N_mpc = 3, 4, 11
    rng = np.random.default_rng(1)
    jprob = jrl.gen_random_linear(rng, 6, 3, N_mpc + T + 2)
    X_track, U_track = jrl.gen_trajectory(rng, jprob, N_mpc + T + 2)
    prob_mpc = jrl.gen_tracking_mpc(jprob, X_track, U_track, N_mpc)
    noise = rng.standard_normal((T, B, 6))
    kw = dict(cost_tolerance=1e-4, gradient_tolerance=1e-4,
              constraint_tolerance=1e-4, penalty_initial=1e3,
              penalty_scaling=100.0, iterations_linesearch=2,
              early_exact_tol=1e-3)
    jstep, jinit = j_make_mpc_step(prob_mpc, at.SolverOptions(**kw), X_track,
                                   U_track, shared_k=True)
    vstep = jax.jit(jax.vmap(jstep, in_axes=(0, 0, None)))
    jcarry = jax.vmap(lambda _: jinit())(jnp.arange(B))
    tstep, tinit = make_mpc_step(
        convert.problem_from_numpy(convert.numpy_tree(prob_mpc)),
        tt.SolverOptions(**kw), torch.tensor(np.asarray(X_track)),
        torch.tensor(np.asarray(U_track)), graphed=True)
    tcarry = tinit(B)
    for t in range(T):
        jcarry, jout = vstep(jcarry, jnp.asarray(noise[t]),
                             jnp.asarray(t, jnp.int32))
        tcarry, tout = tstep(tcarry, torch.as_tensor(noise[t]), t)
        assert tout.iters.tolist() == np.asarray(jout.iters).tolist(), t
        assert tout.status.tolist() == np.asarray(jout.status).tolist(), t
        for k in ("X", "U"):
            np.testing.assert_allclose(getattr(tout, k).numpy(),
                                       np.asarray(getattr(jout, k)),
                                       atol=1e-8, rtol=0)


# ----------------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to capture CUDA graphs")
    return torch.device("cuda")


def _status_iters_equal(gouts, eouts):
    for (_, g), (_, e) in zip(gouts, eouts):
        assert torch.equal(g.status, e.status)
        assert torch.equal(g.iters, e.iters)
        assert float((g.U - e.U).abs().max()) <= 1e-4 * max(
            1.0, float(e.U.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["flagship", "rocket", "grasp"])
def test_graphed_step_matches_eager_on_the_card(cuda, family):
    """B=128, three steps from one carry in float32 on the kernels (the
    conic families in their shipped schedules, at B=128 their blocks clamp
    to the batch): equal status and iterations on every lane-step."""
    B, T = 128, 3
    if family == "flagship":
        su = flagship_setup(B, T, device=cuda)

        def make(graphed):
            return make_mpc_step(su.prob_mpc, su.opts, su.X_track,
                                 su.U_track, graphed=graphed)
        noise = su.noise
    else:
        su = conic.SETUPS[family](torch.float32, device=cuda)
        cap, block, levels = conic.SCHEDULES[family]

        def make(graphed):
            return conic.make_step(su, cap, block // 4,
                                   tuple((c, b // 4) for c, b in levels),
                                   graphed=graphed)
        noise = torch.as_tensor(np.random.default_rng(2).standard_normal(
            (T, B, 6)), dtype=torch.float32, device=cuda)
    estep, init = make(False)
    gstep, _ = make(True)
    carry = init(B)
    entries = altro.eager_loop_count
    gouts = _run_steps(gstep, carry, noise, T)
    assert altro.eager_loop_count == entries
    _status_iters_equal(gouts, _run_steps(estep, carry, noise, T))


@pytest.mark.cuda
def test_graphed_solve_matches_eager_on_the_card(cuda):
    su = quadruped_setup(128, False, torch.float32, cuda)
    gs = graph.GraphedSolve(su.prob, su.opts)
    for _ in range(2):
        x0 = su.draw_x0().to(cuda, torch.float32)
        got = gs(x0, su.U0)
        want = altro.solve(dataclasses.replace(su.prob, x0=x0), su.opts,
                           U0=su.U0)
        assert torch.equal(got.stats.status, want.stats.status)
        assert torch.equal(got.stats.iterations, want.stats.iterations)


@pytest.mark.cuda
def test_counters_count_replays(cuda):
    """Each replay adds what the capture recorded: one pass, kernel B and
    the ladder rollout once; the capture itself adds nothing."""
    from altro_tpu_torch.ops import riccati_fused, rollout

    su = flagship_setup(64, 1, device=cuda)
    pm = su.prob_mpc
    prob = dataclasses.replace(pm, x0=pm.x0 + 0.5 * su.noise[0])
    s0 = altro._warmstart_state(prob, su.opts, None, None)
    counts = (altro.pass_count, rollout.launch_count,
              riccati_fused.launch_count)
    loop = graph.LoopGraph(prob, su.opts, s0)
    assert (altro.pass_count, rollout.launch_count,
            riccati_fused.launch_count) == counts
    assert loop.per_replay[:3] == (1, 1, 1)
    for _ in range(5):
        loop.replay()
    assert (altro.pass_count - counts[0], rollout.launch_count - counts[1],
            riccati_fused.launch_count - counts[2]) == (5, 5, 5)

    # a cold solve: the ladder rollout once more per call (the init
    # rollout of its start graph), nothing for the set-up and the capture
    counts = (altro.pass_count, rollout.launch_count,
              riccati_fused.launch_count)
    gs = graph.GraphedSolve(prob, su.opts)
    assert (altro.pass_count, rollout.launch_count,
            riccati_fused.launch_count) == counts
    for _ in range(2):
        gs()
    passes = altro.pass_count - counts[0]
    assert passes == gs.replays
    assert rollout.launch_count - counts[1] == passes + 2
    assert riccati_fused.launch_count - counts[2] == passes


@pytest.mark.cuda
def test_host_sync_in_captured_body_raises(cuda, monkeypatch):
    """A body that reads a device value on the host cannot be captured: the
    LoopGraph raises instead of running the loop eagerly."""
    su = flagship_setup(64, 1, device=cuda)
    pm = su.prob_mpc
    prob = dataclasses.replace(pm, x0=pm.x0.expand(64, -1).contiguous())
    s0 = altro._warmstart_state(prob, su.opts, None, None)
    where = pass_tail._where_tree

    def syncing_where(pred, a, b):
        bool(pred.any())
        return where(pred, a, b)

    monkeypatch.setattr(pass_tail, "_where_tree", syncing_where)
    entries = altro.eager_loop_count
    with pytest.raises(RuntimeError):
        graph.LoopGraph(prob, su.opts, s0)
    assert altro.eager_loop_count == entries


@pytest.mark.cuda
def test_load_mismatch_raises_on_the_card(cuda):
    su = flagship_setup(64, 1, device=cuda)
    step, init = make_mpc_step(su.prob_mpc, su.opts, su.X_track,
                               su.U_track, graphed=True)
    carry = init(64)
    step(carry, su.noise[0], 0)
    with pytest.raises(ValueError, match="shape"):
        step(carry, su.noise[0][:32], 1)
    with pytest.raises(ValueError, match="float64"):
        step(carry, su.noise[0].double(), 1)
