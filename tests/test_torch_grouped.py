"""The quadruped's grouped layout and the flat layout's straggler compaction
in the port, in float64 on the CPU unless marked ``cuda``:

- a grouped ``LTVDynamics`` ([G, N-1, ...], flagged) equals the flat
  repeat of its stacks: ``step``, ``rollout``, ``linearize`` and
  ``lanes()``, bit for bit;
- the plain versions of kernels B, C and A with a group axis equal the
  shared plain version run group by group, bit for bit (G=3, 2 lanes a
  group, a random-linear window with a NONPOS block);
- the port's grouped plain B against the JAX package's Pallas kernel in
  interpret mode under ``jax.vmap`` over G=2 groups (the grid-prepend
  batching the JAX package ships) at n=5, m=3, N=7, 4 lanes a group:
  within 1e-10 of each output's largest entry;
- the grouped quadruped solve at B=16 (8 schedules x 2 lanes), both
  friction modes, against the JAX package's ``jax.vmap(jax.vmap(solve_one,
  in_axes=(None, 0)))`` (``batched_families.py:296-306``): equal status and
  iterations, X and U within 1e-8 (the flat path's bar: the ill-conditioned
  Quu puts the two packages' gains ~1e-8 apart, see
  ``test_torch_quadruped_slice.py``); and against the port's flat solve:
  equal status, U within 1e-8 (the grouped route's expansion and Riccati
  pass are fused and the flat route's split, so they agree to round-off);
- ``quadruped_batched``: grouped with compact_cap raises, and its rows
  carry the JAX row's keys;
- the compacted flat solve at B=16 (cap 1, block 4: more unconverged lanes
  than the block, so the catch-all resumes the rest) bit-equal to the plain
  solve, eagerly and on the fixed-buffer route, and equal in status and
  iterations to the JAX package's compacted ``solve_batch``
  (``batched_families.py:316-334``);

and, on a CUDA device, the group-indexed kernels B, C and A against their
plain versions and, bit for bit, against the shared kernel launched once
per group, at 128 lanes a group and at a ragged 3, and kernel B's body at
the grouped quadruped's shape and the rocket's (``python -m pytest
--noconftest -m cuda tests/test_torch_grouped.py``; JAX is imported only by
the tests that compare with it).
"""
import ast
import dataclasses
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import altro_tpu_torch as tt  # noqa: E402
from altro_tpu_torch import convert  # noqa: E402
from altro_tpu_torch.bench import families  # noqa: E402
from altro_tpu_torch.bench.families import OPTS, quadruped_setup  # noqa: E402
from altro_tpu_torch.models import random_linear as trl  # noqa: E402
from altro_tpu_torch.ops import (riccati_fused, rollout,  # noqa: E402
                                 rollout_al)
from altro_tpu_torch.solver import altro, graph  # noqa: E402

torch.set_num_threads(1)
F64 = torch.float64
B = 16


def test_grouped_dynamics_equal_the_flat_repeat():
    flat = quadruped_setup(B, False, F64, "cpu").prob.dynamics
    grp = quadruped_setup(B, False, F64, "cpu", grouped=True).prob.dynamics
    assert grp.grouped and not grp.per_lane and grp.groups == 8
    assert flat.per_lane and not flat.grouped and flat.groups == 0
    # an unflagged [8, N-1, ...] stack is per lane, never grouped
    assert tt.LTVDynamics(A=grp.A, B=grp.B, d=grp.d).per_lane
    with pytest.raises(ValueError):
        tt.LTVDynamics(A=grp.A[0], B=grp.B[0], d=grp.d[0], grouped=True)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((B, 12)))
    U = torch.as_tensor(rng.standard_normal((B, grp.N - 1, 12)))
    for k in (0, 5, grp.N - 2):
        assert torch.equal(grp.step(x, U[:, k], k), flat.step(x, U[:, k], k))
    X = grp.rollout(x, U)
    assert torch.equal(X, flat.rollout(x, U))
    for a, b in zip(grp.linearize(X, U), flat.linearize(X, U)):
        assert torch.equal(a, b)
    lanes = grp.lanes(B)
    for k in ("A", "B", "d"):
        assert torch.equal(getattr(lanes, k), getattr(flat, k))
    with pytest.raises(ValueError):
        grp.lanes(B + 1)


def _group_case(G, reps, seed=3, n=5, m=3, N=7):
    """A random-linear window's cost and NONPOS block shared by G groups,
    each group with its own window's dynamics, and per-lane X, U, |lambda|,
    rho, reg and gains for G * reps lanes."""
    rng = np.random.default_rng(seed)
    dyns, pm = [], None
    for _ in range(G):
        full = trl.gen_random_linear(rng, n, m, N + 2)
        p = trl.gen_tracking_mpc(full, *trl.gen_trajectory(rng, full, N + 2),
                                 N)
        pm = pm or p
        dyns.append(p.dynamics)
    A, Bm, d = (torch.stack([getattr(dd, k) for dd in dyns])
                for k in ("A", "B", "d"))
    Bt = G * reps
    t = torch.as_tensor
    (con,) = pm.constraints
    X = t(rng.standard_normal((Bt, N, n)))
    U = t(3.0 * rng.standard_normal((Bt, N - 1, m)))
    lam = t(np.abs(rng.standard_normal((Bt, N, con.p))))
    rho = t(np.full((Bt, N), 10.0))
    reg = t(0.5 * rng.random(Bt))
    K = t(0.1 * rng.standard_normal((Bt, N - 1, m, n)))
    dff = t(rng.standard_normal((Bt, N - 1, m)))
    return pm, (A, Bm, d), X, U, (lam,), (rho,), reg, K, dff


def test_plain_versions_equal_the_shared_plain_version_group_by_group():
    G, reps = 3, 2
    pm, (A, Bm, d), X, U, lams, rhos, reg, K, dff = _group_case(G, reps)
    ladder = (1.0, 0.5, 0.25, 0.0)
    got_b = riccati_fused.fused_expand_backward(
        pm.cost, A, Bm, pm.constraints, X, U, lams, rhos, reg, grouped=True)
    got_c = rollout_al.batched_ls_rollout_al(
        pm.cost, A, Bm, d, pm.constraints, X, U, K, dff, lams, rhos[0],
        ladder, grouped=True)
    got_a = rollout.batched_ls_rollout(A, Bm, d, X, U, K, dff, ladder,
                                       grouped=True)
    for g in range(G):
        sl = slice(g * reps, (g + 1) * reps)
        want_b = riccati_fused.fused_expand_backward_reference(
            pm.cost, A[g], Bm[g], pm.constraints, X[sl], U[sl],
            (lams[0][sl],), (rhos[0][sl],), reg[sl])
        want_c = rollout_al.batched_ls_rollout_al_reference(
            pm.cost, A[g], Bm[g], d[g], pm.constraints, X[sl], U[sl], K[sl],
            dff[sl], (lams[0][sl],), rhos[0][sl], ladder)
        want_a = rollout.batched_ls_rollout_reference(
            A[g], Bm[g], d[g], X[sl], U[sl], K[sl], dff[sl], ladder)
        for got, want in ((got_b, want_b), (got_c, want_c),
                          (got_a, want_a)):
            for a, b in zip(got, want):
                assert torch.equal(a[sl], b)
    # the group axis is a flag: without it the [G, N-1, ...] stacks are
    # refused by B and C (shared data) and by A (not per lane at G != Bt)
    with pytest.raises(ValueError):
        riccati_fused.fused_expand_backward(
            pm.cost, A, Bm, pm.constraints, X, U, lams, rhos, reg)
    with pytest.raises(ValueError):
        rollout.batched_ls_rollout(A, Bm, d, X, U, K, dff, ladder)
    with pytest.raises(ValueError):     # 6 lanes are not 4 equal groups
        rollout.batched_ls_rollout(torch.cat([A, A[:1]]),
                                   torch.cat([Bm, Bm[:1]]),
                                   torch.cat([d, d[:1]]), X, U, K, dff,
                                   ladder, grouped=True)


def test_grouped_plain_b_matches_jax_pallas_interpret_under_vmap():
    """jax.vmap over 2 groups of the JAX package's Pallas kernel in
    interpret mode (each group: its own dynamics, shared cost and block,
    4 lanes) against the port's grouped plain version."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from altro_tpu.models import random_linear as jrl
    from altro_tpu.ops.riccati_fused import fused_expand_backward

    G, reps, n, m, N = 2, 4, 5, 3, 7

    def windows(rl):
        rng = np.random.default_rng(5)
        out = []
        for _ in range(G):
            full = rl.gen_random_linear(rng, n, m, N + 2)
            out.append(rl.gen_tracking_mpc(
                full, *rl.gen_trajectory(rng, full, N + 2), N))
        return out

    tw, jw = windows(trl), windows(jrl)
    rng = np.random.default_rng(105)
    p = tw[0].constraints[0].p
    X = rng.standard_normal((G * reps, N, n))
    U = 3.0 * rng.standard_normal((G * reps, N - 1, m))
    lam = np.abs(rng.standard_normal((G * reps, N, p)))
    rho = np.full((G * reps, N), 10.0)
    reg = 0.5 * rng.random(G * reps)
    jA = jnp.stack([w.dynamics.A for w in jw])
    jB = jnp.stack([w.dynamics.B for w in jw])

    def per_group(dA, dB, Xg, Ug, lg, rg, regg):
        return fused_expand_backward(jw[0].cost, dA, dB, jw[0].constraints,
                                     Xg, Ug, (lg,), (rg,), regg,
                                     interpret=True)

    def g(a):
        return jnp.asarray(a.reshape((G, reps) + a.shape[1:]))

    want = jax.vmap(per_group)(jA, jB, g(X), g(U), g(lam), g(rho), g(reg))
    t = torch.as_tensor
    got = riccati_fused.fused_expand_backward(
        tw[0].cost, torch.stack([w.dynamics.A for w in tw]),
        torch.stack([w.dynamics.B for w in tw]), tw[0].constraints, t(X),
        t(U), (t(lam),), (t(rho),), t(reg), grouped=True)
    for a, b in zip(got, want):
        b = np.asarray(b).reshape(a.shape)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-10 * max(1.0, np.abs(b).max()))


def _jax_stack(lin):
    """The JAX package's 8 schedules' problems stacked (one entry per
    group), in float64, as its ``quadruped_setup`` builds them."""
    import jax
    import jax.numpy as jnp

    from altro_tpu.models.quadruped import config as jconfig
    from altro_tpu.models.quadruped import controller as jcontroller
    from altro_tpu.models.quadruped import planner as jplanner
    from altro_tpu.models.quadruped.gait import GAITS

    cfg = jconfig.MPCConfig(linearized_friction=lin)
    gait = GAITS[cfg.gait_type](cfg.stance_time, cfg.swing_time)
    prob, x_des = jcontroller.build_mpc_problem(cfg, jnp.float64)
    N, dt = cfg.N, cfg.dynamics_discretization
    cycle = cfg.stance_time + cfg.swing_time
    feet0 = (x_des[0:3][None, :] + jplanner.nominal_foot_locations()
             ).at[:, 2].set(jconfig.woofer.geometry.foot_radius)
    x_ref = jnp.tile(x_des, (N, 1))

    def one(t):
        contacts, locs, _ = jplanner.foot_history(t, x_ref, feet0, feet0,
                                                  gait, x_des, N, dt)
        return jcontroller._linearized_problem(prob, x_des, x_ref, contacts,
                                               locs, dt)

    return jax.jit(jax.vmap(one))(jnp.asarray([i * cycle / 8
                                               for i in range(8)]))


@pytest.mark.parametrize("lin", [True, False], ids=["qp", "socp"])
def test_grouped_solve_matches_jax_nested_vmap_and_the_flat_solve(lin):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import altro_tpu as at

    jstack = _jax_stack(lin)
    su = quadruped_setup(B, lin, F64, "cpu", grouped=True)
    x0 = su.draw_x0()
    # the JAX package's grouped problem, carried across, equals the port's
    tprob = dataclasses.replace(convert.problem_from_numpy(
        convert.numpy_tree(jstack), grouped=True), x0=x0)
    assert tprob.dynamics.grouped
    for k in ("A", "B", "d"):
        np.testing.assert_allclose(getattr(tprob.dynamics, k).numpy(),
                                   getattr(su.prob.dynamics, k).numpy(),
                                   rtol=0, atol=1e-12)
    jopts = at.SolverOptions(**OPTS)
    u0 = jnp.asarray(su.U0[0].numpy())

    def solve_one(prob_k, x0_k):
        sol = at.solve(prob_k.replace(x0=x0_k), jopts, U0=u0)
        return sol.X, sol.U, sol.stats.status, sol.stats.iterations

    jX, jU, jst, jit_ = jax.jit(jax.vmap(
        jax.vmap(solve_one, in_axes=(None, 0)), in_axes=(0, 0)))(
        jstack, jnp.asarray(x0.numpy().reshape(8, B // 8, 12)))
    sol = tt.solve(tprob, tt.SolverOptions(**OPTS), U0=su.U0)
    assert sol.stats.status.tolist() == np.asarray(jst).ravel().tolist()
    assert int(sol.stats.status.sum()) == B
    assert sol.stats.iterations.tolist() == np.asarray(jit_).ravel().tolist()
    np.testing.assert_allclose(sol.X.numpy(),
                               np.asarray(jX).reshape(sol.X.shape),
                               atol=1e-8, rtol=0)
    np.testing.assert_allclose(sol.U.numpy(),
                               np.asarray(jU).reshape(sol.U.shape),
                               atol=1e-8, rtol=0)

    flat = quadruped_setup(B, lin, F64, "cpu")
    fsol = tt.solve(dataclasses.replace(flat.prob, x0=x0), flat.opts,
                    U0=flat.U0)
    assert torch.equal(fsol.stats.status, sol.stats.status)
    np.testing.assert_allclose(sol.U.numpy(), fsol.U.numpy(), atol=1e-8,
                               rtol=0)


def _jax_row_keys() -> set:
    """The keys of the JAX package's quadruped_batched row: every keyword
    of its ``dict(...)`` calls and every string subscript assigned to."""
    from altro_tpu.bench import batched_families
    tree = ast.parse(inspect.getsource(batched_families.quadruped_batched))
    keys = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "dict"):
            keys.update(k.arg for k in node.keywords if k.arg)
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if (isinstance(t, ast.Subscript)
                        and isinstance(t.slice, ast.Constant)
                        and isinstance(t.slice.value, str)):
                    keys.add(t.slice.value)
    return keys


def test_quadruped_batched_options_and_row_keys():
    pytest.importorskip("jax")
    with pytest.raises(ValueError, match="exclude"):
        families.quadruped_batched(B=B, rounds=1, device="cpu",
                                   grouped=True, compact_cap=8)
    rows = [families.quadruped_batched(B=B, rounds=1, device="cpu",
                                       graphed=g, **kw)
            for g, kw in ((True, dict(grouped=True)),
                          (False, dict(compact_cap=1, compact_block=4)))]
    jkeys = _jax_row_keys()
    assert {"grouped", "compact_it_cap", "compact_block"} <= jkeys
    assert not jkeys - set(rows[0]) - {"compact_it_cap", "compact_block"}
    assert not jkeys - set(rows[1]) - {"grouped"}
    assert rows[0]["grouped"] is True and "compact_it_cap" not in rows[0]
    assert (rows[1]["compact_it_cap"], rows[1]["compact_block"]) == (1, 4)
    for r in rows:
        assert r["success_rate"] == 1.0 and r["batch"] == B
    # the grouped row's solves take kernel B's and C's plain versions on
    # the CPU: no launch
    assert not any(rows[0]["launches"].values())


def _jax_compacted(lin, x0, U0, cap, block):
    """The JAX package's compacted ``solve_batch`` (batched_families.py:
    316-334) on its flat problem: (status, iterations)."""
    import jax
    import jax.numpy as jnp

    import altro_tpu as at
    from altro_tpu.solver import altro as _alt

    jstack = _jax_stack(lin)
    prob_b = jax.tree_util.tree_map(lambda a: jnp.repeat(a, B // 8, axis=0),
                                    jstack)
    opts = at.SolverOptions(**OPTS)
    u0 = jnp.asarray(U0[0].numpy())

    def partial_one(prob_k, x0_k):
        return _alt.solve_partial(prob_k.replace(x0=x0_k), opts, U0=u0,
                                  it_cap=cap)

    def resume_one(prob_k, state):
        return _alt._flat_while(prob_k, opts, state, None)

    def extract_one(prob_k, state):
        sol = _alt._finalize(prob_k, state)
        return sol.stats.status, sol.stats.iterations

    def solve_batch(prob_bb, x0_b):
        states = jax.vmap(partial_one)(prob_bb, x0_b)
        take = jnp.argsort(states[10].astype(jnp.int32), stable=True)[:block]
        subp = jax.tree_util.tree_map(lambda a: a[take], prob_bb)
        sub = jax.tree_util.tree_map(lambda a: a[take], states)
        sub = jax.vmap(resume_one)(subp, sub)
        states = jax.tree_util.tree_map(lambda a, b: a.at[take].set(b),
                                        states, sub)
        states = jax.vmap(resume_one)(prob_bb, states)
        return jax.vmap(extract_one)(prob_bb, states)

    st, it = jax.jit(solve_batch)(prob_b, jnp.asarray(x0.numpy()))
    return np.asarray(st).tolist(), np.asarray(it).tolist()


def test_compacted_flat_solve_is_the_plain_solve_and_jax_compacted():
    cap, block = 1, 4
    su = quadruped_setup(B, True, F64, "cpu")
    x0 = su.draw_x0()
    prob = dataclasses.replace(su.prob, x0=x0)
    plain = altro.solve(prob, su.opts, U0=su.U0)
    # more unconverged lanes at the cap than the block holds: the catch-all
    # resumes the rest
    assert int((plain.stats.iterations > cap).sum()) > block
    eager = altro.solve_compacted(prob, su.opts, U0=su.U0, it_cap=cap,
                                  block=block)
    fixed = graph.GraphedSolve(prob, su.opts, sched=((cap, block),))(
        x0, su.U0)
    for sol in (eager, fixed):
        for a, b in ((sol.X, plain.X), (sol.U, plain.U), (sol.K, plain.K),
                     (sol.stats.iterations, plain.stats.iterations),
                     (sol.stats.status, plain.stats.status),
                     (sol.stats.viol, plain.stats.viol)):
            assert torch.equal(a, b)
        for da, db in zip(sol.duals, plain.duals):
            assert torch.equal(da.lam, db.lam) and torch.equal(da.rho, db.rho)
    pytest.importorskip("jax")
    jst, jit_ = _jax_compacted(True, x0, su.U0, cap, block)
    assert plain.stats.status.tolist() == jst
    assert plain.stats.iterations.tolist() == jit_


def test_grouped_split_route_takes_the_lanes_into_d(monkeypatch):
    """With fused_expansion off (the JAX package's ALTRO_TPU_FUSED=0) a
    grouped problem takes the split route: kernel D's per-lane form on
    ``lanes()``, never kernel B; its answer is the fused route's to
    round-off (status equal, U within 1e-8)."""
    su = quadruped_setup(B, True, F64, "cpu", grouped=True)
    prob = dataclasses.replace(su.prob, x0=su.draw_x0())
    fused = altro.solve(prob, su.opts, U0=su.U0)
    seen = []
    backward_pass = altro.backward_pass

    def spy(A, *args):
        seen.append(tuple(A.shape))
        return backward_pass(A, *args)

    def refuse(*args, **kw):
        raise AssertionError("kernel B on the split route")

    monkeypatch.setattr(altro, "backward_pass", spy)
    monkeypatch.setattr(altro, "fused_expand_backward", refuse)
    split = altro.solve(prob, dataclasses.replace(su.opts,
                                                  fused_expansion=False),
                        U0=su.U0)
    assert seen and all(s[0] == B for s in seen)
    assert torch.equal(split.stats.status, fused.stats.status)
    np.testing.assert_allclose(split.U.numpy(), fused.U.numpy(), atol=1e-8,
                               rtol=0)


def test_take_lanes_gathers_per_lane_data_and_refuses_groups():
    su = quadruped_setup(B, True, F64, "cpu")
    take = torch.tensor([5, 0, 9])
    sub = altro.take_lanes(su.prob, take)
    assert torch.equal(sub.dynamics.A, su.prob.dynamics.A[take])
    assert torch.equal(sub.x0, su.prob.x0[take])
    assert sub.cost is su.prob.cost
    grp = quadruped_setup(B, True, F64, "cpu", grouped=True)
    with pytest.raises(ValueError, match="groups"):
        altro.take_lanes(grp.prob, take)


# ----------------------------------------------------------------------------
# on a CUDA device
# ----------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("Bt", [1024, 24], ids=["reps128", "reps3"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.float64, 1e-9)],
                         ids=["f32", "f64"])
def test_grouped_kernels_match_plain_and_per_group_launches(cuda, Bt, dtype,
                                                            tol):
    """B, C and A with a group axis on the card: bit for bit the shared
    kernel launched once per group on its lanes; against the plain version
    (float32 B against the float64 plain version, within 4x the float32
    plain version's own distance: the quadruped's Quu is
    ill-conditioned)."""
    from altro_tpu_torch.bench.kernels import (grouped_inputs,
                                               per_group_launches)

    gi = grouped_inputs(dtype, cuda, Bt)
    G = gi["prob"].dynamics.groups
    args, packed = gi["fused"], gi["packed"]
    fb = riccati_fused.fused_expand_backward
    out = fb(*args, packed=packed, grouped=True)
    torch.cuda.synchronize()
    for a, b in zip(out, per_group_launches(fb, args, G, packed=packed)):
        assert torch.equal(a, b)
    ref = gi["fused_ref"]
    if dtype == torch.float32:
        ref64 = riccati_fused.fused_expand_backward_reference(
            *convert.tree_to(args, dtype=torch.float64), grouped=True)
        for a, r, t in zip(out, ref, ref64):
            e_plain = float((r.double() - t).abs().max())
            bound = max(4 * e_plain, tol * max(1.0, float(t.abs().max())))
            assert float((a.double() - t).abs().max()) <= bound
    else:
        for a, r in zip(out, ref):
            assert float((a - r).abs().max()) <= tol * max(
                1.0, float(r.abs().max()))

    la = rollout_al.batched_ls_rollout_al
    cargs = gi["ladder_al"]
    got = la(*cargs, packed=packed, grouped=True)
    for a, b in zip(got, per_group_launches(la, cargs, G, packed=packed)):
        assert torch.equal(a, b)
    want = rollout_al.batched_ls_rollout_al_reference(*cargs, grouped=True)
    for a, r in zip(got[:2], want[:2]):
        assert float((a - r).abs().max()) <= tol * max(
            1.0, float(r.abs().max()))
    assert bool(((got[2] - want[2]).abs()
                 <= tol * want[2].abs().clamp(min=1.0)).all())

    ls = rollout.batched_ls_rollout
    for key in ("init", "ladder"):
        largs = gi[key]
        got = ls(*largs, grouped=True)
        for a, b in zip(got, per_group_launches(ls, largs, G)):
            assert torch.equal(a, b)
        for a, r in zip(got, rollout.batched_ls_rollout_reference(
                *largs, grouped=True)):
            assert float((a - r).abs().max()) <= tol * max(
                1.0, float(r.abs().max()))


@pytest.mark.cuda
def test_grouped_quadruped_takes_the_narrow_body_above_m8(cuda):
    """Kernel B's dispatch at the grouped quadruped's shape (n = m = 12,
    4 cones of 3 rows and 8 NONPOS rows: 324 expansion entries, 90 owned)
    takes the narrow body above m = 8, and at the rocket window's (m = 3)
    the m <= 8 body."""
    from altro_tpu_torch.bench.kernels import grouped_inputs, rocket_inputs

    for inputs, name in ((grouped_inputs(torch.float32, cuda, 24),
                          "narrow_m16"),
                         (rocket_inputs(torch.float32, cuda, 4),
                          "narrow_m8")):
        X, U = inputs["fused"][4:6]
        assert riccati_fused.body(X.shape[-1], U.shape[-1],
                                  inputs["packed"].P, "cuda") == name


@pytest.mark.cuda
def test_grouped_kernels_refuse_what_they_do_not_take(cuda):
    from altro_tpu_torch.bench.kernels import grouped_inputs

    gi = grouped_inputs(torch.float32, cuda, 24)
    (cost, A, Bm, blocks, X, U, lams, rhos, reg) = gi["fused"]
    with pytest.raises(ValueError):      # 24 lanes are not 7 equal groups
        riccati_fused.fused_expand_backward(cost, A[:7], Bm[:7], blocks, X,
                                            U, lams, rhos, reg, grouped=True)
    with pytest.raises(ValueError):      # stacks of 8 groups, not shared
        riccati_fused.fused_expand_backward(cost, A, Bm, blocks, X, U, lams,
                                            rhos, reg)
