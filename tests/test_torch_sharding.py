"""Scenario sharding over ``torch.distributed`` (``altro_tpu_torch.parallel``)
on gloo ranks on the CPU, float64, one thread per rank:

- at 2 and 4 ranks, ``sharded_solve`` and ``sharded_mpc_step`` on the small
  flagship (n=6, m=3, N=11, B=16, 2 steps; ``tests/test_sharding.py``'s
  setup) and ``sharded_solve`` on the rocket's SOC window equal the port's
  unsharded batch bit for bit (U, X, status, iterations), with the reduced
  metrics equal to the unsharded totals; the device-compacted SOC step per
  rank (cap 1, block 2: compaction gathers within each rank's slice)
  equals the port's plain step on the whole batch bit for bit;
- the same against the JAX package's ``sharded_solve`` /
  ``sharded_mpc_step`` on the forced CPU mesh of as many devices: U within
  1e-8 (the JAX test's own tolerance), equal total iterations and
  successes;
- ``dryrun_multichip(2)`` passes; ``scaling.measure`` at 1 and 2 ranks
  gives the JAX module's row keys with every scenario solved;
- the parallel modules and the scaling bench import neither JAX nor the
  JAX package.

The ranks are spawned processes that import the port only (the functions
they run live in ``altro_tpu_torch.parallel``).
"""
import ast
import dataclasses
import functools
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import altro_tpu as at  # noqa: E402
from altro_tpu.models import random_linear as jrl  # noqa: E402
from altro_tpu.models import rocket as jrocket  # noqa: E402
from altro_tpu.mpc import gen_tracking_mpc as j_gen  # noqa: E402
from altro_tpu.parallel import make_scenario_mesh as j_mesh  # noqa: E402
from altro_tpu.parallel import sharded_mpc_step as j_sharded_step  # noqa
from altro_tpu.parallel import sharded_solve as j_sharded_solve  # noqa

import altro_tpu_torch as tt  # noqa: E402
from altro_tpu_torch import convert  # noqa: E402
from altro_tpu_torch.bench import scaling  # noqa: E402
from altro_tpu_torch.mpc import make_mpc_step  # noqa: E402
from altro_tpu_torch.parallel import (launch, run_compacted_steps,  # noqa
                                      run_sharded_mpc, sharded_solve)
from altro_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-8
B, T = 16, 2
KW = dict(penalty_initial=1e3, penalty_scaling=100.0, reset_duals=False)
ROCKET_COLD = dict(cost_tolerance=1e-5, gradient_tolerance=1e-6,
                   constraint_tolerance=1e-4, penalty_initial=1e-2,
                   penalty_scaling=500.0, iterations_outer=40,
                   iterations_inner=100)
ROCKET_KW = dict(cost_tolerance=1e-5, gradient_tolerance=1e-6,
                 constraint_tolerance=1e-4, penalty_initial=1e2,
                 penalty_scaling=10.0, reset_duals=False,
                 iterations_outer=15, iterations_inner=8, reg_min=1.0,
                 early_exact_tol=1e-3)
WORLDS = (2, 4)


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=atol,
                               rtol=0)


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def setup():
    """The small flagship of ``tests/test_sharding.py`` and the rocket SOC
    window of its conic cases, both packages' problems on one reference
    (the JAX package's cold rocket solve), with the batches and noise."""
    rng = np.random.default_rng(0)
    n, m, N_track, N_mpc = 6, 3, 61, 11
    jprob = jrl.gen_random_linear(rng, n, m, N_track)
    X_track, U_track = jrl.gen_trajectory(rng, jprob, N_track)
    jpm = jrl.gen_tracking_mpc(jprob, X_track, U_track, N_mpc)
    Nr = 41
    jr = jrocket.rocket_problem(N=Nr, tf=(Nr - 1) * 0.05)
    jr = jr.replace(x0=jr.x0 / 6.0)
    cold = jax.jit(at.solve)(jr, at.SolverOptions(**ROCKET_COLD))
    assert int(cold.stats.status) == 1
    jpr = j_gen(jr, cold.X, cold.U, 13, dt=0.05)
    return dict(
        jpm=jpm, X_j=X_track, U_j=U_track, jpr=jpr, Xr_j=cold.X,
        Ur_j=cold.U,
        pm=convert.problem_from_numpy(convert.numpy_tree(jpm)),
        X=_t(X_track), U=_t(U_track),
        pr=convert.problem_from_numpy(convert.numpy_tree(jpr)),
        Xr=_t(cold.X), Ur=_t(cold.U),
        x0s=np.random.default_rng(1).standard_normal((B, n)),
        noise=np.random.default_rng(2).standard_normal((T, B, n)),
        x0r=(np.asarray(jpr.x0)[None]
             + 0.02 * np.random.default_rng(4).standard_normal((B, 6))),
        noise_r=np.random.default_rng(5).standard_normal((T, B, 6)))


@pytest.fixture(scope="module")
def unsharded(setup):
    """The port on the whole batch in this process: the flagship's batch
    solve and steps, the rocket window's batch solve and plain steps."""
    s = setup
    opts, opts_r = tt.SolverOptions(**KW), tt.SolverOptions(**ROCKET_KW)
    x0s = _t(s["x0s"])
    sol = tt.solve(dataclasses.replace(s["pm"], x0=x0s), opts)
    step, _ = make_mpc_step(s["pm"], opts, s["X"], s["U"])
    carry, steps = (x0s, sol.X, sol.U, sol.duals), []
    for t in range(T):
        carry, out = step(carry, _t(s["noise"][t]), t)
        steps.append(out)
    rsol = tt.solve(dataclasses.replace(s["pr"], x0=_t(s["x0r"])), opts_r)
    rstep, rinit = make_mpc_step(s["pr"], opts_r, s["Xr"], s["Ur"])
    rc, rsteps = rinit(B), []
    for t in range(T):
        rc, out = rstep(rc, _t(s["noise_r"][t]), t)
        rsteps.append(out)
    return dict(sol=sol, steps=steps, rsol=rsol, rsteps=rsteps)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"ranks{w}")
def sharded(request, setup):
    """One launch of W gloo ranks running the four sharded programs."""
    s = setup
    opts, opts_r = tt.SolverOptions(**KW), tt.SolverOptions(**ROCKET_KW)
    x0s = _t(s["x0s"])
    calls = [
        (sharded_solve, s["pm"], opts, x0s),
        (run_sharded_mpc, s["pm"], opts, s["X"], s["U"], x0s,
         _t(s["noise"])),
        (sharded_solve, s["pr"], opts_r, _t(s["x0r"])),
        (functools.partial(run_compacted_steps, it_cap=1, block=2), s["pr"],
         opts_r, s["Xr"], s["Ur"], _t(s["noise_r"]))]
    return request.param, launch(calls, request.param, "cpu")


@pytest.fixture(scope="module")
def jax_sharded(setup):
    """The JAX package's sharded functions on the forced CPU mesh, per
    world size: the flagship's solve and steps, the rocket window's
    solve."""
    s = setup
    opts, opts_r = at.SolverOptions(**KW), at.SolverOptions(**ROCKET_KW)
    out = {}
    for w in WORLDS:
        mesh = j_mesh(w)
        x0s = jnp.asarray(s["x0s"])
        solve = jax.jit(lambda x: j_sharded_solve(s["jpm"], opts, x, mesh))(
            x0s)
        step = jax.jit(j_sharded_step(s["jpm"], opts, s["X_j"], s["U_j"],
                                      mesh))
        sol0 = jax.vmap(lambda x0: at.solve(s["jpm"].replace(x0=x0),
                                            opts))(x0s)
        state, metrics = (x0s, sol0.X, sol0.U, sol0.duals, jnp.asarray(0)), []
        for t in range(T):
            state, mt = step(state, jnp.asarray(s["noise"][t]))
            metrics.append(mt)
        rsolve = jax.jit(lambda x: j_sharded_solve(s["jpr"], opts_r, x,
                                                   mesh))(
            jnp.asarray(s["x0r"]))
        out[w] = dict(solve=solve, state=state, metrics=metrics,
                      rsolve=rsolve)
    return out


def _cat(parts, field):
    return torch.cat([getattr(p, field) for p in parts])


def test_sharded_solve_bit_equal_to_unsharded(sharded, unsharded):
    w, res = sharded
    ref = unsharded["sol"]
    assert torch.equal(torch.cat([r[0][0] for r in res]), ref.U)
    for r in res:
        assert int(r[0][1]) == int(ref.stats.iterations.sum())
        assert float(r[0][2]) == float(ref.stats.viol.max())


def test_sharded_mpc_step_bit_equal_to_unsharded(sharded, unsharded):
    """Every rank's lanes, every step: X, U, status and iterations equal
    the unsharded step's bit for bit; the reduced metrics (on every rank)
    equal the unsharded totals; the final carried duals too."""
    w, res = sharded
    for t, ref in enumerate(unsharded["steps"]):
        parts = [r[1]["results"][t] for r in res]
        for f in ("X", "U", "iters", "status", "viol", "x0"):
            assert torch.equal(_cat(parts, f), getattr(ref, f)), (w, t, f)
        for r in res:
            total, mviol, n_ok = r[1]["metrics"][t]
            assert int(total) == int(ref.iters.sum())
            assert float(mviol) == float(ref.viol.max())
            assert int(n_ok) == int(ref.status.sum()) == B
    assert all(r[1]["state"][4] == T for r in res)


def test_sharded_rocket_solve_bit_equal_to_unsharded(sharded, unsharded):
    w, res = sharded
    ref = unsharded["rsol"]
    assert int(ref.stats.status.sum()) == B
    assert torch.equal(torch.cat([r[2][0] for r in res]), ref.U)
    assert int(res[0][2][1]) == int(ref.stats.iterations.sum())
    assert float(res[0][2][2]) == float(ref.stats.viol.max())


def test_compacted_soc_step_per_rank_bit_equal_to_plain(sharded, unsharded):
    """The device-compacted SOC step on each rank's slice (cap 1, block 2:
    a gathered block smaller than the unconverged lanes, so the catch-all
    runs too) equals the plain step on the whole batch."""
    w, res = sharded
    for t, ref in enumerate(unsharded["rsteps"]):
        parts = [r[3][t] for r in res]
        for f in ("X", "U", "iters", "status", "viol"):
            assert torch.equal(_cat(parts, f), getattr(ref, f)), (w, t, f)
    assert int(unsharded["rsteps"][-1].status.sum()) == B


def test_sharded_matches_jax_package(sharded, jax_sharded, unsharded):
    """Against the JAX package's sharded functions on a mesh of as many
    devices: U within 1e-8, equal total iterations and successes."""
    w, res = sharded
    j = jax_sharded[w]
    U = torch.cat([r[0][0] for r in res])
    close(U, j["solve"][0])
    assert int(res[0][0][1]) == int(j["solve"][1])
    close(torch.cat([r[2][0] for r in res]), j["rsolve"][0])
    assert int(res[0][2][1]) == int(j["rsolve"][1])
    for t in range(T):
        total, _, n_ok = res[0][1]["metrics"][t]
        assert int(total) == int(j["metrics"][t][0])
        assert int(n_ok) == int(j["metrics"][t][2]) == B
    final = res[0][1]["state"], res[-1][1]["state"]
    Xs = torch.cat([r[1]["state"][1] for r in res])
    Us = torch.cat([r[1]["state"][2] for r in res])
    close(Xs, j["state"][1])
    close(Us, j["state"][2])
    assert final[0][4] == int(j["state"][4])


def test_dryrun_multichip_two_ranks():
    out = dryrun_multichip(2, "cpu")
    assert len(out) == 2
    for r in out:
        assert r["flagship"]["n_success"] == r["flagship"]["B"] == 4
        assert r["flagship"]["max_viol"] <= 2e-4
        assert r["rocket_max_viol"] <= 2e-4
        assert r["compacted"]["n_success"] == 4
        assert r["passes"] > 0


def _jax_row_keys():
    """The keys of the JAX module's rows, read from its source."""
    import altro_tpu.bench.scaling as jscaling
    tree = ast.parse(pathlib.Path(jscaling.__file__).read_text())
    keys = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "id", "")
                == "dict"):
            keys |= {k.arg for k in node.keywords}
        if (isinstance(node, ast.Subscript)
                and isinstance(node.slice, ast.Constant)
                and isinstance(node.ctx, ast.Store)):
            keys.add(node.slice.value)
    return keys


def test_scaling_rows():
    rows = scaling.measure(batch_per_device=4, steps=2, device="cpu")
    assert [r["devices"] for r in rows] == [1, 2]
    assert set(rows[0]) == _jax_row_keys() == {
        "devices", "batch", "solves_per_s", "n_success", "efficiency"}
    for r in rows:
        assert r["n_success"] == r["batch"] == 4 * r["devices"]
        assert r["solves_per_s"] > 0
    assert rows[0]["efficiency"] == 1.0


def test_scaling_rows_past_the_cards_not_measured(monkeypatch):
    """On a host of one card, the rows for 2, 4 and 8 cards are "not
    measured" and nothing is launched for them (no rank shares a card);
    the one-card row is measured (its launch stubbed here)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    launched = []

    def fake_launch(calls, world_size, device):
        launched.append((world_size, device))
        return [[{"wall_s": 0.5, "n_success": 2}]]

    monkeypatch.setattr(scaling, "launch", fake_launch)
    rows = scaling.measure(batch_per_device=2, steps=1)
    assert launched == [(1, "cuda")]
    assert [r["devices"] for r in rows] == [1, 2, 4, 8]
    assert rows[0]["solves_per_s"] == 4.0 and rows[0]["efficiency"] == 1.0
    for r in rows[1:]:
        assert set(r) == set(rows[0])
        assert (r["solves_per_s"] == r["n_success"] == r["efficiency"]
                == "not measured")


def test_parallel_modules_import_no_jax():
    root = pathlib.Path(tt.__file__).parent
    files = sorted((root / "parallel").glob("*.py")) + [
        root / "bench" / "scaling.py"]
    assert len(files) >= 4
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "altro_tpu"), (f, name)
