"""The C++-oracle slice against the JAX package in float64 on the CPU: the
four-solver studies (``rocket_multibaseline_tol``,
``grasp_multibaseline_tol``) at T=2 and one tolerance, and the quadruped's
C++ race (``simulate_host(native=True)``) for 3 periods.

The studies' baselines solve one instance sequence in both packages: the
JAX run's instances (captured where its driver transcribes them, and
converted) go into the port's run (``instances=``). The native C++ solver
then scores bit for bit alike, and the two ADMM forms within 1e-8. ALTRO's
error is not compared: each package's ALTRO runs free from its own cold
solve, and the free-running rocket sweeps part at step 0 on a round-off
decision (``tests/test_torch_lockstep.py:
test_rocket_sweep_step0_case_flip_is_round_off``); from the JAX package's
carry the port takes its iterations on every step
(``test_rocket_sweep_from_jax_carry_matches_jax``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import altro_tpu as at  # noqa: E402

import altro_tpu_torch as tt  # noqa: E402
from altro_tpu_torch.bench import drivers as tdrv  # noqa: E402
from altro_tpu_torch.convert import (numpy_tree,  # noqa: E402
                                     problem_from_numpy)

torch.set_num_threads(1)
QUAD = dict(cost_tolerance=1e-4, constraint_tolerance=1e-4,
            penalty_initial=10.0, penalty_scaling=100.0, reset_duals=False)


def _jax_run_with_instances(family, tol, T, monkeypatch):
    """The JAX package's study, and the instance of each step: its driver
    transcribes every instance twice outside jit (the truth solve and the
    native solve at the tolerance), after the setup's transcription of
    the MPC window itself."""
    import altro_tpu.bench.drivers as jdrv
    import altro_tpu.transcribe as jtr
    seen = []
    transcribe = jtr.to_batch_conic

    def recording(prob, *a, **kw):
        if not isinstance(prob.x0, jax.core.Tracer):
            seen.append(prob)
        return transcribe(prob, *a, **kw)
    monkeypatch.setattr(jtr, "to_batch_conic", recording)
    jres = getattr(jdrv, f"{family}_multibaseline_tol")(tols=(tol,), T=T)
    assert len(seen) == 1 + 2 * T
    return jres, [problem_from_numpy(numpy_tree(p)) for p in seen[1::2]]


@pytest.mark.parametrize("family,tol", [("rocket", 1e-4), ("grasp", 1e-4)])
def test_multibaseline_matches_jax(family, tol, monkeypatch):
    T = 2
    jres, instances = _jax_run_with_instances(family, tol, T, monkeypatch)
    res = getattr(tdrv, f"{family}_multibaseline_tol")(
        tols=(tol,), T=T, device="cpu", instances=instances)
    assert set(res) == set(jres)
    (jrow,), (row,) = jres["rows"], res["rows"]
    assert set(row) == set(jrow)
    assert res["cold_iterations"] == jres["cold_iterations"]
    for k in tdrv.MULTI_SOLVERS:
        assert row[f"success_{k}"] == jrow[f"success_{k}"] == 1.0, k
    assert row["err_native_cpp"] == jrow["err_native_cpp"]
    for k in ("dense_admm", "knot_admm"):
        assert abs(row[f"err_{k}"] - jrow[f"err_{k}"]) <= 1e-8, k


@pytest.mark.parametrize("backend,lin", [("altro", True),
                                         ("admm_qp", True),
                                         ("altro", False),
                                         ("admm_conic", False)])
def test_simulate_host_native_matches_jax(backend, lin):
    """The C++ race of the JAX package (its ``simulate_host`` default) for
    3 periods: the native AL-iLQR or the native knot ADMM in both packages,
    on the same closed loop. Equal status and iterations every period; the
    forces within 1e-6 N and the states within 1e-8 (the OSQP role's
    active-set polish moves the forces by 2e-7 N at round-off)."""
    from altro_tpu.models.quadruped import config as jc
    from altro_tpu.models.quadruped import controller as jctl
    from altro_tpu_torch.models.quadruped import config as tc
    from altro_tpu_torch.models.quadruped import controller as tctl
    tf = 0.09
    jres = jctl.simulate_host(jc.MPCConfig(linearized_friction=lin),
                              at.SolverOptions(**QUAD), tf=tf,
                              backend=backend)
    res = tctl.simulate_host(tc.MPCConfig(linearized_friction=lin),
                             tt.SolverOptions(**QUAD), tf=tf,
                             backend=backend, device="cpu")
    np.testing.assert_array_equal(res["status"].numpy(),
                                  np.asarray(jres["status"]))
    np.testing.assert_array_equal(res["iters"].numpy(),
                                  np.asarray(jres["iters"]))
    assert int(res["status"].min()) == 1
    np.testing.assert_allclose(res["forces"].numpy(),
                               np.asarray(jres["forces"]), atol=1e-6)
    np.testing.assert_allclose(res["x"].numpy(), np.asarray(jres["x"]),
                               atol=1e-8)
    assert res["loop_replays"] == 0 and res["admm_chunks"] == 0
    assert len(res["mpc_ms"]) == len(res["prep_ms"]) == 3


def test_quadruped_benchmark_reports_both_races():
    """The card race at the top level (the JAX package's row keys), the
    C++ race under ``cpp_race``, each with its labelled table."""
    res = tdrv.quadruped_benchmark(tf=0.06, device="cpu")
    rows = ("ALTRO-QP", "OSQP-role", "ALTRO-SOCP", "ECOS-role")
    assert set(res) == set(rows) | {"table_md", "cpp_race", "cpp_table_md"}
    assert set(res["cpp_race"]) == set(rows)
    assert res["table_md"].startswith("card race")
    assert res["cpp_table_md"].startswith("C++ race")
    for race in (res, res["cpp_race"]):
        for name in rows:
            assert race[name]["success"] == 1.0
            assert race[name]["periods"] == 2
    # the C++ race launches no kernel and replays no graph
    for name in rows:
        assert res["cpp_race"][name]["loop_replays"] == 0
        assert res["cpp_race"][name]["launches"]["passes"] == 0
