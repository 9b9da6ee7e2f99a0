"""The end-to-end gate modules on the CPU at a small size (B=8, T=2), where
every route is the plain one: ``bench/fused_check.py`` (both routes equal
bit for bit here, so every gap is zero and the gates pass),
``bench/agreement.py`` (the flagship's ``shared_k=False`` step in float32
against float64 truths and the native C++ QP oracle) and
``bench/agreement_conic.py`` (its report, and its gate
``conic_agreement`` on both families). Each result carries the keys that
the JAX package's module writes (read from its source)."""
import ast
import dataclasses
import inspect

import pytest

torch = pytest.importorskip("torch")

from altro_tpu.bench import agreement as j_agreement  # noqa: E402
from altro_tpu.bench import agreement_conic as j_agreement_conic  # noqa: E402
from altro_tpu.bench import fused_check as j_fused_check  # noqa: E402

from altro_tpu_torch.bench import agreement, agreement_conic  # noqa: E402
from altro_tpu_torch.bench import fused_check  # noqa: E402
from altro_tpu_torch.bench.conic import SETUPS  # noqa: E402

torch.set_num_threads(1)
B, T = 8, 2


def jax_keys(module) -> set:
    """The result keys the JAX module's phase 2 writes: every keyword of a
    ``dict(...)`` call and every string subscript assigned to."""
    tree = ast.parse(inspect.getsource(module.phase2_cpu))
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


def port_keys(res) -> set:
    if isinstance(res, dict):
        return set(res) | {k for v in res.values() for k in port_keys(v)}
    return set()


@pytest.fixture(scope="module")
def setups():
    """The float32 conic setups on the CPU (their cold solves included)."""
    return {f: SETUPS[f](torch.float32, device="cpu")
            for f in fused_check.FAMILIES}


def test_fused_check_on_cpu(setups):
    res = fused_check.run(B, T, "cpu", setups=setups)
    assert res["gate_pass"]
    for family in fused_check.FAMILIES:
        row = res[family]
        assert row["gate_pass"] and row["lanes"] == B
        # the same plain arithmetic on both routes
        assert row["gap_abs_max"] == 0.0 and row["gap_signed_mean"] == 0.0
        assert row["success_fused"] == row["success_unfused"] == 1.0
        assert row["max_viol_fused"] == row["max_viol_unfused"] <= 1e-4
    assert not jax_keys(j_fused_check) - port_keys(res)


def test_agreement_on_cpu():
    res = agreement.run(B, T, "cpu", sample=4)
    agreement.check(res)
    assert res["config"]["step"] == T
    assert res["native_success"] == 1
    assert res["max_dU_cpu_f64_vs_native_cpp"] < 1e-5
    for row in res["per_tpu_tolerance"].values():
        assert row["tpu_success_rate"] == 1.0
        # float32 against the float64 truth: the flagship's gate
        assert row["max_dU_tpu_f32_vs_cpu_f64"] <= 1e-3
    for fb in res["fullbatch"].values():
        assert fb["lanes"] == B and fb["gap_max"] < 1e-2
    assert not jax_keys(j_agreement) - port_keys(res)
    res["per_tpu_tolerance"]["1e-06"]["success_all_steps"] = 0.875
    with pytest.raises(AssertionError, match="success below 1.0"):
        agreement.check(res)


def test_agreement_conic_report_on_cpu(setups):
    res = agreement_conic.run(B, T, "cpu", check_steps=(T,),
                              full_steps=(T,), sample=4, setups=setups)
    for family in agreement_conic.FAMILIES:
        rows = res["families"][family]
        assert set(rows) == {"bench", "tight"}
        for row in rows.values():
            assert row["truth_success"] == 1
            assert row["tpu_success_rate"] == 1.0
            assert row["fullbatch"]["cold_tight_success"] == 1.0
            assert row["fullbatch"]["lanes"] == B
        assert rows["tight"]["native_success"] == 1
    assert not jax_keys(j_agreement_conic) - port_keys(res)


@pytest.mark.parametrize("family", agreement_conic.FAMILIES)
def test_conic_agreement_gate_on_cpu(setups, family):
    res = agreement_conic.conic_agreement(setups[family], B, T, "cpu")
    assert res["status_diff"] <= 1
    assert abs(res["gap_mean"]) <= agreement_conic.GATES[family][0]


def test_fused_check_gate_catches_a_biased_route(setups, monkeypatch):
    """A defect that moves the fused route's controls on every lane (scaled
    by 1.05) fails the gate on grasp."""
    real = fused_check.make_step

    def biased(su, *a, opts=None, **kw):
        step, init = real(su, *a, opts=opts, **kw)
        if opts is None or not opts.fused_expansion:
            return step, init

        def step_b(carry, noise, t):
            nxt, out = step(carry, noise, t)
            return nxt, dataclasses.replace(out, U=1.05 * out.U)
        return step_b, init

    monkeypatch.setattr(fused_check, "make_step", biased)
    row = fused_check.family_run("grasp", B, T, "cpu", setups["grasp"])
    assert not row["gate_pass"]
    assert abs(row["gap_signed_mean"]) > fused_check.GATE_BIAS
