"""The quadruped agreement module (``bench/agreement_quadruped.py``) on the
CPU at a small size (B=16, SAMPLE=4), where phase 1's float32 solves take
the plain path: the result carries the keys that the JAX package's module
writes (read from its source), every truth solve succeeds, the two layouts
solve the same instances alike, and its gates pass. The mid-phase
instances differ from the bench's phase-boundary ones."""
import ast
import inspect

import pytest

torch = pytest.importorskip("torch")

from altro_tpu.bench import agreement_quadruped as j_agreement  # noqa: E402

from altro_tpu_torch.bench import agreement_quadruped  # noqa: E402
from altro_tpu_torch.bench.families import quadruped_setup  # noqa: E402

torch.set_num_threads(1)


def jax_keys() -> set:
    """Every keyword of a ``dict(...)`` call and every string subscript
    assigned to in the JAX module's phase 2 (its result layout)."""
    tree = ast.parse(inspect.getsource(j_agreement.phase2_cpu))
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


def test_agreement_quadruped_on_cpu():
    res = agreement_quadruped.run(16, "cpu", sample=4)
    agreement_quadruped.check(res)
    assert res["config"]["batch"] == 16 and res["config"]["sample"] == 4
    assert agreement_quadruped.B_DEFAULT == j_agreement.B_DEFAULT
    assert agreement_quadruped.SAMPLE == j_agreement.SAMPLE
    assert set(res["modes"]) == {"qp", "socp"}
    for row in res["modes"].values():
        assert row["truth_success"] == 1
        assert row["tpu_success_rate"] == row["flat_success_rate"] == 1.0
        assert row["status_differs"] == 0
        assert row["fullbatch_grouped"]["lanes"] == 16
    # the full-batch entries' names are f-strings there
    jk = jax_keys() | {"fullbatch_grouped", "fullbatch_flat"}
    assert not jk - port_keys(res)


def test_mid_phase_instances_differ_from_the_bench():
    a = quadruped_setup(8, True, torch.float64, "cpu").prob.dynamics
    b = quadruped_setup(8, True, torch.float64, "cpu",
                        phase=agreement_quadruped.MID_PHASE).prob.dynamics
    assert not torch.equal(a.A, b.A) or not torch.equal(a.B, b.B)
