"""The import guard: nothing the benchmark runs loads JAX, Flax or the JAX
package (top-level module names compared whole, so the port,
``altro_tpu_torch``, passes), and the plain reference loads nothing of the
port either."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

from benchmark import run

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
JAX_SIDE = {"jax", "jaxlib", "flax", "altro_tpu"}


def _python(code: str) -> list:
    """The top-level module names loaded by ``code`` in a fresh interpreter
    (its last line of output, a JSON list)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _sources(sub: str = ""):
    for dirpath, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imported(path: str) -> set:
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_whole_name_comparison():
    assert run.FORBIDDEN == ("jax", "jaxlib", "flax", "altro_tpu")
    assert run.forbidden_modules(["altro_tpu_torch", "altro_tpu_torch.mpc",
                                  "jaxtyping", "flaxen.x"]) == []
    assert run.forbidden_modules(["altro_tpu.ops", "jax._src",
                                  "torch"]) == ["altro_tpu", "jax"]


def test_no_source_imports_the_jax_side():
    for path in _sources():
        assert not _imported(path) & JAX_SIDE, path


def test_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        assert "altro_tpu_torch" not in _imported(path), path


def test_a_run_loads_no_jax_side_module():
    """A whole small run of every cell of BENCHMARK.json on the CPU, every
    metric reader loaded: no top-level module of the JAX side in
    sys.modules afterwards."""
    code = (
        "import json, sys\n"
        "from benchmark import metrics, run\n"
        "from benchmark.tests import _cells\n"
        "bench = json.load(open('BENCHMARK.json'))\n"
        "names = [w['name'] for w in bench['workloads']]\n"
        "for name in names:\n"
        "    out, _ = _cells.execute(name, seconds=0.5)\n"
        "for m in bench['per_layer']:\n"
        "    metrics.reader(m['name'])\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    loaded = set(_python(code))
    assert "altro_tpu_torch" in loaded
    assert not loaded & JAX_SIDE, loaded & JAX_SIDE


def test_the_reference_alone_loads_no_program():
    code = (
        "import json, sys, torch\n"
        "from benchmark.reference import (ipm, make_rocket_track,\n"
        "    rocket, tracking)\n"
        "spec = json.load(open('benchmark/configs/rocket_soc_N21.json'))\n"
        "X, U = rocket.load_track()\n"
        "ref = rocket.tracking_mpc(spec, {'X_track': X, 'U_track': U})\n"
        "k = torch.tensor([1, 2])\n"
        "ref.solve(X[1:3], k, rocket.hover(spec, 2, ref.N))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    loaded = set(_python(code))
    assert "altro_tpu_torch" not in loaded
    assert not loaded & JAX_SIDE


@pytest.mark.parametrize("name", sorted(JAX_SIDE))
def test_guard_finds_a_loaded_jax_side_module(name):
    assert run.forbidden_modules(["torch", name + ".sub"]) == [name]
