"""The port's grasp visualization (``altro_tpu_torch/models/grasp_viz.py``):
the port's cold grasp solve rendered to a PNG, as
``tests/test_edge_cases.py:49-61`` renders the JAX package's. Needs
matplotlib, which the module imports only when it draws."""
import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("matplotlib")

import altro_tpu_torch as tt  # noqa: E402
from altro_tpu_torch.models import grasp, grasp_viz  # noqa: E402


def test_grasp_visualization_renders(tmp_path):
    N, tf = 31, 3.0
    o = grasp.make_grasp_object(N, tf)
    prob = grasp.grasp_problem(o, N, tf)
    sol = tt.solve(dataclasses.replace(prob, x0=prob.x0[None]),
                   tt.SolverOptions(constraint_tolerance=1e-4,
                                    penalty_initial=10.0,
                                    penalty_scaling=10.0,
                                    iterations_outer=20),
                   U0=grasp.hover_controls(o, N)[None])
    assert int(sol.stats.status[0]) == 1
    path = str(tmp_path / "grasp.png")
    grasp_viz.plot_grasp_trajectory(o, sol.X[0], sol.U[0], path)
    assert os.path.getsize(path) > 1000
