"""Quadruped solver switching through a YAML controller config, as the
reference's QuadrupedExample notebook swaps MPC backends by rewriting
MPC.yaml (the port's counterpart of ``examples/quadruped_yaml.py``).

    python -m altro_tpu_torch.examples.quadruped_yaml [--device cpu] [--tf S]

Writes the template with each solver and friction model into a temporary
file, loads it with ``config.mpc_config_from_yaml`` and runs the closed-loop
trot with the backend it names (on the card unless ``--device cpu``):
ALTRO, or the in-framework ADMM baselines in the OSQP and ECOS roles (the
knot-structured ADMM, set up once and refactored per solve); prints the
final height and whether every solve succeeded. Needs PyYAML to read the
config.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from ..models.quadruped import config, controller
from ..solver.options import SolverOptions

YAML_TEMPLATE = """
N: 15
dynamics_discretization: 0.03
update_dt: 0.03
mu: 0.5
max_vert_force: 133.0
min_vert_force: 0.0
stance_height: 0.28
linearized_friction_constraint: {linearized}
solver: "{solver}"
gait:
  type: "trot"
  stance_time: 0.2
  swing_time: 0.2
swing:
  omega: 100.0
  zeta: 1.0
  step_height: 0.05
"""

BACKENDS = {"ALTRO": "altro", "OSQP": "admm_qp", "ECOS": "admm_conic"}


def load(solver: str, linearized: bool) -> config.MPCConfig:
    """The template's config for ``solver`` and the friction model,
    through a YAML file."""
    fd, path = tempfile.mkstemp(suffix=".yaml")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(YAML_TEMPLATE.format(solver=solver,
                                         linearized=str(linearized).lower()))
        return config.mpc_config_from_yaml(path)
    finally:
        os.unlink(path)


def run(solver: str, linearized: bool, device="cuda", tf: float = 0.5):
    cfg = load(solver, linearized)
    opts = SolverOptions(penalty_initial=10.0, penalty_scaling=100.0,
                         reset_duals=False)
    res = controller.simulate(cfg, opts, tf=tf, backend=BACKENDS[cfg.solver],
                              device=device)
    ok = bool((res["status"] == 1).all())
    print(f"solver={cfg.solver:6s} linearized_friction={linearized}: "
          f"height {float(res['x'][-1, 2]):.3f} m, all solves ok: {ok}")
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tf", type=float, default=0.5)
    args = ap.parse_args()
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    for solver, lin in (("ALTRO", True), ("OSQP", True), ("ALTRO", False),
                        ("ECOS", False)):
        run(solver, lin, args.device, args.tf)


if __name__ == "__main__":
    main()
