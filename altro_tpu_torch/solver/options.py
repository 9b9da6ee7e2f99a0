"""Solver options (PyTorch counterpart of ``altro_tpu/solver/options.py``:
the same fields and defaults)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class SolverOptions:
    # tolerances
    cost_tolerance: float = 1e-4
    gradient_tolerance: float = 1e-5
    constraint_tolerance: float = 1e-4

    # augmented-Lagrangian schedule
    penalty_initial: float = 1.0
    penalty_scaling: float = 10.0
    penalty_max: float = 1e8

    # backward-pass regularization
    reg_initial: float = 0.0
    reg_min: float = 1e-8
    reg_max: float = 1e8
    reg_increase: float = 10.0
    reg_decrease: float = 0.5

    # line search: the ladder is ls_decrease**i for i < iterations_linesearch,
    # plus a trailing alpha = 0 rung
    ls_decrease: float = 0.5
    ls_min_ratio: float = 1e-4   # Armijo-style acceptance on expected decrease

    # Exact-model early stop (0.0 disables): an accepted FULL Newton step whose
    # achieved/predicted decrease ratio is within this tolerance of 1 ends the
    # inner phase at once.
    early_exact_tol: float = 0.0

    # iteration caps
    iterations_outer: int = 30
    iterations_inner: int = 50
    iterations_linesearch: int = 10

    # warm-start semantics: keep multipliers, reset penalties each solve
    reset_duals: bool = False
    reset_penalties: bool = True

    # Fused ladder-rollout + AL-merit line search: each rung's AL merit is
    # accumulated in the rollout pass (ops/rollout_al.py) and the adopted
    # trajectory's residuals are computed once afterwards. "auto" (default):
    # on a CUDA device for multi-block constraint sets, the classical ladder
    # otherwise (the CPU default keeps the classical path); "on": always;
    # "off": never.
    ls_fused: str = "auto"

    # The AL expansion fused into the Riccati pass (ops/riccati_fused.py) on
    # shared problem data. False takes the split route on every problem:
    # the expansion in PyTorch, then the Riccati pass from it
    # (ops/riccati.py). The counterpart of the JAX package's
    # ALTRO_TPU_FUSED=0; per-lane dynamics or a per-lane cost take the split
    # route whatever this says.
    fused_expansion: bool = True
