"""Trajectory-optimization problem container (PyTorch counterpart of
``altro_tpu/problem.py``).

``x0`` carries the batch: [B, n] for a batched solve. The dynamics stacks
are shared ([N-1, ...]) or carry the batch ([B, N-1, ...]: every scenario
linearized about its own schedule); cost and constraint stacks are shared by
every scenario.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from .constraints import ConicConstraint, DualState
from .costs import QuadCost
from .dynamics import LTVDynamics


@dataclass
class Problem:
    dynamics: LTVDynamics   # stacks [N-1, ...] or per scenario [B, N-1, ...]
    cost: QuadCost          # shared
    constraints: Tuple[ConicConstraint, ...]  # shared
    x0: torch.Tensor  # [B, n] (or [n] for an unbatched problem)

    @property
    def N(self) -> int:
        return self.cost.N

    @property
    def n(self) -> int:
        return self.cost.n

    @property
    def m(self) -> int:
        return self.cost.m

    def init_duals(self, penalty_initial) -> Tuple[DualState, ...]:
        """Fresh duals with the batch axes of ``x0``."""
        return tuple(DualState.init(c, penalty_initial, self.x0.dtype,
                                    batch=self.x0.shape[:-1])
                     for c in self.constraints)
