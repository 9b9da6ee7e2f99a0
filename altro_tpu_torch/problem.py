"""Trajectory-optimization problem container (PyTorch counterpart of
``altro_tpu/problem.py``).

``x0`` carries the batch: [B, n] for a batched solve. The dynamics are
LTV stacks, shared ([N-1, ...]), carrying the batch ([B, N-1, ...]: every
scenario linearized about its own schedule) or a group axis ([G, N-1, ...],
flagged ``grouped``: each group of B / G scenarios shares a schedule), or
a nonlinear model with
shared or per-lane params, linearized per lane at every iterate; the cost's
linear terms are shared or carry the batch (every scenario tracking its own
window); the cost's Hessians and the constraint stacks are shared by every
scenario (a nonlinear block's Jacobians, taken at each lane's iterate, are
per lane).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple, Union

import torch

from .constraints import ConicConstraint, DualState, QuadNormConstraint
from .costs import QuadCost
from .dynamics import LTVDynamics, NonlinearDynamics

Dynamics = Union[LTVDynamics, NonlinearDynamics]
Block = Union[ConicConstraint, QuadNormConstraint]


@dataclass
class Problem:
    dynamics: Dynamics      # LTV stacks, shared, [B or G, N-1, ...]; or f
    cost: QuadCost          # Hessians shared; q, r, c shared or [B, N, ...]
    constraints: Tuple[Block, ...]  # shared
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
