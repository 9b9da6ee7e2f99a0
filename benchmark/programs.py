"""The program under test, as the benchmark drives it: the port's batched
MPC steps (``altro_tpu_torch.mpc``) behind one call,
``Cell.step(carry, noise, t)``.

A configuration module builds its problem with the port's own constructors
from data the benchmark made, and hands it to :func:`tracking_cell`, which
steps every lane in the same window by
``mpc.make_mpc_step_device_compacted`` with the configuration's compaction
schedule.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import torch


@dataclass
class Cell:
    """A cell's program: its step and initial carry, and what the check and
    the metrics need to read its answers."""

    B: int                    # lanes in the batch
    n: int
    m: int
    N: int                    # knots of a window
    T: int                    # steps per episode
    carry0: tuple
    step: Callable            # (carry, noise [B, n], t) -> (carry, out)
    window_k: Callable        # (t, lanes [S] int64) -> window index [S]
    x0_start: torch.Tensor    # [n] the configuration's initial state
    reference: object         # the plain reference (reference.tracking)
    ref_start: Callable       # L -> [L, N-1, m] the reference solver's start
    success_rate_min: float
    kernels: dict = field(default_factory=dict)   # kernel -> work arguments
    itemsize: int = 4


def tracking_cell(pm, opts, X_track, U_track, *, traffic: dict, spec: dict,
                  noise_model, reference, ref_start, kernels: dict,
                  warm_start: str, compaction: dict) -> Cell:
    """The cell of a tracking MPC problem ``pm`` (the port's Problem of one
    window, on the device) under ``traffic``, every lane in the same window,
    stepped by the compacted step with the schedule ``compaction``."""
    from altro_tpu_torch import mpc

    B, T = int(traffic["batch"]), int(traffic["episode_steps"])
    plain, init = mpc.make_mpc_step_device_compacted(
        pm, opts, X_track, U_track, it_cap=int(compaction["it_cap"]),
        block=int(compaction["block"]),
        levels=tuple(tuple(lv) for lv in compaction["levels"]),
        noise_model=noise_model, warm_start=warm_start)

    def window_k(t, lanes):
        return torch.full_like(lanes, t + 1)
    return Cell(B=B, n=pm.n, m=pm.m, N=pm.N, T=T, carry0=init(B),
                step=plain, window_k=window_k, x0_start=pm.x0.detach().cpu(),
                reference=reference, ref_start=ref_start,
                success_rate_min=float(spec["success_rate_min"]),
                kernels=kernels, itemsize=pm.x0.element_size())


def solver_options(spec: dict):
    from altro_tpu_torch.solver.options import SolverOptions
    return SolverOptions(**spec["solver"])


def ladder_rungs(opts) -> int:
    """Rungs of the solver's line-search ladder: iterations_linesearch step
    sizes and the alpha = 0 rung."""
    return int(opts.iterations_linesearch) + 1
