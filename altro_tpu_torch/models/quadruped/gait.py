"""Gait schedules: contact phase tables and the branchless phase lookup
(PyTorch counterpart of ``altro_tpu/models/quadruped/gait.py``).

Tables are float64, as in the JAX package; a phase at time t is found by a
search over the cumulative phase times of t mod the gait's length.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def _mod(x, y):
    """x mod y with the sign of y, computed as jnp.mod does (an exact
    fmod, then shifted by y where the signs differ)."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


@dataclass
class Gait:
    contact_phases: torch.Tensor  # [num_phases, 4] {0,1}
    phase_times: torch.Tensor     # [num_phases]
    alpha: float = 0.5
    beta: float = 0.5

    @property
    def num_phases(self) -> int:
        return self.contact_phases.shape[0]

    @property
    def phase_length(self):
        return torch.sum(self.phase_times)

    def phase_at(self, t):
        """Phase index at time t (a tensor of any shape)."""
        pt = _mod(torch.as_tensor(t, dtype=self.phase_times.dtype),
                  self.phase_length)
        ends = torch.cumsum(self.phase_times, 0)
        return torch.searchsorted(ends, pt.reshape(-1),
                                  right=True).reshape(pt.shape)

    def phase_time(self, t, phase):
        """Time elapsed within ``phase``."""
        pt = _mod(torch.as_tensor(t, dtype=self.phase_times.dtype),
                  self.phase_length)
        starts = torch.cat([torch.zeros(1, dtype=self.phase_times.dtype),
                            torch.cumsum(self.phase_times, 0)[:-1]])
        return pt - starts[phase]

    def next_phase(self, phase):
        return torch.remainder(phase + 1, self.num_phases)

    def contacts_at(self, t):
        return self.contact_phases[self.phase_at(t)]


def _mk(table, times) -> Gait:
    return Gait(contact_phases=torch.tensor(np.array(table).T,
                                            dtype=torch.float64),
                phase_times=torch.tensor(times, dtype=torch.float64))


def trot(stance_time=0.6, swing_time=0.2) -> Gait:
    # rows of the table are legs, columns are phases
    return _mk([[1, 1, 1, 0], [1, 0, 1, 1], [1, 0, 1, 1], [1, 1, 1, 0]],
               [stance_time, swing_time, stance_time, swing_time])


def stand() -> Gait:
    return _mk([[1, 1], [1, 1], [1, 1], [1, 1]], [1.0, 1.0])


def pronk(stance_time=0.2, flight_time=0.1) -> Gait:
    return _mk([[1, 0], [1, 0], [1, 0], [1, 0]], [stance_time, flight_time])


def pace(stance_time=0.6, swing_time=0.2) -> Gait:
    return _mk([[1, 1, 1, 0], [1, 0, 1, 1], [1, 1, 1, 0], [1, 0, 1, 1]],
               [stance_time, swing_time, stance_time, swing_time])


def bound(front_time=0.2, back_time=0.2, stance_time=0.1) -> Gait:
    return _mk([[1, 1, 1, 0], [1, 1, 1, 0], [1, 0, 1, 1], [1, 0, 1, 1]],
               [stance_time, front_time, stance_time, back_time])


def flying_trot(stance_time=0.2, flight_time=0.1) -> Gait:
    return _mk([[1, 0, 0, 0], [0, 0, 1, 0], [0, 0, 1, 0], [1, 0, 0, 0]],
               [stance_time, flight_time, stance_time, flight_time])


GAITS = {"trot": trot, "stand": stand, "pronk": pronk, "pace": pace,
         "bound": bound, "flying_trot": flying_trot}
