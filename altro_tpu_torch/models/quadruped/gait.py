"""Gait schedules: contact phase tables and the branchless phase lookup
(PyTorch counterpart of ``altro_tpu/models/quadruped/gait.py``).

Tables are float64, as in the JAX package; a phase at time t is found by a
search over the cumulative phase times of t mod the gait's length. A gait's
tables live on one device (:meth:`Gait.to`), and every lookup stays there:
phases index the tables through ``index_select``, never through a host read,
so a lookup can be captured in a CUDA graph.
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


def take(table, idx):
    """``table[idx]`` for an integer tensor ``idx`` of any shape (0-d
    included), on the device: ``index_select`` reads no index to the
    host."""
    return table.index_select(0, idx.reshape(-1)).reshape(
        idx.shape + table.shape[1:])


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

    def to(self, device) -> "Gait":
        """The same gait with its tables on ``device``."""
        return Gait(contact_phases=self.contact_phases.to(device),
                    phase_times=self.phase_times.to(device),
                    alpha=self.alpha, beta=self.beta)

    def _time(self, t):
        """t mod the gait's length, on the tables' device."""
        return _mod(torch.as_tensor(t, dtype=self.phase_times.dtype,
                                    device=self.phase_times.device),
                    self.phase_length)

    def phase_at(self, t):
        """Phase index at time t (a tensor of any shape)."""
        pt = self._time(t)
        ends = torch.cumsum(self.phase_times, 0)
        return torch.searchsorted(ends, pt.reshape(-1),
                                  right=True).reshape(pt.shape)

    def phase_time(self, t, phase):
        """Time elapsed within ``phase``."""
        starts = torch.cat([torch.zeros_like(self.phase_times[:1]),
                            torch.cumsum(self.phase_times, 0)[:-1]])
        return self._time(t) - take(starts, phase)

    def next_phase(self, phase):
        return torch.remainder(phase + 1, self.num_phases)

    def contacts(self, phase):
        """Contact flags [..., 4] of ``phase``."""
        return take(self.contact_phases, phase)

    def contacts_at(self, t):
        return self.contacts(self.phase_at(t))


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
