"""The dynamics windows of a fleet's trot episode, for the receding-horizon
MPC step with moving dynamics (``mpc.make_mpc_step(dynamics_fn=...)``).

The fleet trots in place in G gait-phase groups: in window w (the window
the step before step w solves; window 0 is the initial carry's) group g
runs at gait time ``dt * w + offset * g``. Each window's dynamics are the
controller's own (``controller._linearized_problem``): linearized about the
stance x_des with the stance forces m g / (stance feet), on the horizon's
contact schedule and the nominal stance feet (with x_ref = x_des and no
commanded velocity the planner puts every foot at its nominal place).

Times are whole milliseconds. A knot's contact flags are read on that
integer grid (the phase of t mod the gait's length by the phases' ends in
ms), because the MPC's knots hit the trot's phase boundaries exactly
(multiples of 0.2 s on steps of 0.03 s), where a float time lands on
either side by its rounding. The stacks are built in float64 on the CPU,
the distinct gait times' schedules in one linearization, and cast by
:meth:`TrotWindows.to`, so every precision solves the same windows.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ...dynamics import LTVDynamics
from ...problem import Problem
from . import controller, planner
from .config import MPCConfig, woofer as _w
from .gait import GAITS, Gait


def whole_ms(seconds: float) -> int:
    """``seconds`` in whole milliseconds; raises if it is not one."""
    ms = round(float(seconds) * 1e3)
    if abs(ms - float(seconds) * 1e3) > 1e-6:
        raise ValueError(f"{seconds} s is not a whole number of ms")
    return ms


def phase_ends_ms(gait: Gait) -> list:
    """The gait's phase ends in ms, cumulative (the last is its length)."""
    ends, t = [], 0
    for s in gait.phase_times.tolist():
        t += whole_ms(s)
        ends.append(t)
    return ends


def contacts_ms(gait: Gait, t_ms: int, N: int, dt_ms: int) -> torch.Tensor:
    """Contact flags [N, 4] (float64) of the knots t_ms + i dt_ms, i < N:
    knot time mod the gait's length, in the first phase whose end is past
    it (a knot on a boundary is in the next phase, as ``Gait.phase_at``)."""
    ends = phase_ends_ms(gait)
    phases = [next(p for p, e in enumerate(ends)
                   if (t_ms + i * dt_ms) % ends[-1] < e) for i in range(N)]
    return gait.contact_phases.to(torch.float64)[torch.tensor(phases)]


@dataclass
class TrotWindows:
    """The grouped dynamics stacks of an episode's windows: A [W, G, N-1,
    n, n], B [W, G, N-1, n, m], d [W, G, N-1, n]; called with a window
    index k, the grouped ``LTVDynamics`` of window k (a view)."""

    A: torch.Tensor
    B: torch.Tensor
    d: torch.Tensor

    def __call__(self, k: int) -> LTVDynamics:
        return LTVDynamics(A=self.A[k], B=self.B[k], d=self.d[k],
                           grouped=True)

    def to(self, device=None, dtype=None) -> "TrotWindows":
        return TrotWindows(*(t.to(device=device, dtype=dtype)
                             for t in (self.A, self.B, self.d)))


def stance_feet(x_des) -> torch.Tensor:
    """World foot positions [4, 3] of the nominal stance under x_des."""
    feet = x_des[0:3][None, :] + planner.nominal_foot_locations()
    feet[:, 2] = _w.geometry.foot_radius
    return feet


def trot_windows(cfg: MPCConfig, prob: Problem, windows: int, groups: int,
                 offset_ms: int) -> TrotWindows:
    """The float64 stacks of windows 0 .. ``windows`` - 1 of ``groups``
    groups, group g offset by ``offset_ms`` g ms in the gait, for the
    configuration ``cfg`` (trotting in place) and its float64 problem
    ``prob`` (``controller.build_mpc_problem(cfg)``: x0 = x_des)."""
    if tuple(cfg.xy_vel) != (0.0, 0.0) or cfg.omega_z != 0.0:
        raise ValueError("the episode trots in place: xy_vel and omega_z "
                         "must be 0 (the feet then stay at the nominal "
                         "stance)")
    x_des = prob.x0
    gait = GAITS[cfg.gait_type](cfg.stance_time, cfg.swing_time)
    N, dt = cfg.N, cfg.dynamics_discretization
    dt_ms = whole_ms(dt)
    cycle = phase_ends_ms(gait)[-1]
    times = torch.tensor([[(dt_ms * w + offset_ms * g) % cycle
                           for g in range(groups)] for w in range(windows)])
    keys, where = torch.unique(times, return_inverse=True)
    # every distinct schedule's knots end to end, linearized in one call
    S = keys.shape[0]
    contacts = torch.cat([contacts_ms(gait, int(t), N, dt_ms) for t in keys])
    dyn = controller._linearized_problem(
        prob, x_des, x_des.expand(S * N, 12), contacts,
        stance_feet(x_des).expand(S * N, 4, 3), dt).dynamics
    # schedule s's window is its knots s N .. s N + N - 2
    knots = torch.arange(S)[:, None] * N + torch.arange(N - 1)
    return TrotWindows(*(t[knots][where] for t in (dyn.A, dyn.B, dyn.d)))
