"""Footstep planner: the Raibert-style body-velocity heuristic and the
horizon's contact schedule and foot locations for the MPC (PyTorch
counterpart of ``altro_tpu/models/quadruped/planner.py``; its scan over the
horizon is a Python loop, its vmap over legs a leg axis).

Everything stays on the device of its inputs: the gait's tables (``Gait.to``),
the nominal feet (:func:`nominal_foot_locations` with a device) and the
phase lookups, which read no index to the host, so the schedule can be
captured in a CUDA graph.
"""
from __future__ import annotations

import functools

import torch

from . import kinematics
from .config import woofer as _w
from .gait import Gait, take
from .srb import mrp_rotation

FOOT_RADIUS = _w.geometry.foot_radius

NOM_FOOT_LOC = kinematics.forward_kinematics_all(
    torch.zeros(12, dtype=torch.float64)).reshape(4, 3)


@functools.lru_cache(maxsize=None)
def _nominal(device, dtype):
    return NOM_FOOT_LOC.to(device, dtype)


def nominal_foot_locations(device=None, dtype=None):
    """Body-frame foot locations [4, 3] at zero joint angles (float64 on
    the CPU unless ``device``/``dtype`` say otherwise)."""
    if device is None and dtype is None:
        return NOM_FOOT_LOC
    return _nominal(torch.device(device or "cpu"), dtype or torch.float64)


def footstep_locations(x_est, rot, cur_phase, gait: Gait):
    """Next world-frame placements [4, 3] of the four legs (the JAX
    package's ``footstep_location`` over its legs): nominal foot under the
    body plus alpha * t_next * v (the reference's yaw term is dead code and
    is left out as there)."""
    v_n = x_est[6:9]
    p = x_est[0:3]
    t_next = take(gait.phase_times, gait.next_phase(cur_phase)).to(
        x_est.dtype)
    nom = nominal_foot_locations(x_est.device, x_est.dtype)
    nom_n = p + nom @ rot.mT
    next_loc = nom_n + gait.alpha * t_next * v_n
    return torch.cat([next_loc[:, :2],
                      torch.full_like(next_loc[:, 2:], FOOT_RADIUS)], -1)


def foot_history(t, x_ref, feet_w, planner_foot_loc, gait: Gait,
                 x_des, N: int, dt_mpc):
    """Horizon contact schedule and world foot locations for the MPC.

    t: time (0-d tensor), x_ref [N, 12] reference states, feet_w [4, 3]
    current world-frame feet (passed through as the first knot's
    locations). Returns (contacts [N, 4], foot_locs [N, 4, 3],
    planner_foot_loc [4, 3])."""
    del x_des
    prev_locs = feet_w
    planner_loc = planner_foot_loc
    prev_phase = gait.phase_at(t)
    contacts0 = gait.contacts(prev_phase)
    contacts, locs = [contacts0], [prev_locs]
    for i in range(1, N):
        t_i = t + float(i) * dt_mpc
        next_phase = gait.phase_at(t_i)
        contacts_i = gait.contacts(next_phase)
        x_i = x_ref[min(i, N - 1)]
        rot = mrp_rotation(x_i[3:6])

        prev_c = gait.contacts(prev_phase)
        planned = footstep_locations(x_i, rot, next_phase, gait)
        # plan before release: stance -> swing
        to_plan = (prev_c == 1) & (contacts_i == 0)
        planner_loc = torch.where(to_plan[:, None], planned, planner_loc)
        # touch down: swing -> stance picks up the planned location
        touch = (prev_c == 0) & (contacts_i == 1)
        prev_locs = torch.where(touch[:, None], planner_loc, prev_locs)
        contacts.append(contacts_i)
        locs.append(prev_locs)
        prev_phase = next_phase
    return torch.stack(contacts), torch.stack(locs), planner_loc
