"""The rocket soft landing with second-order-cone constraints (the reference
ALTRO's ``rocket_landing`` MPC): its data and its plain reference.

A point mass of mass ``mass`` under gravity, thrust u in R^3, state x =
(position, velocity) in R^6; the continuous dynamics x' = [[0, I], [0, 0]] x
+ [[0], [I / mass]] u + [0; g] (planet rotation left out: omega = 0) are
discretized exactly at the step dt (zero-order hold, one matrix
exponential). The cones, each a row group c = Cx x + Cu u + b with
||c[:-1]|| <= c[-1]:

- max thrust ||u|| <= mass |g| per_weight_max;
- thrust angle ||(u_x, u_y)|| <= tan(theta_thrust_max) u_z;
- glideslope ||(x, y)|| <= tan(theta_glideslope) z, from knot
  glide_recover_k - 1 on.

The long (cold) problem of ``long_knots`` knots drives x0 to the origin (LQR
weights Qk, Rk times dt, Qfk at the terminal knot, and the goal x_{N-1} = 0
as an equality); its solution is the MPC's tracking reference, made once by
``make_rocket_track.py`` and kept in ``rocket_track.json``. The MPC window
of N_mpc knots tracks it (stage weights times dt, the terminal not) under
the three cones, clipped to the window with the window's terminal knot
inactive: the control cones at every knot that has a control, the glideslope
from knot glide_recover_k - 1 to N_mpc - 2 in every window (the long
problem's mask, cut to the window's first knots). Process noise scales the
position part of a standard normal draw by ||position|| wp and the velocity
part by ||velocity|| wv.
"""
from __future__ import annotations

import json
import math
import os

import torch

from .ipm import Arith
from .tracking import RowBlock, TrackingMPC

TRACK_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "rocket_track.json")


def dynamics(model: dict, dt: float):
    """(Ad [6, 6], Bd [6, 3], dd [6]) in float64, exact zero-order hold."""
    kw = dict(dtype=torch.float64)
    mass = float(model["mass"])
    g = torch.as_tensor(model["gravity"], **kw)
    M = torch.zeros((10, 10), **kw)
    M[:3, 3:6] = torch.eye(3, **kw)
    M[3:6, 6:9] = torch.eye(3, **kw) / mass
    M[3:6, 9] = g
    E = torch.linalg.matrix_exp(M * dt)
    return E[:6, :6], E[:6, 6:9], E[:6, 9]


def cones(model: dict, N: int, glide_stop: int):
    """The three cone blocks of an N-knot problem: the control cones at
    knots 0 .. N-2, the glideslope at glide_recover_k - 1 .. glide_stop - 1.
    """
    kw = dict(dtype=torch.float64)
    n, m = 6, 3
    u_bnd = (float(model["mass"]) * abs(float(model["gravity"][2]))
             * float(model["per_weight_max"]))
    alpha = math.tan(math.radians(float(model["theta_thrust_max"])))
    alpha_g = math.tan(math.radians(float(model["theta_glideslope"])))
    thrust = RowBlock(
        "soc", Cx=torch.zeros((4, n), **kw),
        Cu=torch.cat([torch.eye(3, **kw), torch.zeros((1, 3), **kw)]),
        b=torch.tensor([0.0, 0.0, 0.0, u_bnd], **kw), knots=range(N - 1))
    angle_u = torch.zeros((4, m), **kw)
    angle_u[0, 0] = angle_u[1, 1] = 1.0
    angle_u[3, 2] = alpha
    angle = RowBlock("soc", Cx=torch.zeros((4, n), **kw), Cu=angle_u,
                     b=torch.zeros(4, **kw), knots=range(N - 1))
    glide_x = torch.zeros((7, n), **kw)
    glide_x[0, 0] = glide_x[1, 1] = 1.0
    glide_x[6, 2] = alpha_g
    glide = RowBlock("soc", Cx=glide_x, Cu=torch.zeros((7, m), **kw),
                     b=torch.zeros(7, **kw),
                     knots=range(int(model["glide_recover_k"]) - 1,
                                 glide_stop))
    return [thrust, angle, glide]


def noise_model_of(wp: float, wv: float):
    def model(x, noise, ar: Arith):
        pos = torch.linalg.vector_norm(x[..., :3], dim=-1, keepdim=True)
        vel = torch.linalg.vector_norm(x[..., 3:], dim=-1, keepdim=True)
        return x + torch.cat([noise[..., :3] * pos * wp,
                              noise[..., 3:] * vel * wv], dim=-1)
    return model


def long_problem(spec: dict) -> TrackingMPC:
    """The long problem as a tracking problem of the origin (window 0 of a
    zero reference), without its goal equality."""
    model, cold = spec["model"], spec["cold"]
    N = int(cold["knots"])
    dt = float(cold["tf"]) / (N - 1)
    Ad, Bd, dd = dynamics(model, dt)
    kw = dict(dtype=torch.float64)
    return TrackingMPC(
        A=Ad, B=Bd, d=dd, Q=cold["Qk"] * dt * torch.eye(6, **kw),
        R=cold["Rk"] * dt * torch.eye(3, **kw),
        Qf=cold["Qfk"] * torch.eye(6, **kw),
        X_track=torch.zeros((N, 6), **kw), U_track=torch.zeros((N - 1, 3), **kw),
        N=N, blocks=cones(model, N, N - 1),
        noise_model=noise_model_of(0.0, 0.0))


def load_track():
    """(X_track [Nt, 6], U_track [Nt-1, 3]) float64, from the data file."""
    with open(TRACK_FILE) as f:
        data = json.load(f)
    return (torch.tensor(data["X"], dtype=torch.float64),
            torch.tensor(data["U"], dtype=torch.float64))


def tracking_mpc(spec: dict, data: dict) -> TrackingMPC:
    """The window problem of the configuration ``spec`` on ``data`` (the
    track handed to the program: X_track, U_track)."""
    model, w = spec["model"], spec["tracking"]
    N = int(spec["N_mpc"])
    dt = float(w["dt"])
    Ad, Bd, dd = dynamics(model, dt)
    kw = dict(dtype=torch.float64)
    Qf = w["Qf"] if w.get("Qf") is not None else w["Q"]
    noise = spec["noise"]
    return TrackingMPC(
        A=Ad, B=Bd, d=dd, Q=w["Q"] * dt * torch.eye(6, **kw),
        R=w["R"] * dt * torch.eye(3, **kw), Qf=Qf * torch.eye(6, **kw),
        X_track=data["X_track"].double(), U_track=data["U_track"].double(),
        N=N, blocks=cones(model, N, N - 1),
        noise_model=noise_model_of(float(noise["wp"]), float(noise["wv"])))


def hover(spec: dict, L: int, N: int):
    """Hover controls -mass g, [L, N-1, 3]: strictly inside the thrust
    cones, the reference solver's start."""
    model = spec["model"]
    g = torch.as_tensor(model["gravity"], dtype=torch.float64)
    return (-float(model["mass"]) * g).expand(L, N - 1, 3).clone()
