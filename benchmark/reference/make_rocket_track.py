"""Make the rocket MPC's tracking reference: the long (cold) landing problem
of ``configs/rocket_soc_N21.json`` solved by the plain reference in float64,
written to ``rocket_track.json`` beside this file.

    python benchmark/reference/make_rocket_track.py

The goal x_{N-1} = 0 is an equality E z = f of the stacked controls z; it
is eliminated (z = z_p + Z y, Z a basis of E's null space) and the rest is
the window solver's conic QP in y, started from the hover controls moved
onto the equality.
"""
from __future__ import annotations

import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from benchmark.reference import ipm, rocket  # noqa: E402

CONFIG = os.path.join(os.path.dirname(HERE), "configs", "rocket_soc_N21.json")


def solve_long(spec: dict):
    """(X [N, 6], U [N-1, 3]) of the long problem, float64."""
    prob = rocket.long_problem(spec)
    N, m = prob.N, prob.m
    x0 = torch.tensor(spec["model"]["x0"], dtype=torch.float64)[None]
    k = torch.zeros(1, dtype=torch.int64)
    qp = prob.qp(x0, k)
    Phi, G, c = prob.condensed()
    E = G[-1]                                           # [6, nz]
    f = -(Phi[-1] @ x0[0] + c[-1])
    Qfull, _ = torch.linalg.qr(E.T, mode="complete")
    Z = Qfull[:, E.shape[0]:]                           # [nz, nz - 6]
    z_p = torch.linalg.lstsq(E, f[:, None]).solution[:, 0]
    red = ipm.ConicQP(
        P=Z.T @ qp.P @ Z, p=(qp.p + (qp.P @ z_p)[None]) @ Z,
        blocks=[ipm.Block(b.kind, b.M @ Z,
                          b.h + torch.einsum("kdn,n->kd", b.M, z_p)[None])
                for b in qp.blocks])
    y0 = (rocket.hover(spec, 1, N).reshape(1, -1) - z_p[None]) @ Z
    y = ipm.solve(red, y0, gap_tol=1e-12)
    U = (z_p[None] + y @ Z.T).reshape(1, N - 1, m)
    if torch.isnan(U).any():
        raise RuntimeError("the long problem found no strictly feasible point")
    return prob.rollout(x0, U)[0], U[0], prob


def main() -> None:
    with open(CONFIG) as fh:
        spec = json.load(fh)
    X, U, prob = solve_long(spec)
    x0 = X[:1]
    viol = float(prob.violation(x0, U[None])[0])
    print(f"goal |x_N| {float(X[-1].abs().max()):.3e}, violation {viol:.3e}, "
          f"cost {float(prob.cost(x0, U[None], torch.zeros(1, dtype=torch.int64))[0]):.9f}")
    out = os.path.join(HERE, "rocket_track.json")
    with open(out, "w") as fh:
        json.dump({"made_by": "benchmark/reference/make_rocket_track.py",
                   "config": "rocket_soc_N21",
                   "X": [[float(v) for v in row] for row in X],
                   "U": [[float(v) for v in row] for row in U]}, fh)
        fh.write("\n")
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
