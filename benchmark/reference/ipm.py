"""A plain batched barrier (interior-point) solver for convex quadratic
programs with nonnegativity and second-order-cone constraints:

    minimize    0.5 z'P z + p_l'z
    subject to  w_j = M_j z + h_{l,j}  in K_j   for every block j,

with P and the maps M_j shared by the lanes l and p, h per lane. A block's
cone is "nonneg" (every row w >= 0) or "soc" (||w[..., :-1]|| <= w[..., -1]
for every knot's row group). The method is the textbook one (Boyd and
Vandenberghe, ch. 11): Newton's method on tau f + phi with a backtracking
line search that keeps every iterate strictly inside the cones, tau raised by
MU after each centering until the duality-gap bound nu / tau is below the
tolerance. A lane without a strictly feasible start runs a phase I first
(minimize s with every cone's last row relaxed by s).

Every product of data goes through an :class:`Arith`, so that the same code
runs in float64 (the reference) and in float32 with TF32-rounded operands
(the lower-precision control of the benchmark's check).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List

import torch

MU = 20.0
MAX_NEWTON = 60
MAX_HALVINGS = 60
ARMIJO = 0.25


class Arith:
    """How products are computed: in ``dtype``, and with ``tf32`` every
    operand of a product rounded to TF32's 10-bit mantissa first (products
    and sums then in float32, as the tensor cores' TF32 mode computes
    them)."""

    def __init__(self, dtype=torch.float64, tf32: bool = False):
        if tf32 and dtype != torch.float32:
            raise ValueError("TF32 rounds float32 operands")
        self.dtype, self.tf32 = dtype, tf32

    def r(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if not self.tf32:
            return x
        bits = x.contiguous().view(torch.int32)
        # round to nearest, ties away from zero, at bit 13 of the mantissa
        bits = (bits + 0x1000) & ~0x1FFF
        return bits.view(torch.float32)

    def einsum(self, eq: str, *ops) -> torch.Tensor:
        return torch.einsum(eq, *(self.r(o) for o in ops))

    def t(self, x) -> torch.Tensor:
        """A tensor in this arithmetic's type (no rounding: data, not a
        product)."""
        return torch.as_tensor(x).to(self.dtype)


F64 = Arith(torch.float64)
TF32 = Arith(torch.float32, tf32=True)


@dataclass
class Block:
    """Rows w = M z + h of one cone kind; M [K, d, nz] shared, h [L, K, d]."""

    kind: str            # "nonneg" or "soc"
    M: torch.Tensor
    h: torch.Tensor

    @property
    def degree(self) -> int:
        K, d = self.M.shape[0], self.M.shape[1]
        return K * d if self.kind == "nonneg" else 2 * K


@dataclass
class ConicQP:
    P: torch.Tensor      # [nz, nz]
    p: torch.Tensor      # [L, nz]
    blocks: List[Block]

    @property
    def degree(self) -> int:
        return sum(b.degree for b in self.blocks)


def _rows(ar: Arith, b: Block, z):
    return ar.einsum("kdn,ln->lkd", b.M, z) + b.h


def _slack(b: Block, w):
    """Per lane and knot, the distance from the cone's boundary that the
    barrier logs: w (nonneg, per row) or t^2 - ||v||^2 (soc)."""
    if b.kind == "nonneg":
        return w
    v, t = w[..., :-1], w[..., -1]
    return torch.where(t > 0, t * t - torch.sum(v * v, dim=-1),
                       torch.full_like(t, -1.0))


def feasible(ar: Arith, qp: ConicQP, z) -> torch.Tensor:
    """[L] whether z lies strictly inside every cone."""
    ok = torch.ones(z.shape[0], dtype=torch.bool, device=z.device)
    for b in qp.blocks:
        s = _slack(b, _rows(ar, b, z))
        ok &= (s > 0).flatten(1).all(dim=1)
    return ok


def barrier(ar: Arith, qp: ConicQP, z):
    """phi [L] (inf where z is not strictly feasible)."""
    phi = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
    for b in qp.blocks:
        s = _slack(b, _rows(ar, b, z))
        bad = (s <= 0).flatten(1).any(dim=1)
        val = -torch.log(torch.clamp(s, min=torch.finfo(z.dtype).tiny))
        phi = phi + torch.where(bad, torch.full_like(phi, float("inf")),
                                val.flatten(1).sum(dim=1))
    return phi


def barrier_change(ar: Arith, qp: ConicQP, z, cand):
    """phi(cand) - phi(z) [L], summed term by term (inf where cand is not
    strictly feasible), so that a small change is not lost to the size of
    phi."""
    out = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
    for b in qp.blocks:
        s0 = _slack(b, _rows(ar, b, z))
        s1 = _slack(b, _rows(ar, b, cand))
        bad = (s1 <= 0).flatten(1).any(dim=1)
        val = -torch.log(torch.clamp(s1, min=torch.finfo(z.dtype).tiny) / s0)
        out = out + torch.where(bad, torch.full_like(out, float("inf")),
                                val.flatten(1).sum(dim=1))
    return out


def _gram(ar: Arith, M, wgt):
    """sum over rows r of wgt[l, r] M_r' M_r: [L, nz, nz] (M [K, d, nz]
    and wgt [L, K, d] flattened over their rows)."""
    Mf = M.reshape(-1, M.shape[-1])
    Mw = Mf[None] * wgt.reshape(wgt.shape[0], -1)[..., None]
    return ar.r(Mw).transpose(1, 2) @ ar.r(Mf)


def barrier_derivatives(ar: Arith, qp: ConicQP, z):
    """(gradient [L, nz], Hessian [L, nz, nz]) of phi at a strictly feasible
    z."""
    L, nz = z.shape
    g = torch.zeros_like(z)
    H = torch.zeros((L, nz, nz), dtype=z.dtype, device=z.device)
    for b in qp.blocks:
        w = _rows(ar, b, z)
        if b.kind == "nonneg":
            g = g - ar.einsum("kdn,lkd->ln", b.M, 1.0 / w)
            H = H + _gram(ar, b.M, 1.0 / (w * w))
            continue
        v, t = w[..., :-1], w[..., -1]
        s = t * t - torch.sum(v * v, dim=-1)                   # [L, K]
        a = torch.cat([v, -t[..., None]], dim=-1)              # [L, K, d]
        g = g + ar.einsum("kdn,lkd->ln", b.M, 2.0 * a / s[..., None])
        sign = torch.ones(w.shape[-1], dtype=z.dtype, device=z.device)
        sign[-1] = -1.0
        H = H + _gram(ar, b.M, (2.0 / s)[..., None] * sign)
        Ma = ar.einsum("kdn,lkd->lkn", b.M, a)                 # [L, K, nz]
        H = H + ar.r(Ma * (4.0 / (s * s))[..., None]).transpose(1, 2) @ ar.r(Ma)
    return g, H


def objective(ar: Arith, qp: ConicQP, z):
    """f [L] = 0.5 z'P z + p'z."""
    Pz = ar.einsum("nm,lm->ln", qp.P, z)
    return 0.5 * torch.sum(z * Pz, dim=1) + torch.sum(qp.p * z, dim=1)


def _solve_spd(H, g):
    """H^-1 g per lane, with a growing diagonal shift where the Cholesky
    factorization fails; a lane that stays indefinite gets a zero step."""
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    scale = torch.diagonal(H, dim1=-2, dim2=-1).abs().amax(dim=-1)
    shift = torch.zeros_like(scale)
    for _ in range(12):
        Lc, info = torch.linalg.cholesky_ex(H + shift[:, None, None] * eye)
        bad = info != 0
        if not bool(bad.any()):
            break
        shift = torch.where(bad, torch.where(shift > 0, 10.0 * shift,
                                             1e-12 * scale + 1e-30), shift)
    x = torch.cholesky_solve(g[..., None], Lc)[..., 0]
    return torch.where(bad[:, None], torch.zeros_like(x), x)


def _center(ar: Arith, qp: ConicQP, z, tau, active, newton_tol):
    """Newton's method on tau f + phi from the strictly feasible z, for the
    lanes in ``active``; returns z. The line search takes the change of
    tau f exactly (f is quadratic) and phi's term by term."""
    nz = z.shape[1]
    eye = torch.eye(nz, dtype=z.dtype, device=z.device)
    for _ in range(MAX_NEWTON):
        gphi, Hphi = barrier_derivatives(ar, qp, z)
        gf = ar.einsum("nm,lm->ln", qp.P, z) + qp.p
        g = tau[:, None] * gf + gphi
        H = tau[:, None, None] * qp.P + Hphi
        act = (active & torch.isfinite(g).all(dim=1)
               & torch.isfinite(H).flatten(1).all(dim=1))
        H = torch.where(act[:, None, None], H, eye)
        g = torch.where(act[:, None], g, torch.zeros_like(g))
        step = -_solve_spd(H, g)
        dec = -torch.sum(g * step, dim=1)                      # lambda^2
        live = act & (dec > 2.0 * newton_tol)
        if not bool(live.any()):
            break
        lin = torch.sum(gf * step, dim=1)
        quad = torch.sum(step * ar.einsum("nm,lm->ln", qp.P, step), dim=1)
        alpha = torch.ones_like(tau)
        todo = live.clone()
        for _ in range(MAX_HALVINGS):
            cand = z + alpha[:, None] * step
            dF = (tau * (alpha * lin + 0.5 * alpha * alpha * quad)
                  + barrier_change(ar, qp, z, cand))
            todo = todo & ~(dF <= -ARMIJO * alpha * dec)
            if not bool(todo.any()):
                break
            alpha = torch.where(todo, 0.5 * alpha, alpha)
        moved = live & ~todo
        z = torch.where(moved[:, None], z + alpha[:, None] * step, z)
        if not bool(moved.any()):
            break
    return z


def _phase_one(ar: Arith, qp: ConicQP, z0, margin: float):
    """A strictly feasible point for the lanes whose z0 is not: minimize s
    (plus a small proximal term) with every cone's last row relaxed by s,
    until s < -margin. Lanes that stay at s >= 0 are infeasible: NaN."""
    L, nz = z0.shape
    dev, dt = z0.device, z0.dtype
    worst = torch.full((L,), -float("inf"), dtype=dt, device=dev)
    for b in qp.blocks:
        w = _rows(ar, b, z0)
        if b.kind == "nonneg":
            viol = (-w).flatten(1).amax(dim=1)
        else:
            viol = (torch.linalg.vector_norm(w[..., :-1], dim=-1)
                    - w[..., -1]).amax(dim=1)
        worst = torch.maximum(worst, viol)
    s0 = torch.clamp(worst, min=0.0) + 1.0
    reg = 1e-6
    blocks = []
    for b in qp.blocks:
        col = torch.zeros(b.M.shape[:2] + (1,), dtype=dt, device=dev)
        col[:, -1 if b.kind == "soc" else slice(None), 0] = 1.0
        blocks.append(Block(b.kind, torch.cat([b.M, col], dim=-1), b.h))
    P = torch.zeros((nz + 1, nz + 1), dtype=dt, device=dev)
    P[:nz, :nz] = reg * torch.eye(nz, dtype=dt, device=dev)
    p = torch.cat([-reg * z0, torch.ones((L, 1), dtype=dt, device=dev)], 1)
    aug = ConicQP(P, p, blocks)
    y = torch.cat([z0, s0[:, None]], dim=1)
    tau = torch.ones(L, dtype=dt, device=dev)
    active = torch.ones(L, dtype=torch.bool, device=dev)
    for _ in range(40):
        y = _center(ar, aug, y, tau, active, 1e-6)
        active = active & (y[:, -1] >= -margin)
        if not bool(active.any()):
            break
        tau = torch.where(active, MU * tau, tau)
    z = y[:, :nz]
    return torch.where(active[:, None], torch.full_like(z, float("nan")), z)


def solve(qp: ConicQP, z0, ar: Arith = F64, gap_tol: float = 1e-10,
          newton_tol: float = 1e-10):
    """The minimizer z [L, nz] of every lane's problem, started from z0
    [L, nz] (a lane not strictly feasible there runs phase I first; an
    infeasible lane returns NaN). Stops when the duality-gap bound nu / tau
    is below ``gap_tol`` (1 + |f|)."""
    qp = ConicQP(ar.t(qp.P), ar.t(qp.p),
                 [dataclasses.replace(b, M=ar.t(b.M), h=ar.t(b.h))
                  for b in qp.blocks])
    z = ar.t(z0).clone()
    ok = feasible(ar, qp, z)
    if not bool(ok.all()):
        margin = 1e-6 * (1.0 + float(z.abs().max()))
        z = torch.where(ok[:, None], z, _phase_one(ar, qp, z, margin))
    nu = float(qp.degree)
    good = ~torch.isnan(z).any(dim=1)
    z = torch.where(good[:, None], z, torch.zeros_like(z))
    f = objective(ar, qp, z)
    tau = torch.clamp(nu / (1.0 + f.abs()), min=1e-3)
    active = good.clone()
    for _ in range(200):
        z = _center(ar, qp, z, tau, active, newton_tol)
        f = objective(ar, qp, z)
        active = active & (nu / tau > gap_tol * (1.0 + f.abs()))
        if not bool(active.any()):
            break
        tau = torch.where(active, MU * tau, tau)
    return torch.where(good[:, None], z, torch.full_like(z, float("nan")))
