"""The quadruped trot MPC (the ALTRO-SOCP row of altro-mpc-icra2021's
``benchmarks/quadruped``: Woofer's ``MPCControl/MPC.yaml`` and
``Structs/FrictionConstraint.jl``), run by a fleet in gait-phase groups:
its data and its plain reference.

The model is Woofer as a single rigid body, from the configuration's
published parameters (``robot``): mass m = frame + 4 modules + 8 upper
links, the body's diagonal inertia J, the feet at the nominal stance
(the hips' layout, the abduction offset outward, at the foot radius)
under a body at the stance height. State x = (p, mrp, v, omega_body),
control u = the four feet's world forces (fx, fy, fz) leg by leg, legs
front-right, front-left, back-right, back-left. A foot in contact exerts
its force on the body; a swing foot's force acts on nothing.

A window is N knots dt apart (``mpc``). Its knots' contact flags come from
the trot (stance, swing, stance, swing phases; the diagonal pairs swing in
turn) read on a whole-millisecond grid: knot i of a window at gait time t
is in the phase of (t + i dt) mod the gait's length, a time on a boundary
in the next phase. Its dynamics are the Euler discretization of the model
linearized about hover: x_bar = x_des (the stance height, all else 0),
u_bar the weight m g shared by the stance feet, vertical. About hover (R
= I, omega = 0) the linearization is, in closed form (a_i the stance
foot's lever r_i - p_bar, F_i its hover force, [.]x the cross-product
matrix):

    pdot = v;  mrpdot = omega / 4;  vdot = g + sum_i F_i / m;
    omegadot = J^-1 (sum_i [F_i]x dp + 4 [sum_i a_i x F_i]x dmrp
                     + sum_i [a_i]x dF_i),

so A = I + A_c dt, B = B_c dt and d = (f(x_bar, u_bar) - A_c x_bar -
B_c u_bar) dt. The cost tracks x_des with zero forces: Q dt and R dt at
the stage knots, Q at the last (MPC.yaml's q and r). The constraints, at
every knot with a control: per foot the cone ||(fx, fy)|| <= mu fz, and
the vertical forces' bounds fz_min <= fz <= fz_max.

The episode: the fleet is ``groups`` groups of lanes, group g's gait
``offset_ms`` g ms ahead; window w (the one the step before step w
solves; window 0 is the initial carry's) of group g starts at gait time
w dt + g offset. A window index k is k = w G + g (the cell's
``window_k``). A step propagates a lane with the first knot of its
group's previous window, w - 1 (the dynamics its applied control was
planned with), and adds process noise x + w_noise X0_SCALE * eps.

Departures from the source, each for the check's sake:

- the plant is the controller's own linearized model plus process noise,
  not the RK4 single rigid body under the swing legs' PD control, so the
  check can recompute every step exactly;
- the fleet trots in place (the source's default command, xy_vel 0): the
  feet stay at the nominal stance and every window is linearized about
  x_des, where the source relinearizes about its estimated state;
- the fleet is out of phase in G groups 50 ms apart, where the source runs
  one robot.

Every lane's window is solved as the tracking reference does it (the
controls' condensed QP, then the barrier method of ``ipm.py``), all lanes
in one batch: each lane's window has its own dynamics, so each has its own
Hessian P, and :func:`solve_lanes` is ``ipm.solve`` with P one per lane
(its Newton steps, line search, phase I and stopping rule are ``ipm.py``'s
own). The cones bind controls alone, so their rows are one map for every
window. Everything is float64 unless an :class:`~.ipm.Arith` asks for the
control's arithmetic.
"""
from __future__ import annotations

import dataclasses

import torch

from . import ipm
from .ipm import F64, Arith
from .tracking import RowBlock, _project_soc

GRAVITY = 9.81
# the trot's contact flags, one row a leg, one column a phase (stance,
# swing, stance, swing)
TROT = ((1, 1, 1, 0), (1, 0, 1, 1), (1, 0, 1, 1), (1, 1, 1, 0))


def cross(a):
    """Cross-product matrices [..., 3, 3] of a [..., 3]."""
    z = torch.zeros_like(a[..., 0])
    return torch.stack([torch.stack([z, -a[..., 2], a[..., 1]], -1),
                        torch.stack([a[..., 2], z, -a[..., 0]], -1),
                        torch.stack([-a[..., 1], a[..., 0], z], -1)], -2)




# -- the barrier method of ipm.py, one Hessian P per lane ---------------------

def _objective(ar: Arith, qp: ipm.ConicQP, z):
    """f [L] = 0.5 z'P_l z + p_l'z (qp.P [L, nz, nz])."""
    Pz = ar.einsum("lnm,lm->ln", qp.P, z)
    return 0.5 * torch.sum(z * Pz, dim=1) + torch.sum(qp.p * z, dim=1)


def _center(ar: Arith, qp: ipm.ConicQP, z, tau, active, newton_tol):
    """``ipm._center`` with qp.P one per lane: Newton's method on tau f +
    phi from the strictly feasible z, for the lanes in ``active``."""
    nz = z.shape[1]
    eye = torch.eye(nz, dtype=z.dtype, device=z.device)
    for _ in range(ipm.MAX_NEWTON):
        gphi, Hphi = ipm.barrier_derivatives(ar, qp, z)
        gf = ar.einsum("lnm,lm->ln", qp.P, z) + qp.p
        g = tau[:, None] * gf + gphi
        H = tau[:, None, None] * qp.P + Hphi
        act = (active & torch.isfinite(g).all(dim=1)
               & torch.isfinite(H).flatten(1).all(dim=1))
        H = torch.where(act[:, None, None], H, eye)
        g = torch.where(act[:, None], g, torch.zeros_like(g))
        step = -ipm._solve_spd(H, g)
        dec = -torch.sum(g * step, dim=1)                      # lambda^2
        live = act & (dec > 2.0 * newton_tol)
        if not bool(live.any()):
            break
        lin = torch.sum(gf * step, dim=1)
        quad = torch.sum(step * ar.einsum("lnm,lm->ln", qp.P, step), dim=1)
        alpha = torch.ones_like(tau)
        todo = live.clone()
        for _ in range(ipm.MAX_HALVINGS):
            cand = z + alpha[:, None] * step
            dF = (tau * (alpha * lin + 0.5 * alpha * alpha * quad)
                  + ipm.barrier_change(ar, qp, z, cand))
            todo = todo & ~(dF <= -ipm.ARMIJO * alpha * dec)
            if not bool(todo.any()):
                break
            alpha = torch.where(todo, 0.5 * alpha, alpha)
        moved = live & ~todo
        z = torch.where(moved[:, None], z + alpha[:, None] * step, z)
        if not bool(moved.any()):
            break
    return z


def solve_lanes(qp: ipm.ConicQP, z0, ar: Arith = F64, gap_tol: float = 1e-10,
                newton_tol: float = 1e-10):
    """``ipm.solve`` of lanes whose Hessians differ (qp.P [L, nz, nz]; the
    blocks' maps shared, as there): the minimizer z [L, nz] from z0, phase
    I first for a lane not strictly feasible there, NaN for an infeasible
    lane; stops when nu / tau is below ``gap_tol`` (1 + |f|)."""
    qp = ipm.ConicQP(ar.t(qp.P), ar.t(qp.p),
                     [dataclasses.replace(b, M=ar.t(b.M), h=ar.t(b.h))
                      for b in qp.blocks])
    z = ar.t(z0).clone()
    ok = ipm.feasible(ar, qp, z)
    if not bool(ok.all()):
        margin = 1e-6 * (1.0 + float(z.abs().max()))
        z = torch.where(ok[:, None], z, ipm._phase_one(ar, qp, z, margin))
    nu = float(qp.degree)
    good = ~torch.isnan(z).any(dim=1)
    z = torch.where(good[:, None], z, torch.zeros_like(z))
    f = _objective(ar, qp, z)
    tau = torch.clamp(nu / (1.0 + f.abs()), min=1e-3)
    active = good.clone()
    for _ in range(200):
        z = _center(ar, qp, z, tau, active, newton_tol)
        f = _objective(ar, qp, z)
        active = active & (nu / tau > gap_tol * (1.0 + f.abs()))
        if not bool(active.any()):
            break
        tau = torch.where(active, ipm.MU * tau, tau)
    return torch.where(good[:, None], z, torch.full_like(z, float("nan")))


# -- the configuration's windows ---------------------------------------------

class TrotReference:
    """The plain reference of the configuration ``spec``: ``propagate``,
    ``solve``, ``cost`` and ``violation`` of lanes in their windows k (see
    the module's docstring), each distinct window's dynamics built once."""

    def __init__(self, spec: dict, device="cpu"):
        kw = dict(dtype=torch.float64, device=device)
        rb, mpc = spec["robot"], spec["mpc"]
        self.spec, self.device = spec, torch.device(device)
        self.mass = (rb["frame_mass"] + 4 * rb["module_mass"]
                     + 8 * rb["upper_link_mass"])
        self.J_inv = torch.linalg.inv(torch.diag(torch.tensor(
            rb["body_inertia"], **kw)))
        x, y = rb["hip_center_x"], rb["hip_center_y"] + rb["abduction_offset"]
        z = rb["foot_radius"]
        self.feet = torch.tensor([[x, -y, z], [x, y, z], [-x, -y, z],
                                  [-x, y, z]], **kw)
        self.n = self.m = 12
        self.N = int(mpc["N"])
        self.dt = float(mpc["dt"])
        self.dt_ms = round(self.dt * 1e3)
        phases = [mpc["stance_time"], mpc["swing_time"]] * 2
        self.phase_ends = torch.cumsum(torch.tensor(
            [round(p * 1e3) for p in phases]), 0).tolist()
        self.G = int(spec["groups"])
        self.offset_ms = int(spec["phase_offset_ms"])
        self.x_des = torch.zeros(12, **kw)
        self.x_des[2] = mpc["stance_height"]
        q = torch.tensor(mpc["q"], **kw)
        r = torch.tensor(mpc["r"], **kw)
        self.Q, self.R, self.Qf = (torch.diag(q) * self.dt,
                                   torch.diag(r) * self.dt, torch.diag(q))
        self.blocks = self._blocks(float(mpc["mu"]),
                                   float(mpc["min_vert_force"]),
                                   float(mpc["max_vert_force"]), kw)
        noise = spec["noise"]
        self.sigma = float(noise["w"]) * torch.tensor(noise["x0_scale"],
                                                      **kw)
        self._windows = {}

    def to(self, device) -> "TrotReference":
        if torch.device(device) == self.device:
            return self
        return TrotReference(self.spec, device)

    def _blocks(self, mu, fz_min, fz_max, kw):
        """Per foot the cone (fx, fy, mu fz), then the fz bounds' 8 rows,
        at every knot with a control; rows on the controls alone."""
        n, m, ks = self.n, self.m, range(self.N - 1)
        out = []
        for leg in range(4):
            Cu = torch.zeros((3, m), **kw)
            Cu[0, 3 * leg] = Cu[1, 3 * leg + 1] = 1.0
            Cu[2, 3 * leg + 2] = mu
            out.append(RowBlock("soc", torch.zeros((3, n), **kw), Cu,
                                torch.zeros(3, **kw), ks))
        Cu = torch.zeros((8, m), **kw)
        for leg in range(4):
            Cu[leg, 3 * leg + 2] = 1.0            # fz - fz_max <= 0
            Cu[4 + leg, 3 * leg + 2] = -1.0       # fz_min - fz <= 0
        b = torch.tensor([-fz_max] * 4 + [fz_min] * 4, **kw)
        out.append(RowBlock("nonpos", torch.zeros((8, n), **kw), Cu, b, ks))
        return out

    # -- the episode's windows ------------------------------------------------

    def gait_ms(self, k) -> list:
        """The gait time (ms, mod the gait's length) of each window k [L]."""
        k = torch.as_tensor(k).cpu()
        t = (k // self.G) * self.dt_ms + (k % self.G) * self.offset_ms
        return (t % self.phase_ends[-1]).tolist()

    def contacts(self, t_ms: int) -> torch.Tensor:
        """Contact flags [N, 4] of the window at gait time t_ms."""
        ends = self.phase_ends
        rows = []
        for i in range(self.N):
            ti = (t_ms + i * self.dt_ms) % ends[-1]
            ph = next(p for p, e in enumerate(ends) if ti < e)
            rows.append([TROT[leg][ph] for leg in range(4)])
        return torch.tensor(rows, dtype=torch.float64, device=self.device)

    def linearized(self, contacts):
        """(A [N-1, n, n], B [N-1, n, m], d [N-1, n]) about hover on the
        contact flags [N, 4] (the last knot's are not read)."""
        c = contacts[:-1]                                      # [K, 4]
        K = c.shape[0]
        kw = dict(dtype=torch.float64, device=self.device)
        stance = torch.clamp(c.sum(dim=1, keepdim=True), min=1.0)
        F = torch.zeros((K, 4, 3), **kw)
        F[..., 2] = self.mass * GRAVITY / stance * c
        a = self.feet - self.x_des[0:3]                        # [4, 3]
        I3 = torch.eye(3, **kw)
        tau = torch.linalg.cross(a.expand(K, 4, 3), F).sum(dim=1)  # [K, 3]
        Ac = torch.zeros((K, 12, 12), **kw)
        Ac[:, 0:3, 6:9] = I3
        Ac[:, 3:6, 9:12] = 0.25 * I3
        Ac[:, 9:12, 0:3] = self.J_inv @ cross(F).sum(dim=1)
        Ac[:, 9:12, 3:6] = self.J_inv @ (4.0 * cross(tau))
        Bc = torch.zeros((K, 12, 12), **kw)
        for leg in range(4):
            cl = c[:, leg, None, None]
            Bc[:, 6:9, 3 * leg:3 * leg + 3] = cl * I3 / self.mass
            Bc[:, 9:12, 3 * leg:3 * leg + 3] = cl * (self.J_inv
                                                     @ cross(a[leg]))
        f = torch.zeros((K, 12), **kw)
        f[:, 8] = -GRAVITY
        f[:, 6:9] += F.sum(dim=1) / self.mass
        f[:, 9:12] = tau @ self.J_inv.T
        u = F.reshape(K, 12)
        dc = f - Ac @ self.x_des - (Bc @ u[..., None])[..., 0]
        eye = torch.eye(12, **kw)
        return eye + Ac * self.dt, Bc * self.dt, dc * self.dt

    def window(self, t_ms: int):
        """(A, B, d) of the window at gait time t_ms (built once)."""
        if t_ms not in self._windows:
            self._windows[t_ms] = self.linearized(self.contacts(t_ms))
        return self._windows[t_ms]

    def stacks(self, k):
        """Every lane's window dynamics: A [L, N-1, n, n], B [L, N-1, n, m],
        d [L, N-1, n] of the windows k [L]."""
        wins = [self.window(t) for t in self.gait_ms(k)]
        return tuple(torch.stack([w[i] for w in wins]) for i in range(3))

    # -- the step's own work --------------------------------------------------

    def propagate(self, x0, u0, noise, k, ar: Arith = F64):
        """The next state of every lane (x0 [L, n], u0 [L, m], noise [L,
        n]): the first knot of its window's predecessor (k - G: the same
        group, one window earlier) applied to (x0, u0), plus the process
        noise."""
        A, B, d = (s[:, 0] for s in self.stacks(k - self.G))
        x = (ar.einsum("lij,lj->li", A, x0) + ar.einsum("lij,lj->li", B, u0)
             + ar.t(d))
        return x + ar.t(noise) * ar.t(self.sigma)

    # -- the window's problem -------------------------------------------------

    def rollout(self, x0, U, k):
        """States [L, N, n] of the controls U [L, N-1, m] from x0 [L, n] in
        the windows k [L], float64."""
        A, B, d = self.stacks(k)
        xs = [x0.double()]
        for j in range(U.shape[1]):
            xs.append(torch.einsum("lij,lj->li", A[:, j], xs[-1])
                      + torch.einsum("lij,lj->li", B[:, j], U[:, j].double())
                      + d[:, j])
        return torch.stack(xs, dim=1)

    def cost(self, x0, U, k):
        """The tracking cost J [L] of the controls U from x0, float64."""
        ex = self.rollout(x0, U, k) - self.x_des
        eu = U.double()
        return (0.5 * torch.einsum("lki,ij,lkj->l", ex[:, :-1], self.Q,
                                   ex[:, :-1])
                + 0.5 * torch.einsum("lki,ij,lkj->l", eu, self.R, eu)
                + 0.5 * torch.einsum("li,ij,lj->l", ex[:, -1], self.Qf,
                                     ex[:, -1]))

    def violation(self, x0, U, k):
        """The largest constraint violation [L] of the controls U from x0:
        the inf-norm of c - proj_K(c) over the active rows, float64."""
        X = self.rollout(x0, U, k)
        Up = torch.cat([U.double(), torch.zeros_like(U[:, :1]).double()], 1)
        worst = torch.zeros(X.shape[0], dtype=torch.float64, device=X.device)
        for blk in self.blocks:
            ks = torch.as_tensor(list(blk.knots), device=X.device)
            c = X[:, ks] @ blk.Cx.T + Up[:, ks] @ blk.Cu.T + blk.b
            v = (torch.clamp(c, min=0.0) if blk.kind == "nonpos"
                 else c - _project_soc(c))
            worst = torch.maximum(worst, v.abs().flatten(1).amax(dim=1))
        return worst

    def qp(self, x0, k, ar: Arith = F64) -> ipm.ConicQP:
        """Every lane's condensed conic QP (x0 [L, n], k [L]): P [L, nz,
        nz] of its window's dynamics, p [L, nz]; the cones' rows, on the
        controls alone, one map for every lane."""
        N, n, m = self.N, self.n, self.m
        nz = (N - 1) * m
        A, B, d = (ar.t(s) for s in self.stacks(k))
        L = A.shape[0]
        kw = dict(dtype=A.dtype, device=A.device)
        Phi = [torch.eye(n, **kw).expand(L, n, n)]
        c = [torch.zeros((L, n), **kw)]
        G = [torch.zeros((L, n, nz), **kw)]
        for j in range(1, N):
            Phi.append(ar.einsum("lij,ljk->lik", A[:, j - 1], Phi[-1]))
            c.append(ar.einsum("lij,lj->li", A[:, j - 1], c[-1])
                     + d[:, j - 1])
            g = ar.einsum("lij,ljz->liz", A[:, j - 1], G[-1])
            g[:, :, (j - 1) * m:j * m] = (g[:, :, (j - 1) * m:j * m]
                                          + B[:, j - 1])
            G.append(g)
        Phi, G, c = (torch.stack(t, dim=1) for t in (Phi, G, c))
        xbar = ar.einsum("lkij,lj->lki", Phi, ar.t(x0)) + c    # [L, N, n]
        Qk = torch.stack([ar.t(self.Q)] * (N - 1) + [ar.t(self.Qf)])
        Qk[0] = 0.0                                          # x0 is fixed
        e = xbar - ar.t(self.x_des)
        Rbig = torch.kron(torch.eye(N - 1, **kw), ar.t(self.R))
        P = ar.einsum("lkaz,kab,lkby->lzy", G, Qk, G) + Rbig
        p = ar.einsum("lkaz,kab,lkb->lz", G, Qk, e)          # U_track = 0
        blocks = []
        for blk in self.blocks:
            if bool(blk.Cx.any()):
                raise ValueError("the window's rows bind the controls alone")
            ks = list(blk.knots)
            Cu, b = ar.t(blk.Cu), ar.t(blk.b)
            M = torch.zeros((len(ks), Cu.shape[0], nz), **kw)
            for j, kk in enumerate(ks):
                M[j, :, kk * m:(kk + 1) * m] = Cu
            h = b.expand(L, len(ks), b.shape[0])
            if blk.kind == "nonpos":
                blocks.append(ipm.Block("nonneg", -M, -h))
            else:
                blocks.append(ipm.Block("soc", M, h))
        return ipm.ConicQP(P, p, blocks)

    def solve(self, x0, k, z0, ar: Arith = F64, gap_tol: float = 1e-10):
        """Every lane's window solution U [L, N-1, m] from x0 [L, n] in the
        windows k [L], started from z0 [L, N-1, m]; NaN for a lane whose
        window is infeasible."""
        z = solve_lanes(self.qp(x0, k, ar), z0.reshape(z0.shape[0], -1), ar,
                        gap_tol=gap_tol)
        return z.reshape(z0.shape)

    def hover(self, L: int):
        """The stance forces m g / 4 on every foot, [L, N-1, 12]: strictly
        inside every cone and bound, the reference solver's start."""
        u = torch.zeros(12, dtype=torch.float64)
        u[2::3] = self.mass * GRAVITY / 4.0
        return u.expand(L, self.N - 1, 12).clone()
