"""The four kernels at the TPU kernels' full width (n, m <= 64): on a CUDA
device each kernel's wide body (n or m above 32) against its plain version
at n in {33, 55, 64}, and each wrapper refusing n or m = 65; the edges of
the four kernels' wide mappings: one control, a narrow state beside the
widest control, a control just past the group bodies at full state, the
shortest horizon, either side of each kernel's choice of body (and of
kernels C's and D's places for their staged rows), one lane and 1023,
ladders of 1 and 32 rungs, per-lane dynamics at 64, kernel C with a group
axis, a NaN lane, rows that start off a 16-byte boundary, and a lane whose
Quu + reg I is indefinite (the clamped pivots, against a clamped
recursion); on the CPU the wide inputs at every edge through the wrappers'
plain dispatch, kernel A's byte count, and the state_dim sweep's widest
point (n = 55, m = 2, N = 21) of the port's lockstep loop against the JAX
package's.

The kernel tests need no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_wide.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from altro_tpu_torch.bench import kernels as bk  # noqa: E402
from altro_tpu_torch.ops import (riccati, riccati_fused, rollout,  # noqa: E402
                                 rollout_al)

torch.set_num_threads(1)
# (n, m): past the group bodies by one, the state_dim sweep's widest point,
# the widest, and a wide state with a narrow control or the reverse
WIDTHS = [(33, 2), (55, 2), (64, 64), (33, 40), (12, 64)]
TOLS = [(torch.float32, 1e-3), (torch.float64, 1e-9)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to run the hand-written kernels")
    return torch.device("cuda")


def _close(got, ref, tol, truth=None):
    """max|got - ref| <= tol max(1, max|ref|), plus, given the float64
    answer on the same data (``truth``), four times the plain float32
    version's own distance from it: at these widths Quu reaches condition
    numbers where float32 rounding alone moves d by more than 1e-3 of its
    size (n = 12, m = 64: the plain version's d is 2.5e-2 off the float64
    answer, max|d| = 12.6), so the kernel is held to the plain version's
    accuracy there."""
    truth = ref if truth is None else truth
    for g, r, t in zip(got, ref, truth):
        assert torch.isfinite(r).all()
        r, t = r.double(), t.double().to(r.device)
        slack = 4.0 * float((r - t).abs().max())
        assert float((g.double() - r).abs().max()) <= tol * max(
            1.0, float(r.abs().max())) + slack


def test_wide_inputs_on_cpu():
    """The wide inputs' shapes and row cases, through every wrapper's plain
    dispatch (no launch)."""
    w = bk.wide_inputs(torch.float64, torch.device("cpu"), 3, 64, 64, N=5)
    assert w["packed"].P == 12 and w["packed"].meta == ((0, 8, 1),
                                                        (8, 4, 2))
    counts = [rollout.launch_count, riccati_fused.launch_count,
              rollout_al.launch_count, riccati.launch_count]
    K, d, dV1, dV2 = riccati_fused.fused_expand_backward(
        *w["fused"], packed=w["packed"])
    assert K.shape == (3, 4, 64, 64) and d.shape == (3, 4, 64)
    _close(riccati.batched_riccati(*w["riccati"]), w["fused_ref"], 1e-12)
    Xs, Us = rollout.batched_ls_rollout(*w["ladder"])
    assert Xs.shape == (3, 11, 5, 64) and Us.shape == (3, 11, 4, 64)
    Xa, Ua, J = rollout_al.batched_ls_rollout_al(*w["ladder_al"])
    assert torch.equal(Xa, Xs) and torch.equal(Ua, Us)
    assert J.shape == (3, 11) and torch.isfinite(J).all()
    assert counts == [rollout.launch_count, riccati_fused.launch_count,
                      rollout_al.launch_count, riccati.launch_count]
    nbytes, flops = bk.fused_work(1024, 21, 64, 64, 12, (4,), 8)
    assert nbytes > 0 and flops > 1024 * 21 * 2 * 64 ** 3


# edges of the wide mappings (n, m, N): one control; a narrow state beside
# the widest control; the full state with a control just past the group
# bodies; the shortest horizon at full width and at the sweep's first wide
# point; either side of kernel B's choice between its entry body and its
# tiled body (n + m = 40 and 41)
EDGES = [(33, 1, 9), (2, 64, 9), (64, 33, 9), (64, 64, 2), (35, 2, 2),
         (38, 2, 9), (39, 2, 9)]


def _edge_id(e):
    return f"n{e[0]}m{e[1]}N{e[2]}"


def _counts():
    return (rollout.launch_count, riccati_fused.launch_count,
            rollout_al.launch_count, riccati.launch_count)


def _clamped_backward(A, B, lx, lu, lxx, luu, lux, reg):
    """The plain Riccati recursion with the kernels' Cholesky: pivots
    clamped as sqrt(max(., 1e-12)), a NaN kept, where the plain version
    gives a failed factorization NaN gains."""
    Bt, N, n = lx.shape
    m = lu.shape[-1]
    kw = dict(dtype=lx.dtype, device=lx.device)
    Vx, Vxx = lx[:, -1], lxx[..., -1, :, :].expand(Bt, n, n)
    dV1, dV2 = torch.zeros(Bt, **kw), torch.zeros(Bt, **kw)
    Ks, ds = [], []

    def mv(M, v):
        return (M @ v[..., None])[..., 0]
    for k in reversed(range(N - 1)):
        Ak, Bk = A[..., k, :, :], B[..., k, :, :]
        VA = Vxx @ Ak
        Qx, Qu = lx[:, k] + mv(Ak.mT, Vx), lu[:, k] + mv(Bk.mT, Vx)
        Qxx = lxx[..., k, :, :] + Ak.mT @ VA
        Quu = luu[..., k, :, :] + Bk.mT @ (Vxx @ Bk)
        Qux = lux[..., k, :, :] + Bk.mT @ VA
        M = Quu + reg[:, None, None] * torch.eye(m, **kw)
        L = torch.zeros_like(M)
        for j in range(m):
            dg = M[:, j, j] - (L[:, j, :j] ** 2).sum(-1)
            piv = torch.sqrt(torch.where((dg > 1e-12) | torch.isnan(dg), dg,
                                         torch.full_like(dg, 1e-12)))
            L[:, j, j] = piv
            L[:, j + 1:, j] = (M[:, j + 1:, j] - mv(L[:, j + 1:, :j],
                                                    L[:, j, :j])) / piv[:, None]
        sol = torch.cholesky_solve(torch.cat([Qux, Qu[..., None]], -1), L)
        K, d = -sol[..., :-1], -sol[..., -1]
        Quud = mv(Quu, d)
        Vx = Qx + mv(K.mT, Quud) + mv(K.mT, Qu) + mv(Qux.mT, d)
        Vxx = Qxx + K.mT @ (Quu @ K) + K.mT @ Qux + Qux.mT @ K
        Vxx = 0.5 * (Vxx + Vxx.mT)
        dV1 = dV1 + (d * Qu).sum(-1)
        dV2 = dV2 + 0.5 * (d * Quud).sum(-1)
        Ks.insert(0, K)
        ds.insert(0, d)
    return torch.stack(Ks, 1), torch.stack(ds, 1), dV1, dV2


@pytest.mark.parametrize("edge", EDGES, ids=_edge_id)
def test_wide_edges_on_cpu(edge):
    """Each edge's wide inputs through every wrapper's plain dispatch (no
    launch): the output shapes, kernel B's plain version against kernel D's
    on B's own expansion, the SOC block present above m = 4."""
    n, m, N = edge
    w = bk.wide_inputs(torch.float64, torch.device("cpu"), 2, n, m, N=N)
    counts = _counts()
    got = riccati_fused.fused_expand_backward(*w["fused"],
                                              packed=w["packed"])
    assert [tuple(g.shape) for g in got] == [(2, N - 1, m, n), (2, N - 1, m),
                                             (2,), (2,)]
    _close(riccati.batched_riccati(*w["riccati"]), got, 1e-12)
    Xs, Us = rollout.batched_ls_rollout(*w["ladder"])
    assert Xs.shape == (2, 11, N, n) and Us.shape == (2, 11, N - 1, m)
    Xi, Ui = rollout.batched_ls_rollout(*w["init"])
    assert Xi.shape == (2, 1, N, n) and torch.isfinite(Xi).all()
    Xa, Ua, J = rollout_al.batched_ls_rollout_al(*w["ladder_al"])
    assert torch.equal(Xa, Xs) and torch.equal(Ua, Us) and J.shape == (2, 11)
    assert (m > 4) == any(c == 2 for _, _, c in w["packed"].meta)
    assert counts == _counts()


def test_rollout_work_counts_k_once():
    """Kernel A's bytes read each scenario's K once whatever L: the hand
    count at n = m = 64, B = 1024, N = 21, L = 11 (float32), and only the
    outputs grow with L."""
    Bt, N, n, m, L, N1 = 1024, 21, 64, 64, 11, 20
    hand = 4 * (N1 * (n * n + n * m + n)          # shared A, B, dd
                + Bt * N * n                        # Xbar
                + Bt * N1 * (2 * m + m * n)         # Ubar, d, K: once each
                + Bt * L * (N * n + N1 * m))        # Xs, Us written
    nbytes, flops = bk.rollout_work(Bt, N, n, m, L, False, 4)
    assert nbytes == hand
    assert nbytes - bk.rollout_work(Bt, N, n, m, 1, False, 4)[0] == (
        4 * Bt * (L - 1) * (N * n + N1 * m))
    assert flops == Bt * L * N1 * (2 * n + 2 * m * n + 2 * m + 2 * n * n
                                   + 2 * n * m)


@pytest.mark.parametrize("n,m,knot", [(45, 2, 309_621),
                                      (64, 64, 4_176_554)])
def test_riccati_work_counts_the_q_blocks_triangles(n, m, knot):
    """Kernel D's FLOPs per knot count the upper triangles of Qxx and Quu
    and Qux once, as kernel B's count does: the hand count, and D's count
    below B's at the same shape with no constraint row."""
    tri_n, tri_m = n * (n + 1) // 2, m * (m + 1) // 2
    hand = (2 * n * n * (n + m)                    # G = V [A | B]
            + (tri_n + tri_m + m * n) * 2 * n      # [A | B]' G
            + 2 * n * (n + m)                      # Qx, Qu
            + 2 * m ** 3 // 3 + 4 * (n + 1) * m * m
            + 3 * m * n * (n + 1) + 4 * m * n)     # Cholesky, solves, V
    assert hand == knot
    assert bk.riccati_work(1, 2, n, m, False, 4)[1] == knot
    assert bk.riccati_work(1, 2, n, m, False, 4)[1] < bk.fused_work(
        1, 1, n, m, 0, (), 4)[1]


def test_clamped_reference_is_plain_where_definite():
    """Where every pivot of Quu + reg I stays above the clamp, the tests'
    clamped recursion is the plain version (to round-off)."""
    w = bk.wide_inputs(torch.float64, torch.device("cpu"), 3, 33, 1, N=4)
    _close(_clamped_backward(*w["riccati"]),
           riccati.batched_riccati_reference(*w["riccati"]), 1e-12)


def _close_al(got, ref, tol, truth):
    """Kernel C's outputs: Xs and Us under ``_close``, J per lane against
    max(1, |J|) plus four times the plain version's own distance from the
    float64 answer."""
    _close(got[:2], ref[:2], tol, truth[:2])
    J, Jr, J6 = got[2].double(), ref[2].double(), truth[2].double()
    slack = 4.0 * (Jr - J6).abs()
    assert bool(((J - Jr).abs() <= tol * Jr.abs().clamp(min=1.0)
                 + slack).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("edge", EDGES, ids=_edge_id)
@pytest.mark.parametrize("Bt", [1, 1023])
def test_wide_edges_match_plain_versions(cuda, edge, Bt, dtype, tol):
    """B, D, A (L=11 and its init form) and C (L=11) at each edge against
    their plain versions, under ``_close`` (C's J per lane); one launch
    each (A two)."""
    from altro_tpu_torch.convert import tree_to
    n, m, N = edge
    w = bk.wide_inputs(dtype, cuda, Bt, n, m, N=N)

    def truth(fn, args):
        return fn(*tree_to(args, cuda, torch.float64))
    counts = _counts()
    _close(riccati_fused.fused_expand_backward(*w["fused"],
                                               packed=w["packed"]),
           w["fused_ref"], tol,
           truth(riccati_fused.fused_expand_backward_reference, w["fused"]))
    _close(riccati.batched_riccati(*w["riccati"]),
           riccati.batched_riccati_reference(*w["riccati"]), tol,
           truth(riccati.batched_riccati_reference, w["riccati"]))
    for key in ("ladder", "init"):
        _close(rollout.batched_ls_rollout(*w[key]),
               rollout.batched_ls_rollout_reference(*w[key]), tol,
               truth(rollout.batched_ls_rollout_reference, w[key]))
    _close_al(rollout_al.batched_ls_rollout_al(*w["ladder_al"],
                                               packed=w["packed"]),
              rollout_al.batched_ls_rollout_al_reference(*w["ladder_al"]),
              tol, truth(rollout_al.batched_ls_rollout_al_reference,
                         w["ladder_al"]))
    assert _counts() == (counts[0] + 2, counts[1] + 1, counts[2] + 1,
                         counts[3] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("L", [1, 32])
@pytest.mark.parametrize("Bt", [1, 44, 1023])
def test_wide_ladder_lengths(cuda, L, Bt, dtype, tol):
    """Kernels A's and C's wide bodies at n = m = 64 with ladders of 1 and
    32 rungs: the rung body (one rung, or one lane), the ladder body on
    chunks of rungs (44 lanes: three chunks of 11 on the H100's 132 SMs)
    and on whole ladders."""
    from altro_tpu_torch.convert import tree_to
    w = bk.wide_inputs(dtype, cuda, Bt, 64, 64, N=9)
    alphas = (tuple(0.5 ** i for i in range(L)),)
    args = w["ladder"][:-1] + alphas
    _close(rollout.batched_ls_rollout(*args),
           rollout.batched_ls_rollout_reference(*args), tol,
           rollout.batched_ls_rollout_reference(
               *tree_to(args, cuda, torch.float64)))
    args = w["ladder_al"][:-1] + alphas
    _close_al(rollout_al.batched_ls_rollout_al(*args, packed=w["packed"]),
              rollout_al.batched_ls_rollout_al_reference(*args), tol,
              rollout_al.batched_ls_rollout_al_reference(
                  *tree_to(args, cuda, torch.float64)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("Bt", [1, 1023])
def test_wide_per_lane_dynamics_at_64(cuda, Bt, dtype, tol):
    """Kernels A and D with per-lane dynamics at n = m = 64."""
    from altro_tpu_torch.convert import tree_to
    w = bk.wide_inputs(dtype, cuda, Bt, 64, 64, N=7)
    A, B, dd = w["ladder"][:3]
    rng = np.random.default_rng(4)
    scale = torch.as_tensor(1.0 + 0.1 * rng.standard_normal((Bt, 1, 1, 1)),
                            dtype=dtype, device=cuda)
    A = (A[None] * scale).contiguous()
    B = (B[None] * scale).contiguous()
    dd = dd[None].expand(Bt, -1, -1).contiguous()
    largs = (A, B, dd) + w["ladder"][3:]
    rargs = (A, B) + w["riccati"][2:]
    _close(rollout.batched_ls_rollout(*largs),
           rollout.batched_ls_rollout_reference(*largs), tol,
           rollout.batched_ls_rollout_reference(
               *tree_to(largs, cuda, torch.float64)))
    _close(riccati.batched_riccati(*rargs),
           riccati.batched_riccati_reference(*rargs), tol,
           riccati.batched_riccati_reference(
               *tree_to(rargs, cuda, torch.float64)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("widths", [(40, 3), (64, 64)],
                         ids=lambda w: f"n{w[0]}m{w[1]}")
def test_wide_nan_lane_stays_in_its_lane(cuda, widths, dtype, tol):
    """A NaN state (B), gradient (D) or gain (A, C) of lane 1 at knot 2
    gives the plain version's NaN pattern in that lane; the other lanes
    agree with the plain version (C on 64 lanes: its ladder body)."""
    w = bk.wide_inputs(dtype, cuda, 5, *widths, N=6)
    f = list(w["fused"])
    f[4] = f[4].clone()
    f[4][1, 2, 0] = float("nan")
    r = list(w["riccati"])
    r[2] = r[2].clone()
    r[2][1, 2, 0] = float("nan")
    a = list(w["ladder"])
    a[5] = a[5].clone()
    a[5][1, 2, 0, 0] = float("nan")
    keep = [0, 2, 3, 4]
    for got, ref in (
            (riccati_fused.fused_expand_backward(*f, packed=w["packed"]),
             riccati_fused.fused_expand_backward_reference(*f)),
            (riccati.batched_riccati(*r),
             riccati.batched_riccati_reference(*r)),
            (rollout.batched_ls_rollout(*a),
             rollout.batched_ls_rollout_reference(*a))):
        for g, rf in zip(got, ref):
            assert torch.equal(torch.isnan(g[1]), torch.isnan(rf[1]))
        assert any(bool(torch.isnan(rf[1]).any()) for rf in ref)
        _close([g[keep] for g in got], [rf[keep] for rf in ref], tol)
    w = bk.wide_inputs(dtype, cuda, 64, *widths, N=6)
    c = list(w["ladder_al"])
    c[7] = c[7].clone()
    c[7][1, 2, 0, 0] = float("nan")
    got = rollout_al.batched_ls_rollout_al(*c, packed=w["packed"])
    ref = rollout_al.batched_ls_rollout_al_reference(*c)
    for g, rf in zip(got, ref):
        assert torch.equal(torch.isnan(g[1]), torch.isnan(rf[1]))
    assert bool(torch.isnan(ref[2][1]).all())
    keep = [0] + list(range(2, 64))
    _close([g[keep] for g in got[:2]], [rf[keep] for rf in ref[:2]], tol)
    assert bool(((got[2][keep] - ref[2][keep]).abs().double()
                 <= tol * ref[2][keep].abs().double().clamp(min=1.0)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("n", [33, 45])
def test_wide_clamped_pivot_lane(cuda, n, dtype, tol):
    """Lane 1's Quu + reg I indefinite (reg = -1e6) at n = 33 or 45, m = 1,
    N = 2 (kernel B's entry body and its tiled body): kernels B and D clamp
    its pivot as the TPU kernels do (the plain version gives NaN), against
    the clamped recursion on B's own expansion; the other lanes as the plain
    version."""
    from altro_tpu_torch.constraints import DualState
    from altro_tpu_torch.convert import tree_to
    from altro_tpu_torch.solver.altro import _al_expansion_cd
    w = bk.wide_inputs(dtype, cuda, 3, n, 1, N=2)
    f = list(w["fused"])
    f[8] = f[8].clone()
    f[8][1] = -1e6
    cost, dynA, dynB, blocks, X, U, lams, rhos, reg = f

    def clamped(args):
        cost, dynA, dynB, blocks, X, U, lams, rhos, reg = args
        ex = _al_expansion_cd(cost, blocks,
                              tuple(DualState(lam=lam, rho=rho)
                                    for lam, rho in zip(lams, rhos)), X, U)
        return _clamped_backward(dynA, dynB, *ex, reg)
    ref = clamped(f)
    truth = clamped(tree_to(tuple(f), cuda, torch.float64))
    plain = riccati_fused.fused_expand_backward_reference(*f)
    assert bool(torch.isnan(plain[0][1]).all())
    assert float(ref[0][1].abs().max()) > 1e9   # the clamp took effect
    _close(riccati_fused.fused_expand_backward(*f, packed=w["packed"]), ref,
           tol, truth)
    r = list(w["riccati"])
    r[-1] = f[8]
    _close(riccati.batched_riccati(*r), _clamped_backward(*r), tol,
           _clamped_backward(*tree_to(tuple(r), cuda, torch.float64)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_wide_offset_views(cuda, dtype, tol):
    """Contiguous views that start one element past a 16-byte boundary,
    which the kernels must copy element by element: kernel B's R and kernel
    A's K at n = m = 64 (64 lanes: A's ladder body), against the plain
    versions."""
    import dataclasses

    from altro_tpu_torch.convert import tree_to
    w = bk.wide_inputs(dtype, cuda, 64, 64, 64, N=5)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        buf[1:] = t.reshape(-1)
        v = buf[1:].view(t.shape)
        assert v.is_contiguous() and v.data_ptr() % 16 != 0
        return v
    f = list(w["fused"])
    f[0] = dataclasses.replace(f[0], R=shifted(f[0].R))
    _close(riccati_fused.fused_expand_backward(*f, packed=w["packed"]),
           riccati_fused.fused_expand_backward_reference(*f), tol,
           riccati_fused.fused_expand_backward_reference(
               *tree_to(tuple(f), cuda, torch.float64)))
    a = list(w["ladder"])
    a[5] = shifted(a[5])
    _close(rollout.batched_ls_rollout(*a),
           rollout.batched_ls_rollout_reference(*a), tol,
           rollout.batched_ls_rollout_reference(
               *tree_to(tuple(a), cuda, torch.float64)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("widths", WIDTHS, ids=lambda w: f"n{w[0]}m{w[1]}")
@pytest.mark.parametrize("Bt", [1, 37])
def test_wide_kernels_match_plain_versions(cuda, widths, Bt, dtype, tol):
    """Relative to max(1, max|plain|), the tolerances of the group bodies'
    tests (float32 rounding through the recursions; float64 summation
    order); J per lane against max(1, |J|)."""
    from altro_tpu_torch.convert import tree_to
    w = bk.wide_inputs(dtype, cuda, Bt, *widths, N=9)

    def truth(fn, args):    # the plain version in float64 on the same data
        return fn(*tree_to(args, cuda, torch.float64))
    counts = (rollout.launch_count, riccati_fused.launch_count,
              rollout_al.launch_count, riccati.launch_count)
    _close(riccati_fused.fused_expand_backward(*w["fused"],
                                               packed=w["packed"]),
           w["fused_ref"], tol,
           truth(riccati_fused.fused_expand_backward_reference, w["fused"]))
    _close(riccati.batched_riccati(*w["riccati"]),
           riccati.batched_riccati_reference(*w["riccati"]), tol,
           truth(riccati.batched_riccati_reference, w["riccati"]))
    for key in ("ladder", "init"):
        _close(rollout.batched_ls_rollout(*w[key]),
               rollout.batched_ls_rollout_reference(*w[key]), tol,
               truth(rollout.batched_ls_rollout_reference, w[key]))
    Xs, Us, J = rollout_al.batched_ls_rollout_al(*w["ladder_al"],
                                                 packed=w["packed"])
    Xr, Ur, Jr = rollout_al.batched_ls_rollout_al_reference(*w["ladder_al"])
    X6, U6, J6 = truth(rollout_al.batched_ls_rollout_al_reference,
                       w["ladder_al"])
    torch.cuda.synchronize()
    _close((Xs, Us), (Xr, Ur), tol, (X6, U6))
    slack = 4.0 * (Jr.double() - J6).abs()
    assert bool(((J - Jr).abs().double()
                 <= tol * Jr.abs().double().clamp(min=1.0) + slack).all())
    assert (rollout.launch_count, riccati_fused.launch_count,
            rollout_al.launch_count, riccati.launch_count) == (
        counts[0] + 2, counts[1] + 1, counts[2] + 1, counts[3] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("per_lane", [False, True],
                         ids=["shared", "per_lane"])
def test_wide_ladder_per_lane_dynamics(cuda, per_lane):
    """Kernel A's and D's wide bodies with per-lane dynamics."""
    w = bk.wide_inputs(torch.float64, cuda, 5, 40, 3, N=7)
    A, B, dd = w["ladder"][:3]
    if per_lane:
        rng = np.random.default_rng(3)
        scale = torch.as_tensor(1.0 + 0.1 * rng.standard_normal((5, 1, 1,
                                                                 1)),
                                dtype=A.dtype, device=cuda)
        A = (A[None] * scale).contiguous()
        B = (B[None] * scale).contiguous()
        dd = dd[None].expand(5, -1, -1).contiguous()
    largs = (A, B, dd) + w["ladder"][3:]
    _close(rollout.batched_ls_rollout(*largs),
           rollout.batched_ls_rollout_reference(*largs), 1e-9)
    rargs = (A, B) + w["riccati"][2:]
    _close(riccati.batched_riccati(*rargs),
           riccati.batched_riccati_reference(*rargs), 1e-9)


def _ladder_switch(sms: int, L: int = 11) -> int:
    """The fewest lanes at which kernel C's (and A's) wide launcher gives
    a block kLadderRungs = 4 rungs or more on ``sms`` SMs: below it the
    rung body runs, from it the ladder body."""
    Bt = 1
    while -(-L // min(L, max(1, -(-sms // Bt)))) < 4:   # Lc = ceil(L / chunks)
        Bt += 1
    return Bt


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("side", [-1, 0, 1])
@pytest.mark.parametrize("widths", [(45, 2), (64, 64)],
                         ids=lambda w: f"n{w[0]}m{w[1]}")
def test_wide_al_body_switch(cuda, widths, side, dtype, tol):
    """Kernel C at L=11 on either side of its launcher's choice between the
    rung body and the ladder body (the lane count at which a block first
    carries four rungs on this card, and one lane fewer), and, one lane
    more, of its choice to put the cost rows in the dynamics rows' place
    in float32 at 64 x 64 (from more blocks than SMs), against its plain
    version."""
    from altro_tpu_torch.convert import tree_to
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    Bt = _ladder_switch(sms) + side
    w = bk.wide_inputs(dtype, cuda, Bt, *widths, N=7)
    args = w["ladder_al"]
    _close_al(rollout_al.batched_ls_rollout_al(*args, packed=w["packed"]),
              rollout_al.batched_ls_rollout_al_reference(*args), tol,
              rollout_al.batched_ls_rollout_al_reference(
                  *tree_to(args, cuda, torch.float64)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("Bt", [4, 256])
@pytest.mark.parametrize("widths", [(45, 2), (64, 64)],
                         ids=lambda w: f"n{w[0]}m{w[1]}")
def test_wide_al_grouped(cuda, widths, Bt, dtype, tol):
    """Kernel C with a group axis at a wide shape (G = 4 groups of
    dynamics, Bt / 4 lanes each: the rung body at 4 lanes, the ladder body
    at 256), against its plain version group by group."""
    from altro_tpu_torch.convert import tree_to
    w = bk.wide_inputs(dtype, cuda, Bt, *widths, N=7)
    cost, A, B, dd, blocks, X, U, K, d, lams, rho, alphas = w["ladder_al"]
    scale = torch.tensor([1.0, 0.9, 1.1, 0.95], dtype=dtype,
                         device=cuda)[:, None, None, None]
    args = (cost, (A[None] * scale).contiguous(),
            (B[None] * scale).contiguous(),
            (dd[None] * scale[..., 0]).contiguous(), blocks, X, U, K, d,
            lams, rho, alphas)
    _close_al(rollout_al.batched_ls_rollout_al(*args, packed=w["packed"],
                                               grouped=True),
              rollout_al.batched_ls_rollout_al_reference(*args,
                                                         grouped=True),
              tol, rollout_al.batched_ls_rollout_al_reference(
                  *tree_to(args, cuda, torch.float64), grouped=True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("m", [62, 63])
@pytest.mark.parametrize("Bt", [1, 300])
def test_wide_riccati_stage_switch(cuda, m, Bt, dtype, tol):
    """Kernel D's tiled body at n = 64 on either side of its launcher's
    choice of where [A | B] lies: in float64, m = 62 is the widest control
    whose stage fits beside the tail, m = 63 the first whose rows lie
    behind G (in float32 both have their own stage), against its plain
    version."""
    from altro_tpu_torch.convert import tree_to
    w = bk.wide_inputs(dtype, cuda, Bt, 64, m, N=5)
    _close(riccati.batched_riccati(*w["riccati"]),
           riccati.batched_riccati_reference(*w["riccati"]), tol,
           riccati.batched_riccati_reference(
               *tree_to(w["riccati"], cuda, torch.float64)))

@pytest.mark.cuda
@pytest.mark.parametrize("widths", [(65, 2), (12, 65)])
def test_wide_kernels_refuse_past_64(cuda, widths):
    """Each wrapper raises for n or m = 65, before any launch."""
    w = bk.wide_inputs(torch.float32, cuda, 2, *widths, N=4)
    counts = (rollout.launch_count, riccati_fused.launch_count,
              rollout_al.launch_count, riccati.launch_count)
    with pytest.raises(ValueError, match="n, m <= 64"):
        riccati_fused.fused_expand_backward(*w["fused"])
    with pytest.raises(ValueError, match="n, m <= 64"):
        riccati.batched_riccati(*w["riccati"])
    with pytest.raises(ValueError, match="n, m <= 64"):
        rollout.batched_ls_rollout(*w["ladder"])
    with pytest.raises(ValueError, match="n, m <= 64"):
        rollout_al.batched_ls_rollout_al(*w["ladder_al"])
    assert counts == (rollout.launch_count, riccati_fused.launch_count,
                      rollout_al.launch_count, riccati.launch_count)


def test_state_dim_n55_matches_jax():
    """The state_dim sweep's widest point (n = 55, m = 2, N = 21, seed 10,
    the sweep's options) in float64 on the CPU, the port's plain path
    against the JAX package: the first window's solve (equal iterations and
    status, X and U within 1e-8), then T = 3 steps of the lockstep loop
    against the dense ADMM QP (equal iterations and status on both sides,
    err_X and err_U within 1e-8)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import altro_tpu as at
    import altro_tpu_torch as tt
    from altro_tpu.models import random_linear as jrl
    from altro_tpu.mpc import run_mpc_lockstep as jlock
    from altro_tpu_torch.models import random_linear as trl
    from altro_tpu_torch.mpc import run_mpc_lockstep

    n, m, N, T = 55, 2, 21, 3
    kw = dict(cost_tolerance=1e-4, constraint_tolerance=1e-4,
              gradient_tolerance=1e-4, penalty_initial=1e3,
              penalty_scaling=100.0, reset_duals=False)
    built = []
    for rl in (jrl, trl):
        rng = np.random.default_rng(10)
        p = rl.gen_random_linear(rng, n, m, N + T + 2)
        X, U = rl.gen_trajectory(rng, p, N + T + 2)
        noise = rng.standard_normal((T, n))
        built.append((rl.gen_tracking_mpc(p, X, U, N), X, U, noise))
    (jp, jX, jU, noise), (tp, tX, tU, tnoise) = built
    np.testing.assert_array_equal(noise, tnoise)

    jsol = at.solve(jp, at.SolverOptions(**kw))
    sol = tt.solve(tt.Problem(
        dynamics=tp.dynamics, cost=tp.cost, constraints=tp.constraints,
        x0=tp.x0[None]), tt.SolverOptions(**kw))
    assert int(sol.stats.iterations[0]) == int(jsol.stats.iterations)
    assert int(sol.stats.status[0]) == int(jsol.stats.status)
    np.testing.assert_allclose(sol.X[0].numpy(), np.asarray(jsol.X),
                               atol=1e-8)
    np.testing.assert_allclose(sol.U[0].numpy(), np.asarray(jsol.U),
                               atol=1e-8)

    jres = jlock(jp, at.SolverOptions(**kw), jX, jU, jnp.asarray(noise),
                 qp_eps=1e-6)
    res = run_mpc_lockstep(tp, tt.SolverOptions(**kw), tX, tU,
                           torch.tensor(noise), qp_eps=1e-6)
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(jres.iters))
    np.testing.assert_array_equal(res.status.numpy(),
                                  np.asarray(jres.status))
    assert int(res.status.sum()) == 2 * T
    for name in ("err_X", "err_U"):
        np.testing.assert_allclose(getattr(res, name).numpy(),
                                   np.asarray(getattr(jres, name)),
                                   atol=1e-8)
