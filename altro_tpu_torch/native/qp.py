"""ctypes binding of the port's copy of the native C++ oracles: the dense
ADMM QP and conic solvers (qp_solver.cpp), the knot-structured ADMM
(knot_solver.cpp) and the AL-iLQR (ilqr_solver.cpp), the same sources as
the JAX package's ``altro_tpu/native``.

The library is compiled with g++ at first use, with the JAX package's
flags, into ``build/altro_tpu_torch/native/`` under the repository root
(listed in .gitignore), named by a hash of the sources, the flags and the
host, so a fresh checkout builds from its own sources and a stale build,
or one for another host's CPU, is never loaded. A failed build raises with
the compiler's output; nothing falls back to another solver. The inputs
are numpy arrays, or the port's tensors (``_np``: detached, on the CPU, in
float64); a knot program or a problem with a lane axis gives its lane
``lane``. No external dependencies: a plain C ABI and ctypes.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import platform
import subprocess
import tempfile
from typing import Optional, Sequence, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRCS = (os.path.join(_DIR, "qp_solver.cpp"),
         os.path.join(_DIR, "knot_solver.cpp"),
         os.path.join(_DIR, "ilqr_solver.cpp"))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "altro_tpu_torch", "native")
CXX = "g++"
_lib = None


# associative-math (NOT -ffast-math: the solvers rely on +-inf bounds and
# std::isfinite guards, so -ffinite-math-only is out) lets g++ vectorize
# the gemv reductions — measured 4.25 -> 17 GF/s on the 24-wide knot-ADMM
# rows (AVX-512 host)
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
          "-fassociative-math", "-fno-trapping-math", "-fno-math-errno",
          "-fno-signed-zeros")


def lib_path() -> str:
    """Where the library of the current sources and flags lies, for this
    host (``-march=native`` builds for the host's CPU: a checkout copied to
    another machine builds its own)."""
    h = hashlib.sha256()
    for src in _SRCS:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(_FLAGS).encode())
    h.update(f"{platform.node()} {platform.machine()}".encode())
    return os.path.join(BUILD_DIR,
                        f"libaltro_tpu_torch_native_{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    """Compile the sources into ``path``; raise with the compiler's output
    on failure."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    # build to a temporary name, then rename: atomic against concurrent
    # builders
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(path))
    os.close(fd)
    try:
        proc = subprocess.run([CXX, *_FLAGS, *_SRCS, "-o", tmp],
                              capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"native oracles: cannot run {CXX}: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"native oracles: {CXX} failed:\n{proc.stderr}")
    os.replace(tmp, path)


def load():
    """Build (at first use) and load the library; raises if g++ fails."""
    global _lib
    if _lib is not None:
        return
    path = lib_path()
    if not os.path.exists(path):
        _build(path)
    lib = ctypes.CDLL(path)
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.altro_tpu_qp_solve.restype = ctypes.c_int
    lib.altro_tpu_qp_solve.argtypes = [
        ctypes.c_int, ctypes.c_int,
        dp, dp, dp, dp, dp, ctypes.c_double, ctypes.c_int,
        dp, dp, ip, dp, dp,
    ]
    lib.altro_tpu_conic_solve.restype = ctypes.c_int
    lib.altro_tpu_conic_solve.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        dp, dp, dp, dp, ip, ip, ctypes.c_double, ctypes.c_int,
        dp, dp, ip, dp, dp,
    ]
    lib.altro_tpu_knot_setup.restype = ctypes.c_void_p
    lib.altro_tpu_knot_setup.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ip, ip,
        dp, dp, dp, dp, dp, dp, dp, dp, dp, dp, dp, dp,
        ctypes.c_double, ctypes.c_int,
    ]
    lib.altro_tpu_knot_update.restype = ctypes.c_int
    lib.altro_tpu_knot_update.argtypes = [
        ctypes.c_void_p, dp, dp, dp, dp, dp, dp, dp, dp, dp, dp, dp, dp,
    ]
    lib.altro_tpu_knot_solve.restype = ctypes.c_int
    lib.altro_tpu_knot_solve.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, dp, dp, ip, dp, dp,
    ]
    lib.altro_tpu_knot_reset_iterate.restype = None
    lib.altro_tpu_knot_reset_iterate.argtypes = [ctypes.c_void_p]
    lib.altro_tpu_knot_free.restype = None
    lib.altro_tpu_knot_free.argtypes = [ctypes.c_void_p]
    lib.altro_tpu_ilqr_setup.restype = ctypes.c_void_p
    lib.altro_tpu_ilqr_setup.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ip, ip,
        dp, dp, dp, dp, dp, dp, dp, dp, dp, dp, dp, dp, dp, dp,
    ]
    lib.altro_tpu_ilqr_update.restype = ctypes.c_int
    lib.altro_tpu_ilqr_update.argtypes = [
        ctypes.c_void_p, dp, dp, dp, dp, dp, dp, dp, dp, dp, dp, dp, dp, dp,
    ]
    lib.altro_tpu_ilqr_solve.restype = ctypes.c_int
    lib.altro_tpu_ilqr_solve.argtypes = [
        ctypes.c_void_p, dp, ip, dp, dp, dp, dp, dp, dp,
        ip, ip, dp, dp,
    ]
    lib.altro_tpu_ilqr_free.restype = None
    lib.altro_tpu_ilqr_free.argtypes = [ctypes.c_void_p]
    _lib = lib


def available() -> bool:
    """Whether the library builds and loads here (a report: no caller
    chooses another solver by it)."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def _np(a, lane: Optional[int] = None) -> np.ndarray:
    """A numpy float64 copy of a tensor (detached, on the CPU) or an array;
    ``lane``: that lane of a leading lane axis."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    a = np.asarray(a, np.float64)
    return np.ascontiguousarray(a if lane is None else a[lane])


@dataclasses.dataclass
class NativeQPSolution:
    x: np.ndarray
    y: np.ndarray
    iterations: int
    r_prim: float
    r_dual: float
    status: int  # 1 converged


def solve_qp(P, q, A, l, u, eps_abs: float = 1e-6,
             max_iter: int = 20000) -> NativeQPSolution:
    load()
    P, q, A = _np(P), _np(q), _np(A)
    l = np.ascontiguousarray(np.nan_to_num(_np(l), neginf=-1e30))
    u = np.ascontiguousarray(np.nan_to_num(_np(u), posinf=1e30))
    nn, mm = P.shape[0], A.shape[0]
    x = np.zeros(nn)
    y = np.zeros(mm)
    iters = ctypes.c_int(0)
    rp = ctypes.c_double(0)
    rd = ctypes.c_double(0)
    dp = ctypes.POINTER(ctypes.c_double)
    ret = _lib.altro_tpu_qp_solve(
        nn, mm, P.ctypes.data_as(dp), q.ctypes.data_as(dp),
        A.ctypes.data_as(dp), l.ctypes.data_as(dp), u.ctypes.data_as(dp),
        eps_abs, max_iter, x.ctypes.data_as(dp), y.ctypes.data_as(dp),
        ctypes.byref(iters), ctypes.byref(rp), ctypes.byref(rd))
    if ret < 0:
        raise RuntimeError("native QP solver: factorization failed")
    return NativeQPSolution(x=x, y=y, iterations=iters.value,
                            r_prim=rp.value, r_dual=rd.value,
                            status=1 if ret == 0 else 0)


_CONE_CODE = {"zero": 0, "nonpos": 1, "soc": 2}


def solve_conic(P, q, A, b, segments: Sequence[Tuple],
                eps_abs: float = 1e-6,
                max_iter: int = 50000) -> NativeQPSolution:
    """Solve min 0.5 x'Px + q'x s.t. Ax + s = b, s in K — the BatchConic
    program class (transcribe.to_batch_conic; the ECOS/COSMO oracle role of
    run_simple_rocket.jl:156-188). ``segments`` is the BatchConic
    ((cone, length), ...) product spec in row order."""
    load()
    P, q, A, b = _np(P), _np(q), _np(A), _np(b)
    nn, mm = P.shape[0], A.shape[0]
    seg_type = np.ascontiguousarray(
        [_CONE_CODE[str(c)] for c, _ in segments], np.int32)
    seg_len = np.ascontiguousarray([p for _, p in segments], np.int32)
    if int(seg_len.sum()) != mm:
        raise ValueError("segment lengths must cover all constraint rows")
    x = np.zeros(nn)
    y = np.zeros(mm)
    iters = ctypes.c_int(0)
    rp = ctypes.c_double(0)
    rd = ctypes.c_double(0)
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int)
    ret = _lib.altro_tpu_conic_solve(
        nn, mm, len(segments), P.ctypes.data_as(dp), q.ctypes.data_as(dp),
        A.ctypes.data_as(dp), b.ctypes.data_as(dp),
        seg_type.ctypes.data_as(ip), seg_len.ctypes.data_as(ip),
        eps_abs, max_iter, x.ctypes.data_as(dp), y.ctypes.data_as(dp),
        ctypes.byref(iters), ctypes.byref(rp), ctypes.byref(rd))
    if ret == -1:
        raise RuntimeError("native conic solver: factorization failed")
    if ret == -2:
        raise ValueError("native conic solver: bad segment spec")
    return NativeQPSolution(x=x, y=y, iterations=iters.value,
                            r_prim=rp.value, r_dual=rd.value,
                            status=1 if ret == 0 else 0)


def conic_arrays(data, lane: int = 0):
    """(P, q, A, b, segments) of lane ``lane`` of a batched conic program
    (``transcribe.BatchConic``), for :func:`solve_conic`."""
    return (_np(data.P, lane), _np(data.q, lane), _np(data.A, lane),
            _np(data.b, lane), data.segments)


class NativeKnotWork:
    """Workspace handle for the native knot-structured ADMM
    (knot_solver.cpp) — the C twin of solver/knot_admm.py and the
    timing-grade OSQP/ECOS-role CPU backend (the reference times native C
    solvers: OSQPParams.jl:127-162, ecos_solver.jl). Pattern parity:
    setup-once (Ruiz scalings fixed), per-solve in-place value update +
    banded refactor, zero-start solve with adaptive rho.

    Build from a lane of a ``solver.knot_admm.KnotQP`` via
    :func:`knot_setup`.
    """

    def __init__(self, handle, dims, cones):
        self._h = handle
        self.N, self.n, self.m = dims
        self.cones = cones

    def __del__(self):
        h = getattr(self, "_h", None)
        if h and _lib is not None:
            _lib.altro_tpu_knot_free(h)
            self._h = None

    def update(self, kqp, lane: int = 0) -> None:
        """New problem values (same structure): reuse scalings, refactor."""
        a = _knot_arrays(kqp, lane)
        dp = ctypes.POINTER(ctypes.c_double)
        ret = _lib.altro_tpu_knot_update(
            self._h, *(arr.ctypes.data_as(dp) for arr in a))
        if ret != 0:
            raise RuntimeError("native knot ADMM: refactor failed")

    def reset_iterate(self) -> None:
        """Drop the stored warm-start iterate (next ``solve(warm=True)``
        zero-starts) while keeping the adapted rho + factorization. Timing
        harnesses call this after a compile warm-up solve so the first
        timed solve doesn't resume the converged iterate of an identical
        instance."""
        _lib.altro_tpu_knot_reset_iterate(self._h)

    def solve(self, eps_abs: float = 1e-5, eps_rel: Optional[float] = None,
              max_iter: int = 4000, check_every: int = 5,
              warm: bool = False, polish: bool = False
              ) -> "NativeKnotSolution":
        """``warm=True`` resumes from the previous solve's iterate (the
        OSQP warm_start=true pattern, OSQPParams.jl:128) with the splitting
        variable re-projected against the updated bounds. ``polish=True``
        runs an OSQP-style active-set polish after convergence (box/
        equality rows only; no-op for SOC workspaces): the active rows
        become hard equalities solved exactly through the banded factor,
        adopted only if BOTH unscaled residuals improve — so a converged
        loose-tolerance solve returns a near-machine-accuracy solution."""
        N, n, m = self.N, self.n, self.m
        X = np.zeros((N, n))
        U = np.zeros((N - 1, m))
        iters = ctypes.c_int(0)
        rp = ctypes.c_double(0)
        rd = ctypes.c_double(0)
        dp = ctypes.POINTER(ctypes.c_double)
        ret = _lib.altro_tpu_knot_solve(
            self._h, eps_abs, eps_abs if eps_rel is None else eps_rel,
            max_iter, check_every, 1 if warm else 0, 1 if polish else 0,
            X.ctypes.data_as(dp),
            U.ctypes.data_as(dp), ctypes.byref(iters), ctypes.byref(rp),
            ctypes.byref(rd))
        return NativeKnotSolution(X=X, U=U, iterations=iters.value,
                                  r_prim=rp.value, r_dual=rd.value,
                                  status=ret)


@dataclasses.dataclass
class NativeKnotSolution:
    X: np.ndarray
    U: np.ndarray
    iterations: int
    r_prim: float
    r_dual: float
    status: int  # 1 converged


def _knot_arrays(kqp, lane: int = 0):
    """Lane ``lane`` of a KnotQP -> the 12 contiguous f64 buffers the C ABI
    takes."""
    def blocks(stacks):
        return (np.ascontiguousarray(np.concatenate(
            [_np(b, lane).reshape(-1) for b in stacks]))
            if stacks else np.zeros(0))
    return (_np(kqp.Q, lane), _np(kqp.q, lane), _np(kqp.R, lane),
            _np(kqp.r, lane), _np(kqp.A, lane), _np(kqp.B, lane),
            _np(kqp.d, lane), _np(kqp.x0, lane), blocks(kqp.Cx),
            blocks(kqp.Cu), blocks(kqp.l), blocks(kqp.u))


def knot_setup(kqp, rho: float = 0.1, ruiz_iters: int = 10,
               lane: int = 0) -> NativeKnotWork:
    """Build a native workspace from lane ``lane`` of a
    ``solver.knot_admm.KnotQP``."""
    load()
    N, n, m = (int(v) for v in kqp.dims)
    p_blk = np.ascontiguousarray([int(b.shape[-2]) for b in kqp.Cx],
                                 np.int32)
    cones = kqp.cones or tuple("nonpos" for _ in kqp.Cx)
    cone_blk = np.ascontiguousarray(
        [_CONE_CODE[str(cn)] for cn in cones], np.int32)
    a = _knot_arrays(kqp, lane)
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int)
    h = _lib.altro_tpu_knot_setup(
        N, n, m, len(p_blk), p_blk.ctypes.data_as(ip),
        cone_blk.ctypes.data_as(ip),
        *(arr.ctypes.data_as(dp) for arr in a), rho, ruiz_iters)
    if not h:
        raise RuntimeError("native knot ADMM: setup factorization failed")
    return NativeKnotWork(h, (N, n, m), tuple(str(cn) for cn in cones))


# ----------------------------------------------------------------------------
# Native AL-iLQR (ilqr_solver.cpp) — CPU-latency twin of solver/altro.py
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class NativeIlqrSolution:
    X: np.ndarray
    U: np.ndarray
    lam: np.ndarray          # [N, ptot] concatenated block multipliers
    iterations: int
    outer_iterations: int
    viol: float
    gradient: float
    status: int              # 1 converged


def _ilqr_opts_arrays(opts) -> Tuple[np.ndarray, np.ndarray]:
    """SolverOptions -> the (double[14], int[5]) ABI option blocks."""
    od = np.ascontiguousarray([
        float(opts.cost_tolerance), float(opts.gradient_tolerance),
        float(opts.constraint_tolerance), float(opts.penalty_initial),
        float(opts.penalty_scaling), float(opts.penalty_max),
        float(opts.reg_initial), float(opts.reg_min), float(opts.reg_max),
        float(opts.reg_increase), float(opts.reg_decrease),
        float(opts.ls_decrease), float(opts.ls_min_ratio),
        float(opts.early_exact_tol)], np.float64)
    oi = np.ascontiguousarray([
        int(opts.iterations_outer), int(opts.iterations_inner),
        int(opts.iterations_linesearch), 1 if opts.reset_duals else 0,
        1 if opts.reset_penalties else 0], np.int32)
    return od, oi


def _ilqr_prob_arrays(prob, lane: int = 0):
    """Problem -> the 14 contiguous f64 value buffers of the iLQR ABI; per
    lane dynamics and a batched x0 give their lane ``lane``."""
    cost, dyn = prob.cost, prob.dynamics

    def of(a, rank):  # a shared stack, or lane ``lane`` of a batched one
        return _np(a, lane if a.dim() > rank else None)

    def blocks(field):
        return (np.ascontiguousarray(np.concatenate(
            [_np(getattr(b, field)).reshape(-1) for b in prob.constraints]))
            if prob.constraints else np.zeros(0))
    return (_np(cost.Q), _np(cost.q), _np(cost.R), _np(cost.r), _np(cost.H),
            _np(cost.c), of(dyn.A, 3), of(dyn.B, 3), of(dyn.d, 2),
            of(prob.x0, 1), blocks("Cx"), blocks("Cu"), blocks("b"),
            blocks("mask"))


class NativeIlqrWork:
    """Workspace for the native AL-iLQR (ilqr_solver.cpp): the CPU-latency
    counterpart of :func:`altro_tpu_torch.solve` for LTV problems with
    affine conic blocks — the role Altro.jl's compiled native solver plays
    in the reference's single-core latency numbers
    (figures/horizon_comp.tikz; ``benchmark_solve!`` times ``solve!`` only,
    random_linear_problem.jl:161).

    Pattern: ``setup`` once (structure fixed), ``update`` problem values per
    MPC step, ``solve`` with warm primal/dual starts. The solve's iterate
    sequence mirrors the solver's flat AL+iLQR loop.
    """

    def __init__(self, handle, dims, ptot, mask0=None):
        self._h = handle
        self.N, self.n, self.m = dims
        self.ptot = ptot
        self._mask0 = None if mask0 is None else np.asarray(mask0)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h and _lib is not None:
            _lib.altro_tpu_ilqr_free(h)
            self._h = None

    def update(self, prob, lane: int = 0) -> None:
        a = _ilqr_prob_arrays(prob, lane)
        # mask is structural (fixed at setup); the native side never re-reads
        # it, so a caller whose per-step problem changes block masks would
        # get silently wrong solutions — reject that loudly instead
        if self._mask0 is not None and not np.array_equal(a[13], self._mask0):
            raise ValueError(
                "native iLQR: constraint masks changed since setup — masks "
                "are structural (fixed at setup); rebuild with ilqr_setup")
        dp = ctypes.POINTER(ctypes.c_double)
        ret = _lib.altro_tpu_ilqr_update(
            self._h, *(arr.ctypes.data_as(dp) for arr in a[:13]))
        if ret != 0:
            raise RuntimeError("native iLQR: update failed")

    def solve(self, opts, U0=None, lam0=None, X0=None) -> NativeIlqrSolution:
        N, n, m = self.N, self.n, self.m
        od, oi = _ilqr_opts_arrays(opts)
        X = np.zeros((N, n))
        U = np.zeros((N - 1, m))
        lam = np.zeros((N, max(self.ptot, 1)))
        dp = ctypes.POINTER(ctypes.c_double)
        ip = ctypes.POINTER(ctypes.c_int)

        def opt(arr):
            if arr is None:
                return ctypes.cast(None, dp)
            a = _np(arr)
            self._keep = getattr(self, "_keep", []) or []
            self._keep.append(a)  # keep alive through the call
            return a.ctypes.data_as(dp)

        self._keep = []
        iters = ctypes.c_int(0)
        rounds = ctypes.c_int(0)
        viol = ctypes.c_double(0)
        grad = ctypes.c_double(0)
        ret = _lib.altro_tpu_ilqr_solve(
            self._h, od.ctypes.data_as(dp), oi.ctypes.data_as(ip),
            opt(U0), opt(lam0), opt(X0), X.ctypes.data_as(dp),
            U.ctypes.data_as(dp), lam.ctypes.data_as(dp),
            ctypes.byref(iters), ctypes.byref(rounds), ctypes.byref(viol),
            ctypes.byref(grad))
        self._keep = []
        return NativeIlqrSolution(X=X, U=U, lam=lam,
                                  iterations=iters.value,
                                  outer_iterations=rounds.value,
                                  viol=viol.value, gradient=grad.value,
                                  status=ret)


def ilqr_setup(prob, lane: int = 0) -> NativeIlqrWork:
    """Build a native AL-iLQR workspace from lane ``lane`` of an
    :class:`altro_tpu_torch.problem.Problem` with LTV dynamics and affine
    :class:`~altro_tpu_torch.constraints.ConicConstraint` blocks."""
    load()
    from ..dynamics import LTVDynamics

    if not isinstance(prob.dynamics, LTVDynamics):
        raise TypeError("native iLQR requires LTVDynamics")
    for b in prob.constraints:
        if not getattr(b, "is_affine", False):
            raise TypeError("native iLQR requires affine constraint blocks")
    N, n, m = prob.N, prob.n, prob.m
    p_blk = np.ascontiguousarray([int(b.p) for b in prob.constraints],
                                 np.int32)
    cone_blk = np.ascontiguousarray(
        [_CONE_CODE[str(b.cone)] for b in prob.constraints], np.int32)
    a = _ilqr_prob_arrays(prob, lane)
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int)
    h = _lib.altro_tpu_ilqr_setup(
        N, n, m, len(p_blk), p_blk.ctypes.data_as(ip),
        cone_blk.ctypes.data_as(ip),
        *(arr.ctypes.data_as(dp) for arr in a))
    if not h:
        raise RuntimeError("native iLQR: setup failed")
    return NativeIlqrWork(h, (N, n, m), int(p_blk.sum()), mask0=a[13])
