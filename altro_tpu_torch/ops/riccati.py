"""Batched Riccati backward pass from precomputed expansions: the CUDA
kernel ``csrc/riccati.cu`` and its plain PyTorch version.

The route for problems whose data differs between scenarios (per-lane
dynamics), where the fused expansion kernel (ops/riccati_fused.py) does not
apply: the solver forms the AL expansion in PyTorch and this pass turns it
into gains.

Dispatch: a CPU tensor goes to :func:`batched_riccati_reference`; a CUDA
tensor goes to the kernel, or raises on what the kernel does not take.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .rollout import MAX_DIM, _check_args

# Kernel launches since the last reset (see ops/rollout.py).
launch_count = 0


def batched_riccati_reference(A, B, lx, lu, lxx, luu, lux, reg) -> Tuple:
    """Plain PyTorch Riccati recursion (a Python loop over knots, batched
    over scenarios, ``torch.linalg.cholesky_ex`` per knot; a lane whose
    factorization fails gets NaN gains). Shapes as
    :func:`batched_riccati`."""
    from ..solver.altro import _backward_pass
    return _backward_pass(A, B, lx, lu, lxx, luu, lux, reg)


def batched_riccati(A, B, lx, lu, lxx, luu, lux, reg) -> Tuple:
    """Riccati backward pass over a batch of scenarios.

    A [N-1, n, n] and B [N-1, n, m] shared, or [Bt, N-1, ...] per
    scenario; lx [Bt, N, n], lu [Bt, N, m]; lxx [(Bt,) N, n, n],
    luu [(Bt,) N, m, m], lux [(Bt,) N, m, n] (shared Hessians are expanded
    to the batch for the kernel); reg [Bt]. The terminal control rows of
    lu, luu and lux are not read. Returns K [Bt, N-1, m, n], d [Bt, N-1, m]
    and dV1, dV2 [Bt]: a step of size alpha is expected to change the cost
    by alpha dV1 + alpha^2 dV2.
    """
    args = _prepare(A, B, lx, lu, lxx, luu, lux, reg)
    if lx.device.type == "cpu":
        return batched_riccati_reference(*args)
    return _launch(*args)


def _prepare(A, B, lx, lu, lxx, luu, lux, reg) -> Tuple:
    """The wrapper's work before the launch: the argument checks and, on a
    CUDA device, the kernel's arguments, shared Hessians expanded to the
    batch (a copy each). On the CPU the arguments as given."""
    Bt, N, n = lx.shape
    m = lu.shape[-1]
    per_lane = A.dim() == 4
    lead = (Bt, N - 1) if per_lane else (N - 1,)

    def hess(t, shape):          # a Hessian stack: per scenario or shared
        return (t, ((Bt,) if t.dim() == 4 else ()) + shape)

    expect = {"A": (A, lead + (n, n)), "B": (B, lead + (n, m)),
              "lx": (lx, (Bt, N, n)), "lu": (lu, (Bt, N, m)),
              "lxx": hess(lxx, (N, n, n)), "luu": hess(luu, (N, m, m)),
              "lux": hess(lux, (N, m, n)), "reg": (reg, (Bt,))}
    _check_args(expect, lx)
    if lx.device.type == "cpu":
        return A, B, lx, lu, lxx, luu, lux, reg
    if lx.device.type != "cuda":
        raise ValueError(f"unsupported device {lx.device}")
    if n > MAX_DIM or m > MAX_DIM:
        raise ValueError(f"Riccati kernel takes n, m <= {MAX_DIM}; got n={n}, "
                         f"m={m}")
    lxx, luu, lux = (t if t.dim() == 4
                     else t.expand((Bt,) + tuple(t.shape)).contiguous()
                     for t in (lxx, luu, lux))
    return A, B, lx, lu, lxx, luu, lux, reg


def _launch(A, B, lx, lu, lxx, luu, lux, reg) -> Tuple:
    """The kernel on :func:`_prepare`'s arguments (per-scenario Hessians on
    a CUDA device): allocates the outputs and launches."""
    global launch_count
    Bt, N, n = lx.shape
    m = lu.shape[-1]
    per_lane = A.dim() == 4
    kw = dict(dtype=lx.dtype, device=lx.device)
    K = torch.empty((Bt, N - 1, m, n), **kw)
    d = torch.empty((Bt, N - 1, m), **kw)
    dV1 = torch.empty((Bt,), **kw)
    dV2 = torch.empty((Bt,), **kw)
    lib = _build.library()
    fn = (lib.altro_riccati_f32 if lx.dtype == torch.float32
          else lib.altro_riccati_f64)
    stream = torch.cuda.current_stream(lx.device).cuda_stream
    err = fn(A.data_ptr(), B.data_ptr(), int(per_lane), lx.data_ptr(),
             lu.data_ptr(), lxx.data_ptr(), luu.data_ptr(), lux.data_ptr(),
             reg.data_ptr(), K.data_ptr(), d.data_ptr(), dV1.data_ptr(),
             dV2.data_ptr(), Bt, N, n, m, stream)
    _build.check(err, "altro_riccati")
    launch_count += 1
    return K, d, dV1, dV2
