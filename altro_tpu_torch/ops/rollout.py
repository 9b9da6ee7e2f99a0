"""Closed-loop line-search ladder rollout: the CUDA kernel
``csrc/ls_rollout.cu`` and its plain PyTorch version.

For every scenario and every rung alpha of the step-size ladder:

    u = ubar + alpha d + K (x - xbar);   x+ = A x + B u + dd,   x0 = xbar0

Dispatch: a CPU tensor goes to :func:`batched_ls_rollout_reference`; a CUDA
tensor goes to the kernel, or raises on what the kernel does not take.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import _build

# Kernel launches since the last reset (a plain counter: a run sets it to 0
# and reads it back to show that it went through the kernel).
launch_count = 0

MAX_RUNGS = 32
MAX_DIM = 32


def batched_ls_rollout_reference(A, B, dd, Xbar, Ubar, K, d,
                                 alphas: Sequence[float]) -> Tuple:
    """Plain PyTorch ladder rollout (a Python loop over knots, batched over
    scenarios and rungs).

    A [N-1, n, n] or [Bt, N-1, n, n], B [(Bt,) N-1, n, m], dd [(Bt,) N-1, n]
    (shared or per scenario), Xbar [Bt, N, n], Ubar/d [Bt, N-1, m],
    K [Bt, N-1, m, n]. Returns Xs [Bt, L, N, n], Us [Bt, L, N-1, m].
    """
    N1 = Ubar.shape[1]
    al = torch.as_tensor(tuple(alphas), dtype=Xbar.dtype,
                         device=Xbar.device)[None, :, None]       # [1, L, 1]
    per_lane = A.dim() == 4
    x = Xbar[:, None, 0, :].expand(-1, al.shape[1], -1)           # [Bt, L, n]
    xs, us = [x], []
    for k in range(N1):
        Ak, Bk, ddk = ((A[:, k], B[:, k], dd[:, k]) if per_lane
                       else (A[k], B[k], dd[k]))
        dx = x - Xbar[:, None, k, :]
        u = (Ubar[:, None, k, :] + al * d[:, None, k, :]
             + torch.einsum("bij,blj->bli", K[:, k], dx))
        if per_lane:
            x = (torch.einsum("bij,blj->bli", Ak, x)
                 + torch.einsum("bij,blj->bli", Bk, u)) + ddk[:, None, :]
        else:
            # one small product per scenario (bmm), so that a lane's bits
            # do not depend on the batch it runs in (straggler compaction
            # gathers lanes): an einsum folds the batch into the rows of
            # one product, whose rounding depends on the batch size
            Bt = x.shape[0]
            x = (torch.bmm(x, Ak.mT.expand(Bt, -1, -1))
                 + torch.bmm(u, Bk.mT.expand(Bt, -1, -1))) + ddk
        xs.append(x)
        us.append(u)
    return torch.stack(xs, dim=2), torch.stack(us, dim=2)


def batched_ls_rollout(A, B, dd, Xbar, Ubar, K, d,
                       alphas: Sequence[float]) -> Tuple:
    """Ladder rollout; see :func:`batched_ls_rollout_reference` for the
    shapes. CUDA tensors run the hand-written kernel."""
    global launch_count
    alphas = tuple(float(a) for a in alphas)
    Bt, N, n = Xbar.shape
    m = Ubar.shape[-1]
    L = len(alphas)
    per_lane = A.dim() == 4
    lead = (Bt, N - 1) if per_lane else (N - 1,)
    expect = {"A": (A, lead + (n, n)), "B": (B, lead + (n, m)),
              "dd": (dd, lead + (n,)), "Xbar": (Xbar, (Bt, N, n)),
              "Ubar": (Ubar, (Bt, N - 1, m)), "K": (K, (Bt, N - 1, m, n)),
              "d": (d, (Bt, N - 1, m))}
    _check_args(expect, Xbar)
    if Xbar.device.type == "cpu":
        return batched_ls_rollout_reference(A, B, dd, Xbar, Ubar, K, d,
                                            alphas)
    if Xbar.device.type != "cuda":
        raise ValueError(f"unsupported device {Xbar.device}")
    if not (1 <= L <= MAX_RUNGS and n <= MAX_DIM and m <= MAX_DIM):
        raise ValueError(f"ladder rollout kernel takes L <= {MAX_RUNGS}, "
                         f"n, m <= {MAX_DIM}; got L={L}, n={n}, m={m}")
    Xs = torch.empty((Bt, L, N, n), dtype=Xbar.dtype, device=Xbar.device)
    Us = torch.empty((Bt, L, N - 1, m), dtype=Xbar.dtype, device=Xbar.device)
    lib = _build.library()
    fn = (lib.altro_ls_rollout_f32 if Xbar.dtype == torch.float32
          else lib.altro_ls_rollout_f64)
    ladder = (ctypes.c_double * L)(*alphas)
    stream = torch.cuda.current_stream(Xbar.device).cuda_stream
    err = fn(A.data_ptr(), B.data_ptr(), dd.data_ptr(), int(per_lane),
             Xbar.data_ptr(), Ubar.data_ptr(), K.data_ptr(), d.data_ptr(),
             ctypes.cast(ladder, ctypes.c_void_p), L, Xs.data_ptr(),
             Us.data_ptr(), Bt, N, n, m, stream)
    _build.check(err, "altro_ls_rollout")
    launch_count += 1
    return Xs, Us


def _check_args(expect: dict, ref: torch.Tensor) -> None:
    """Shape, dtype, device and contiguity checks shared by the kernel
    wrappers."""
    if ref.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernels take float32 or float64, got {ref.dtype}")
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
        if t.dtype != ref.dtype or t.device != ref.device:
            raise TypeError(f"{name}: {t.dtype} on {t.device}, expected "
                            f"{ref.dtype} on {ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
