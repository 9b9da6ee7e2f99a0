"""Closed-loop line-search ladder rollout fused with each rung's AL merit:
the CUDA kernel ``csrc/ls_rollout_al.cu`` and its plain PyTorch version.

For every scenario and rung alpha of the step-size ladder it runs the ladder
rollout of ``ops/rollout.py`` and returns the rung's merit

    J = cost(X, U) + sum_blocks sum_k mask_k |proj_polar(lam_k + rho_k c_k)|^2
                                          / (2 rho_k)

(the AL cost without the rung-independent -|lam|^2/(2 rho) term), with rho
the first block's penalty schedule [Bt, N], shared by every block as the
solver keeps it. The kernel sums the merit in double precision whatever
the tensors' dtype (the line search compares merits whose terms cancel) and
rounds J once; the plain version sums in the tensors' dtype.

Dispatch: a CPU tensor goes to :func:`batched_ls_rollout_al_reference`; a
CUDA tensor goes to the kernel, or raises on what the kernel does not take.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from . import _build
from .blocks import PackedBlocks, pack_blocks, table_args
from .rollout import (MAX_DIM, MAX_RUNGS, _check_args,
                      batched_ls_rollout_reference)

# Kernel launches since the last reset (see ops/rollout.py).
launch_count = 0


def batched_ls_rollout_al_reference(cost, dynA, dynB, dynd, blocks, Xbar,
                                    Ubar, K, d, lams, rho,
                                    alphas: Sequence[float]) -> Tuple:
    """Plain PyTorch version: the ladder rollout's knot loop, then the cost
    and the AL merit tail of every rung. Returns Xs [Bt, L, N, n],
    Us [Bt, L, N-1, m], J [Bt, L]."""
    from ..solver.altro import _al_merit_tail
    Xs, Us = batched_ls_rollout_reference(dynA, dynB, dynd, Xbar, Ubar, K,
                                          d, alphas)
    J = cost.total(Xs, Us) + _al_merit_tail(
        blocks, tuple(lam[:, None] for lam in lams), rho[:, None], Xs, Us)
    return Xs, Us, J


def batched_ls_rollout_al(cost, dynA, dynB, dynd, blocks, Xbar, Ubar, K, d,
                          lams, rho, alphas: Sequence[float],
                          packed: Optional[PackedBlocks] = None) -> Tuple:
    """Fused ladder rollout + AL merit.

    Shared: cost (QuadCost), dynA [N-1,n,n], dynB [N-1,n,m], dynd [N-1,n],
    blocks (tuple of ConicConstraint). Per scenario: Xbar [Bt,N,n],
    Ubar/d [Bt,N-1,m], K [Bt,N-1,m,n], lams tuple of [Bt,N,p], rho [Bt,N].
    ``packed`` (:func:`ops.blocks.pack_blocks` of ``blocks``) saves packing
    the constraint stacks on every call. Returns Xs [Bt,L,N,n],
    Us [Bt,L,N-1,m], J [Bt,L].
    """
    global launch_count
    alphas = tuple(float(a) for a in alphas)
    Bt, N, n = Xbar.shape
    m = Ubar.shape[-1]
    L = len(alphas)
    expect = {"Q": (cost.Q, (N, n, n)), "q": (cost.q, (N, n)),
              "R": (cost.R, (N, m, m)), "r": (cost.r, (N, m)),
              "H": (cost.H, (N, m, n)), "c": (cost.c, (N,)),
              "A": (dynA, (N - 1, n, n)), "B": (dynB, (N - 1, n, m)),
              "dd": (dynd, (N - 1, n)), "Xbar": (Xbar, (Bt, N, n)),
              "Ubar": (Ubar, (Bt, N - 1, m)), "K": (K, (Bt, N - 1, m, n)),
              "d": (d, (Bt, N - 1, m)), "rho": (rho, (Bt, N))}
    for i, (c, lam) in enumerate(zip(blocks, lams)):
        expect.update({f"Cx{i}": (c.Cx, (N, c.p, n)),
                       f"Cu{i}": (c.Cu, (N, c.p, m)),
                       f"b{i}": (c.b, (N, c.p)), f"mask{i}": (c.mask, (N,)),
                       f"lam{i}": (lam, (Bt, N, c.p))})
    _check_args(expect, Xbar)
    if Xbar.device.type == "cpu":
        return batched_ls_rollout_al_reference(cost, dynA, dynB, dynd,
                                               blocks, Xbar, Ubar, K, d,
                                               lams, rho, alphas)
    if Xbar.device.type != "cuda":
        raise ValueError(f"unsupported device {Xbar.device}")
    if not (1 <= L <= MAX_RUNGS and n <= MAX_DIM and m <= MAX_DIM):
        raise ValueError(f"fused ladder kernel takes L <= {MAX_RUNGS}, "
                         f"n, m <= {MAX_DIM}; got L={L}, n={n}, m={m}")
    if packed is None:
        packed = pack_blocks(blocks, N, n, m, Xbar)

    kw = dict(dtype=Xbar.dtype, device=Xbar.device)
    Xs = torch.empty((Bt, L, N, n), **kw)
    Us = torch.empty((Bt, L, N - 1, m), **kw)
    J = torch.empty((Bt, L), **kw)
    lib = _build.library()
    fn = (lib.altro_ls_rollout_al_f32 if Xbar.dtype == torch.float32
          else lib.altro_ls_rollout_al_f64)
    nb, meta, lam_ptrs = table_args(packed, lams)
    ladder = (ctypes.c_double * L)(*alphas)
    stream = torch.cuda.current_stream(Xbar.device).cuda_stream
    err = fn(cost.Q.data_ptr(), cost.q.data_ptr(), cost.R.data_ptr(),
             cost.r.data_ptr(), cost.H.data_ptr(), cost.c.data_ptr(),
             dynA.data_ptr(), dynB.data_ptr(), dynd.data_ptr(),
             packed.Cx.data_ptr(), packed.Cu.data_ptr(), packed.b.data_ptr(),
             packed.mask.data_ptr(), nb, meta, lam_ptrs, Xbar.data_ptr(),
             Ubar.data_ptr(), K.data_ptr(), d.data_ptr(), rho.data_ptr(),
             ctypes.cast(ladder, ctypes.c_void_p), L, Xs.data_ptr(),
             Us.data_ptr(), J.data_ptr(), Bt, N, n, m, packed.P, stream)
    _build.check(err, "altro_ls_rollout_al")
    launch_count += 1
    return Xs, Us, J
