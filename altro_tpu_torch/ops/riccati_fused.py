"""AL expansion fused into the Riccati backward pass: the CUDA kernel
``csrc/riccati_fused.cu`` and its plain PyTorch version.

The shared problem data (cost stacks, dynamics A/B, constraint rows) has no
batch axis, except that the dynamics may carry a group axis (``grouped``:
A/B [G, N-1, ...], Bt / G contiguous scenarios to a group); the
per-scenario inputs are x, u, lambda, rho and reg. Every
block's penalty follows one schedule (the kernel reads the first block's
rho), as the solver keeps it. ZERO, NONPOS and SOC blocks are taken; an SOC
block's curvature is its polar projection's diagonal plus two rank-1 terms.

Dispatch: a CPU tensor goes to :func:`fused_expand_backward_reference`; a
CUDA tensor goes to the kernel, or raises on what the kernel does not take.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .blocks import PackedBlocks, pack_blocks, table_args
from .rollout import MAX_DIM, _check_args, check_groups, per_group

# Kernel launches since the last reset (see ops/rollout.py).
launch_count = 0


def fused_expand_backward_reference(cost, dynA, dynB, blocks, X, U, lams,
                                    rhos, reg, grouped: bool = False
                                    ) -> Tuple:
    """Plain PyTorch expansion + Riccati recursion (a Python loop over
    knots, batched over scenarios, ``torch.linalg.cholesky_ex`` per knot;
    with ``grouped``, each group's scenarios as a shared batch of their
    own). Returns K [Bt, N-1, m, n], d [Bt, N-1, m], dV1 [Bt], dV2 [Bt]."""
    from ..solver.altro import _expand_backward_base
    if grouped:
        return per_group(
            lambda g, sl: _expand_backward_base(
                cost, dynA[g], dynB[g], blocks, X[sl], U[sl],
                tuple(lam[sl] for lam in lams),
                tuple(rho[sl] for rho in rhos), reg[sl]),
            dynA.shape[0], X.shape[0])
    return _expand_backward_base(cost, dynA, dynB, blocks, X, U, lams, rhos,
                                 reg)


def fused_expand_backward(cost, dynA, dynB, blocks, X, U, lams, rhos, reg,
                          packed: Optional[PackedBlocks] = None,
                          grouped: bool = False) -> Tuple:
    """Fused AL-expansion + Riccati backward pass.

    cost: QuadCost (shared); dynA [N-1,n,n], dynB [N-1,n,m] (shared, or
    with ``grouped`` [G,N-1,...]: scenario b reads group b // (Bt / G));
    blocks: tuple of ConicConstraint (shared); X [Bt,N,n], U [Bt,N-1,m];
    lams: tuple of [Bt,N,p]; rhos: tuple of [Bt,N]; reg [Bt]. ``packed``
    (:func:`ops.blocks.pack_blocks` of ``blocks``) saves packing the
    constraint stacks on every call.
    Returns K [Bt,N-1,m,n], d [Bt,N-1,m], dV1 [Bt], dV2 [Bt].
    """
    global launch_count
    Bt, N, n = X.shape
    m = U.shape[-1]
    G = check_groups(grouped, dynA, Bt)
    lead = (G, N - 1) if grouped else (N - 1,)
    expect = {"Q": (cost.Q, (N, n, n)), "q": (cost.q, (N, n)),
              "R": (cost.R, (N, m, m)), "r": (cost.r, (N, m)),
              "H": (cost.H, (N, m, n)), "A": (dynA, lead + (n, n)),
              "B": (dynB, lead + (n, m)), "X": (X, (Bt, N, n)),
              "U": (U, (Bt, N - 1, m)), "reg": (reg, (Bt,))}
    for i, (c, lam, rho) in enumerate(zip(blocks, lams, rhos)):
        expect.update({f"Cx{i}": (c.Cx, (N, c.p, n)),
                       f"Cu{i}": (c.Cu, (N, c.p, m)),
                       f"b{i}": (c.b, (N, c.p)), f"mask{i}": (c.mask, (N,)),
                       f"lam{i}": (lam, (Bt, N, c.p)),
                       f"rho{i}": (rho, (Bt, N))})
    _check_args(expect, X)
    if X.device.type == "cpu":
        return fused_expand_backward_reference(cost, dynA, dynB, blocks, X,
                                               U, lams, rhos, reg, grouped)
    if X.device.type != "cuda":
        raise ValueError(f"unsupported device {X.device}")
    if n > MAX_DIM or m > MAX_DIM:
        raise ValueError(f"fused kernel takes n, m <= {MAX_DIM}; got n={n}, "
                         f"m={m}")
    if packed is None:
        packed = pack_blocks(blocks, N, n, m, X)
    rho0 = (rhos[0] if blocks
            else torch.zeros((Bt, N), dtype=X.dtype, device=X.device))

    kw = dict(dtype=X.dtype, device=X.device)
    K = torch.empty((Bt, N - 1, m, n), **kw)
    d = torch.empty((Bt, N - 1, m), **kw)
    dV1 = torch.empty((Bt,), **kw)
    dV2 = torch.empty((Bt,), **kw)
    lib = _build.library()
    fn = (lib.altro_fused_expand_backward_f32 if X.dtype == torch.float32
          else lib.altro_fused_expand_backward_f64)
    nb, meta, lam_ptrs = table_args(packed, lams)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    err = fn(cost.Q.data_ptr(), cost.q.data_ptr(), cost.R.data_ptr(),
             cost.r.data_ptr(), cost.H.data_ptr(), dynA.data_ptr(),
             dynB.data_ptr(), packed.Cx.data_ptr(), packed.Cu.data_ptr(),
             packed.b.data_ptr(), packed.mask.data_ptr(), nb, meta, lam_ptrs,
             X.data_ptr(), U.data_ptr(), rho0.data_ptr(), reg.data_ptr(),
             K.data_ptr(), d.data_ptr(), dV1.data_ptr(), dV2.data_ptr(), Bt,
             max(G, 1), N, n, m, packed.P, stream)
    _build.check(err, "altro_fused_expand_backward")
    launch_count += 1
    return K, d, dV1, dV2
