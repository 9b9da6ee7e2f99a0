"""AL expansion fused into the Riccati backward pass: the CUDA kernel
``csrc/riccati_fused.cu`` and its plain PyTorch version.

The shared problem data (cost stacks, dynamics A/B, constraint rows) has no
batch axis; the per-scenario inputs are x, u, lambda, rho and reg. Every
block's penalty follows one schedule (the kernel reads the first block's
rho), as the solver keeps it.

Dispatch: a CPU tensor goes to :func:`fused_expand_backward_reference`; a
CUDA tensor goes to the kernel, or raises on what the kernel does not take
(SOC blocks among them: their curvature form is not ported yet).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..cones import Cone
from . import _build
from .rollout import MAX_DIM, _check_args

# Kernel launches since the last reset (see ops/rollout.py).
launch_count = 0

MAX_ROWS = 64


def fused_expand_backward_reference(cost, dynA, dynB, blocks, X, U, lams,
                                    rhos, reg) -> Tuple:
    """Plain PyTorch expansion + Riccati recursion (a Python loop over
    knots, batched over scenarios, ``torch.linalg.cholesky_ex`` per knot).
    Returns K [Bt, N-1, m, n], d [Bt, N-1, m], dV1 [Bt], dV2 [Bt]."""
    from ..solver.altro import _expand_backward_base
    return _expand_backward_base(cost, dynA, dynB, blocks, X, U, lams, rhos,
                                 reg)


def fused_expand_backward(cost, dynA, dynB, blocks, X, U, lams, rhos,
                          reg) -> Tuple:
    """Fused AL-expansion + Riccati backward pass.

    cost: QuadCost (shared); dynA [N-1,n,n], dynB [N-1,n,m] (shared);
    blocks: tuple of ConicConstraint (shared); X [Bt,N,n], U [Bt,N-1,m];
    lams: tuple of [Bt,N,p]; rhos: tuple of [Bt,N]; reg [Bt].
    Returns K [Bt,N-1,m,n], d [Bt,N-1,m], dV1 [Bt], dV2 [Bt].
    """
    global launch_count
    Bt, N, n = X.shape
    m = U.shape[-1]
    expect = {"Q": (cost.Q, (N, n, n)), "q": (cost.q, (N, n)),
              "R": (cost.R, (N, m, m)), "r": (cost.r, (N, m)),
              "H": (cost.H, (N, m, n)), "A": (dynA, (N - 1, n, n)),
              "B": (dynB, (N - 1, n, m)), "X": (X, (Bt, N, n)),
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
                                               U, lams, rhos, reg)
    if X.device.type != "cuda":
        raise ValueError(f"unsupported device {X.device}")
    for c in blocks:
        if c.cone not in (Cone.ZERO, Cone.NONPOS):
            raise NotImplementedError(
                f"fused kernel: {c.cone} blocks are not ported yet")
    P = sum(c.p for c in blocks)
    if n > MAX_DIM or m > MAX_DIM or P > MAX_ROWS:
        raise ValueError(f"fused kernel takes n, m <= {MAX_DIM} and at most "
                         f"{MAX_ROWS} constraint rows; got n={n}, m={m}, "
                         f"rows={P}")

    # blocks concatenated row-wise, one NONPOS bit per row
    nonpos_bits, row = 0, 0
    for c in blocks:
        if c.cone == Cone.NONPOS:
            nonpos_bits |= ((1 << c.p) - 1) << row
        row += c.p
    if len(blocks) == 1:
        (c,) = blocks
        Cx, Cu, cb, lam = c.Cx, c.Cu, c.b, lams[0]
    elif blocks:
        Cx = torch.cat([c.Cx for c in blocks], dim=1)
        Cu = torch.cat([c.Cu for c in blocks], dim=1)
        cb = torch.cat([c.b for c in blocks], dim=1)
        lam = torch.cat(lams, dim=-1)
    else:
        Cx = Cu = cb = lam = X    # never read with zero rows
    if blocks:
        cmask = torch.cat([c.mask[:, None].expand(N, c.p) for c in blocks],
                          dim=1).contiguous()
        rho0 = rhos[0]
    else:
        cmask = X
        rho0 = torch.zeros((Bt, N), dtype=X.dtype, device=X.device)

    kw = dict(dtype=X.dtype, device=X.device)
    K = torch.empty((Bt, N - 1, m, n), **kw)
    d = torch.empty((Bt, N - 1, m), **kw)
    dV1 = torch.empty((Bt,), **kw)
    dV2 = torch.empty((Bt,), **kw)
    lib = _build.library()
    fn = (lib.altro_fused_expand_backward_f32 if X.dtype == torch.float32
          else lib.altro_fused_expand_backward_f64)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    err = fn(cost.Q.data_ptr(), cost.q.data_ptr(), cost.R.data_ptr(),
             cost.r.data_ptr(), cost.H.data_ptr(), dynA.data_ptr(),
             dynB.data_ptr(), Cx.data_ptr(), Cu.data_ptr(), cb.data_ptr(),
             cmask.data_ptr(), nonpos_bits, X.data_ptr(), U.data_ptr(),
             lam.data_ptr(), rho0.data_ptr(), reg.data_ptr(), K.data_ptr(),
             d.data_ptr(), dV1.data_ptr(), dV2.data_ptr(), Bt, N, n, m, P,
             stream)
    _build.check(err, "altro_fused_expand_backward")
    launch_count += 1
    return K, d, dV1, dV2
