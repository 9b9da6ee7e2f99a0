"""The tail of a solver pass on the fused-ladder route: the CUDA kernel
``csrc/pass_tail.cu`` and its plain PyTorch version.

From the loop state and what kernels B (K, d, dV1, dV2) and C (the ladder's
Xs, Us and merits J) computed in the pass, the tail takes the gradient
metric, the ladder's rung, the adopted trajectory, its residuals and
projected multipliers, the regularization schedule, the stop tests, the AL
round's dual and penalty update and the iteration counters, and freezes
every lane whose own loop condition is false (``solver/altro.py: loop_fns``
documents the loop).

The kernel replaces no TPU kernel: it fuses the PyTorch glue that ran after
kernel C, well over a hundred small launches a pass. It is bound by latency
(~12 KB a lane), not by bytes or FLOPs. It writes the new state in place,
into the state's own tensors; :func:`pass_tail_reference` returns a new
state, as the loop body did. Its decisions are the plain version's on the
same inputs; the residual rows are summed in another order than the
einsum's (``csrc/pass_tail.cu``).

Dispatch: :func:`al_pass_tail` on CPU tensors runs the plain version and
copies its result into the state; on CUDA tensors it launches the kernel,
or raises on what the kernel does not take.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from . import _build
from .blocks import PackedBlocks, pack_blocks, table_args
from .rollout import MAX_DIM, MAX_RUNGS, _check_args
from ..cones import project_polar, violation
from ..constraints import DualState

# Kernel launches since the last reset (see ops/rollout.py).
launch_count = 0


def live_mask(s, opts, it_cap=None) -> torch.Tensor:
    """The loop condition [B] of state ``s``: not done, under the outer-round
    cap and (``it_cap``, an int or a 0-d int32 tensor) the iteration
    cap."""
    it, rounds, done = s[8], s[9], s[10]
    live = (~done) & (rounds < opts.iterations_outer)
    if it_cap is not None:
        live = live & (it < it_cap)
    return live


def _where_tree(pred, a, b):
    """torch.where over matching trees of tensors, tuples and DualStates;
    ``pred`` [B] broadcasts over each leaf's trailing axes."""
    if isinstance(a, torch.Tensor):
        p = pred.reshape(pred.shape + (1,) * (a.dim() - pred.dim()))
        return torch.where(p, a, b)
    if isinstance(a, DualState):
        return DualState(lam=_where_tree(pred, a.lam, b.lam),
                         rho=_where_tree(pred, a.rho, b.rho))
    return tuple(_where_tree(pred, x, y) for x, y in zip(a, b))


def _ladder_choice(Jts, alphas, dV1, dV2, ls_min_ratio):
    """Rung selection of the parallel line search from the ladder's merits
    Jts [B, L] (the last rung is alpha = 0, the current trajectory) and the
    backward pass's expected decrease terms dV1, dV2 [B]. Returns the first
    (largest-alpha) admissible rung idx [B], accepted [B], the expected
    decreases [B, L] and the achieved/expected ratios [B, L]."""
    J = Jts[:, -1]
    expected = -(alphas * dV1[:, None] + alphas * alphas * dV2[:, None])
    ratio = (J[:, None] - Jts) / torch.clamp(expected, min=1e-12)
    oks = torch.where(expected > 1e-12, ratio > ls_min_ratio,
                      Jts < J[:, None]) & torch.isfinite(Jts)
    idx = oks.to(torch.int8).argmax(dim=-1)   # first True = largest alpha
    return idx, oks.any(dim=-1), expected, ratio


def pass_tail_reference(blocks, opts, s, live, Knew, dff, dV1, dV2, Xts, Uts,
                        Jts, alphas: torch.Tensor, lanes: torch.Tensor,
                        rungs: Optional[Tuple] = None):
    """Plain PyTorch version: the new loop state, out of place. ``live``
    [B]: the lanes that take it (the others keep ``s``); ``alphas`` [L] the
    ladder with its trailing 0, ``lanes`` [B] the lane index. ``rungs``
    (Cs, CTs): every rung's residuals and projected duals (the classical
    ladder), to select the adopted rung's from; None evaluates them on the
    adopted trajectory (the fused ladder)."""
    X, U, K, duals, reg, grad, viol, it_rd, it, rounds, done = s

    # gradient metric (Altro's d-based gradient check)
    grad_new = torch.amax(torch.amax(torch.abs(dff), dim=-1)
                          / (torch.amax(torch.abs(U), dim=-1) + 1.0), dim=-1)
    pre_done = grad_new < opts.gradient_tolerance

    idx, accepted, expected, ratio = _ladder_choice(
        Jts, alphas, dV1, dV2, opts.ls_min_ratio)
    J = Jts[:, -1]
    Xn = _where_tree(accepted, Xts[lanes, idx], X)
    Un = _where_tree(accepted, Uts[lanes, idx], U)
    Jn = torch.where(accepted, Jts[lanes, idx], J)
    if rungs is None:
        # one constraint pass on the ADOPTED trajectory (a rejected lane
        # evaluates the kept X, U directly)
        cs_acc, cts_acc = [], []
        for con, dual in zip(blocks, duals):
            c = con.evaluate(Xn, Un)
            cs_acc.append(c)
            cts_acc.append(project_polar(
                con.cone, dual.lam + dual.rho[..., None] * c))
    else:
        # accepted rung's residuals / projected duals (the alpha=0 rung IS
        # the current trajectory, so the rejected case selects rung -1)
        Cts, CTts = rungs
        cs_acc = tuple(_where_tree(accepted, Ct[lanes, idx], Ct[:, -1])
                       for Ct in Cts)
        cts_acc = tuple(_where_tree(accepted, Ct[lanes, idx], Ct[:, -1])
                        for Ct in CTts)

    # regularization schedule
    reg_fail = torch.clamp(torch.clamp(reg, min=opts.reg_min)
                           * opts.reg_increase, opts.reg_min, opts.reg_max)
    reg_ok = torch.where(reg * opts.reg_decrease < opts.reg_min, 0.0,
                         reg * opts.reg_decrease)
    reg_new = torch.where(accepted, reg_ok, reg_fail)

    dJ = J - Jn
    stuck = (~accepted) & (reg >= opts.reg_max)
    # exact-model early stop (options.early_exact_tol): an accepted FULL
    # Newton step whose achieved/predicted ratio is ~1
    eet = opts.early_exact_tol
    exact_full = (accepted & (idx == 0) & (eet > 0)
                  & (expected[:, 0] > 1e-12)
                  & (torch.abs(ratio[:, 0] - 1.0) <= eet))
    inner_done = (pre_done | (accepted & (dJ < opts.cost_tolerance))
                  | stuck | exact_full)
    round_end = inner_done | (it_rd + 1 >= opts.iterations_inner)

    # masked AL round bookkeeping
    viol_r, converged_r, duals_r = _round_end_update(
        blocks, opts, X, cs_acc, cts_acc, duals, accepted | pre_done)
    duals_new = _where_tree(round_end, duals_r, duals)
    viol_new = torch.where(round_end, viol_r, viol)
    it_rd_new = torch.where(round_end, 0, it_rd + 1)
    rounds_new = rounds + round_end.to(torch.int32)
    done_new = round_end & converged_r

    out = (Xn, Un, Knew, duals_new, reg_new, grad_new, viol_new,
           it_rd_new, it + 1, rounds_new, done_new)
    # freeze a lane as soon as ITS OWN cond is false (done, the outer-round
    # cap without convergence, or the iteration cap)
    return _where_tree(live, out, s)


def _round_end_update(blocks, opts, X, cs, cts, duals, lam_ok):
    """AL round bookkeeping from the adopted trajectory's residuals (cs) and
    projected duals (cts). The multipliers are updated only when ``lam_ok``
    (an ACCEPTED rung or an inner optimum): on a stuck round the rounding
    error of the kept trajectory's residuals times rho would snowball the
    carried multipliers. Penalty scaling always applies."""
    viol_r = torch.zeros_like(X[:, 0, 0])
    lams = []
    for con, c, ct in zip(blocks, cs, cts):
        v = violation(con.cone, c)
        # mask via where (not multiply): masked knots can carry inf/NaN
        # residuals on diverged lanes and 0 * inf = NaN
        v = torch.where(con.mask[:, None] > 0, v, 0.0)
        viol_r = torch.maximum(viol_r, torch.amax(torch.abs(v), (-2, -1)))
        lams.append(ct * con.mask[:, None])
    converged = viol_r < opts.constraint_tolerance
    new_duals = tuple(
        DualState(lam=torch.where(lam_ok[:, None, None], lam, dual.lam),
                  rho=torch.where(converged[:, None], dual.rho,
                                  torch.clamp(dual.rho * opts.penalty_scaling,
                                              max=opts.penalty_max)))
        for lam, dual in zip(lams, duals))
    return viol_r, converged, new_duals


def _leaves(s):
    X, U, K, duals, *rest = s
    return [X, U, K] + [t for d in duals for t in (d.lam, d.rho)] + rest


def al_pass_tail(blocks, opts, s, Knew, dff, dV1, dV2, Xts, Uts, Jts,
                 alphas: Sequence[float],
                 packed: Optional[PackedBlocks] = None, it_cap=None,
                 live: Optional[torch.Tensor] = None, counts=None):
    """The pass tail, written into the state ``s`` in place; returns ``s``.

    Shared: blocks (tuple of ConicConstraint, affine, shared stacks);
    ``alphas`` the ladder with its trailing 0 (floats). Per scenario: the
    state ``s`` (``solver._warmstart_state``'s tuple, contiguous);
    Knew [Bt,N-1,m,n], dff [Bt,N-1,m], dV1, dV2 [Bt] (kernel B);
    Xts [Bt,L,N,n], Uts [Bt,L,N-1,m], Jts [Bt,L] (kernel C). ``it_cap``: an
    int, a 0-d int32 tensor on the device, or None. ``live`` [Bt] bool: the
    lanes to update (None: each lane's own loop condition, :func:`live_mask`).
    ``counts`` (an int32 [2] tensor): add the lanes live on entry to
    counts[0] and those live after the pass to counts[1]. ``packed``
    (:func:`ops.blocks.pack_blocks` of ``blocks``) saves packing the
    constraint stacks on every call."""
    global launch_count
    X, U, K, duals, reg, grad, viol, it_rd, it, rounds, done = s
    alphas = tuple(float(a) for a in alphas)
    Bt, N, n = X.shape
    m = U.shape[-1]
    L = len(alphas)
    lams = tuple(d.lam for d in duals)
    rhos = tuple(d.rho for d in duals)
    expect = {"X": (X, (Bt, N, n)), "U": (U, (Bt, N - 1, m)),
              "K": (K, (Bt, N - 1, m, n)), "reg": (reg, (Bt,)),
              "grad": (grad, (Bt,)), "viol": (viol, (Bt,)),
              "Knew": (Knew, (Bt, N - 1, m, n)), "dff": (dff, (Bt, N - 1, m)),
              "dV1": (dV1, (Bt,)), "dV2": (dV2, (Bt,)),
              "Xts": (Xts, (Bt, L, N, n)), "Uts": (Uts, (Bt, L, N - 1, m)),
              "Jts": (Jts, (Bt, L))}
    if len(blocks) != len(duals):
        raise ValueError(f"{len(blocks)} blocks, {len(duals)} duals")
    for i, (c, lam, rho) in enumerate(zip(blocks, lams, rhos)):
        expect.update({f"Cx{i}": (c.Cx, (N, c.p, n)),
                       f"Cu{i}": (c.Cu, (N, c.p, m)),
                       f"b{i}": (c.b, (N, c.p)), f"mask{i}": (c.mask, (N,)),
                       f"lam{i}": (lam, (Bt, N, c.p)),
                       f"rho{i}": (rho, (Bt, N))})
    _check_args(expect, X)
    flags = {"it_rd": (it_rd, torch.int32), "it": (it, torch.int32),
             "rounds": (rounds, torch.int32), "done": (done, torch.bool)}
    if live is not None:
        flags["live"] = (live, torch.bool)
    if isinstance(it_cap, torch.Tensor):
        if it_cap.shape != ():
            raise ValueError(f"it_cap: shape {tuple(it_cap.shape)}, expected "
                             "()")
        flags["it_cap"] = (it_cap, torch.int32)
    if counts is not None:
        flags["counts"] = (counts, torch.int32)
    for name, (t, dtype) in flags.items():
        shape = {"it_cap": (), "counts": (2,)}.get(name, (Bt,))
        if (tuple(t.shape) != shape or t.dtype != dtype
                or t.device != X.device or not t.is_contiguous()):
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, expected a contiguous {shape} "
                             f"{dtype} on {X.device}")

    if X.device.type == "cpu":
        lv = live_mask(s, opts, it_cap) if live is None else live
        out = pass_tail_reference(
            blocks, opts, s, lv, Knew, dff, dV1, dV2, Xts, Uts, Jts,
            torch.tensor(alphas, dtype=X.dtype), torch.arange(Bt))
        if counts is not None:
            counts[0] += lv.sum(dtype=torch.int32)
            counts[1] += live_mask(out, opts, it_cap).sum(dtype=torch.int32)
        for a, b in zip(_leaves(s), _leaves(out)):
            a.copy_(b)
        return s
    if X.device.type != "cuda":
        raise ValueError(f"unsupported device {X.device}")
    if not (1 <= L <= MAX_RUNGS and n <= MAX_DIM and m <= MAX_DIM):
        raise ValueError(f"pass-tail kernel takes L <= {MAX_RUNGS}, n, m <= "
                         f"{MAX_DIM}; got L={L}, n={n}, m={m}")
    if packed is None:
        packed = pack_blocks(blocks, N, n, m, X)

    cap_value = 2 ** 31 - 1 if it_cap is None else (
        0 if isinstance(it_cap, torch.Tensor) else int(it_cap))
    # the kernel's first and last flags (count on entry, count after the
    # pass) are both on wherever it counts: a loop replay is one pass
    count = int(counts is not None)
    ptrs = (ctypes.c_void_p * 24)(*[
        None if t is None else t.data_ptr() for t in (
            X, U, K, reg, grad, viol, it_rd, it, rounds, done, Knew, dff,
            dV1, dV2, Xts, Uts, Jts, packed.Cx, packed.Cu, packed.b,
            packed.mask, live,
            it_cap if isinstance(it_cap, torch.Tensor) else None, counts)])
    ints = (ctypes.c_int * 11)(Bt, N, n, m, packed.P, L,
                               opts.iterations_inner, opts.iterations_outer,
                               cap_value, count, count)
    reals = (ctypes.c_double * (11 + L))(
        opts.gradient_tolerance, opts.ls_min_ratio, opts.reg_min,
        opts.reg_max, opts.reg_increase, opts.reg_decrease,
        opts.cost_tolerance, opts.early_exact_tol, opts.constraint_tolerance,
        opts.penalty_scaling, opts.penalty_max, *alphas)
    nb, meta, lam_ptrs = table_args(packed, lams)
    rho_ptrs = (ctypes.c_void_p * max(1, nb))(*[r.data_ptr() for r in rhos])
    lib = _build.library()
    fn = (lib.altro_pass_tail_f32 if X.dtype == torch.float32
          else lib.altro_pass_tail_f64)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    err = fn(ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(ints,
             ctypes.c_void_p), ctypes.cast(reals, ctypes.c_void_p), nb, meta,
             lam_ptrs, ctypes.cast(rho_ptrs, ctypes.c_void_p), stream)
    _build.check(err, "altro_pass_tail")
    launch_count += 1
    return s
