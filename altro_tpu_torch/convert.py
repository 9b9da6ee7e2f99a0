"""State carried across from the JAX package, as numpy arrays and plain
values, into the port's objects.

``numpy_tree`` turns any tree of dataclasses, tuples, enums and array-likes
into nested dicts and lists of numpy arrays and plain values (it calls
``np.asarray`` on each leaf, so it needs no JAX import). The ``*_from_numpy``
functions build the port's objects from such trees; ``tree_to`` moves a
tree of the port's objects to another device or floating dtype. A nonlinear
model's function is code, not data: the caller gives the port's counterpart
(:func:`nonlinear_dynamics_from_numpy`).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .cones import Cone
from .constraints import ConicConstraint, DualState, QuadNormConstraint
from .costs import QuadCost
from .dynamics import LTVDynamics, NonlinearDynamics
from .problem import Problem
from .solver.knot_admm import KnotQP
from .solver.options import SolverOptions
from .transcribe import BatchConic, BatchQP


def numpy_tree(obj) -> Any:
    """Dataclasses -> dicts of their fields, tuples/lists -> lists, enums ->
    their values, other scalars unchanged, array-likes -> numpy arrays."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: numpy_tree(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (tuple, list)):
        return [numpy_tree(v) for v in obj]
    if isinstance(obj, enum.Enum):
        return obj.value
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return np.asarray(obj)


def _t(a, device, dtype):
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


# ranks of the shared cost and constraint stacks (without a batch axis)
_COST_RANKS = {"Q": 3, "q": 2, "R": 3, "r": 2, "H": 3, "c": 1}
_BLOCK_RANKS = {"Cx": 3, "Cu": 3, "b": 2, "mask": 1}
_QUAD_NORM_RANKS = {"A": 3, "c": 2, "offset": 1, "mask": 1}


def _shared(a, rank: int, name: str) -> np.ndarray:
    """A shared stack from an array that may carry a batch axis: equal
    lanes give lane 0; lanes that differ raise."""
    a = np.asarray(a)
    if a.ndim == rank:
        return a
    if a.ndim != rank + 1 or not (a == a[:1]).all():
        raise ValueError(f"{name}: shape {a.shape} is neither a shared "
                         f"rank-{rank} stack nor equal across its lanes")
    return a[0]


def _block(c: dict, i: int, device, dtype):
    """An affine conic block or a quadratic norm block (its ``A``, ``c``,
    ``offset``, ``mask`` and ``on``) from its ``numpy_tree``."""
    if "Cx" in c:
        return ConicConstraint(
            cone=Cone(c["cone"]), name=c.get("name", ""),
            **{k: _t(_shared(c[k], r, f"{k}{i}"), device, dtype)
               for k, r in _BLOCK_RANKS.items()})
    return QuadNormConstraint(
        on=c["on"], name=c.get("name", "quad_norm"), cone=Cone(c["cone"]),
        **{k: _t(_shared(c[k], r, f"{k}{i}"), device, dtype)
           for k, r in _QUAD_NORM_RANKS.items()})


def problem_from_numpy(tree: dict, device="cpu", dtype=torch.float64,
                       dynamics: Optional[NonlinearDynamics] = None,
                       grouped: bool = False) -> Problem:
    """Build a :class:`Problem` from ``numpy_tree`` of a problem with affine
    conic blocks and quadratic norm blocks, shared or batched (as the JAX
    package stacks a per-lane problem for ``vmap``). LTV dynamics come from
    the tree, batched ones staying per lane; a nonlinear model is given as
    ``dynamics`` (its function is code: see
    :func:`nonlinear_dynamics_from_numpy`). ``grouped``: the tree is the
    JAX package's grouped problem (``tree_map(lambda a: a[::reps],
    prob_b)``, one entry per group of lanes), whose LTV stacks become a
    grouped :class:`LTVDynamics` [G, N-1, ...]. Cost and constraint stacks
    must be equal across lanes (or groups) and are taken from lane 0 (the
    port keeps them shared)."""
    dyn, cost = tree["dynamics"], tree["cost"]
    if dynamics is None:
        if "A" not in dyn:
            raise ValueError("the problem has nonlinear dynamics: pass "
                             "dynamics=nonlinear_dynamics_from_numpy(...)")
        dynamics = LTVDynamics(**{k: _t(dyn[k], device, dtype)
                                  for k in ("A", "B", "d")},
                               grouped=grouped)
    return Problem(
        dynamics=dynamics,
        cost=QuadCost(**{k: _t(_shared(cost[k], r, k), device, dtype)
                         for k, r in _COST_RANKS.items()}),
        constraints=tuple(_block(c, i, device, dtype)
                          for i, c in enumerate(tree["constraints"])),
        x0=_t(tree["x0"], device, dtype))


def nonlinear_dynamics_from_numpy(params: Sequence, f: Callable, n: int,
                                  m: int, N: int,
                                  lane_axes: Sequence[bool] = (),
                                  device="cpu", dtype=torch.float64
                                  ) -> NonlinearDynamics:
    """The port's :class:`NonlinearDynamics` over the JAX model's params
    (``numpy_tree`` of its params tuple, or the arrays themselves), with
    ``f`` the port's counterpart of the model's function (the same
    one-lane contract) and ``lane_axes`` flagging the leaves that carry the
    lane axis. Floating leaves take ``dtype``, integer leaves keep
    theirs."""
    def leaf(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating):
            return _t(a, device, dtype)
        return torch.as_tensor(a, device=device)
    return NonlinearDynamics(f=f, params=tuple(leaf(a) for a in params),
                             n_=n, m_=m, N_=N, lane_axes=tuple(lane_axes))


def duals_from_numpy(tree: list, device="cpu",
                     dtype=torch.float64) -> Tuple[DualState, ...]:
    """Build the dual tuple from ``numpy_tree`` of a tuple of DualState."""
    return tuple(DualState(lam=_t(d["lam"], device, dtype),
                           rho=_t(d["rho"], device, dtype)) for d in tree)


def options_from_dict(tree: dict) -> SolverOptions:
    """Build :class:`SolverOptions` from a dict of plain values (unknown
    keys raise)."""
    return SolverOptions(**{k: (v.item() if isinstance(v, np.ndarray) else v)
                            for k, v in tree.items()})


def _lanes(a, rank: int, device, dtype):
    """A tensor with a leading lane axis from an array of rank ``rank``
    (one program: one lane) or ``rank + 1`` (already batched)."""
    t = _t(a, device, dtype)
    return t[None] if t.dim() == rank else t


def batch_qp_from_numpy(tree: dict, device="cpu",
                        dtype=torch.float64) -> BatchQP:
    """A :class:`~altro_tpu_torch.transcribe.BatchQP` from ``numpy_tree``
    of the JAX package's BatchQP (unbatched: one lane)."""
    return BatchQP(**{k: _lanes(tree[k], r, device, dtype) for k, r in
                      (("P", 2), ("q", 1), ("A", 2), ("l", 1), ("u", 1))},
                   n=int(tree["n"]), m=int(tree["m"]), N=int(tree["N"]))


def batch_conic_from_numpy(tree: dict, device="cpu",
                           dtype=torch.float64) -> BatchConic:
    """A :class:`~altro_tpu_torch.transcribe.BatchConic` from
    ``numpy_tree`` of the JAX package's BatchConic."""
    return BatchConic(
        **{k: _lanes(tree[k], r, device, dtype) for k, r in
           (("P", 2), ("q", 1), ("A", 2), ("b", 1))},
        segments=tuple((Cone(c), int(n)) for c, n in tree["segments"]),
        n=int(tree["n"]), m=int(tree["m"]), N=int(tree["N"]))


def knot_qp_from_numpy(tree: dict, device="cpu",
                       dtype=torch.float64) -> KnotQP:
    """A :class:`~altro_tpu_torch.solver.knot_admm.KnotQP` from
    ``numpy_tree`` of the JAX package's KnotQP."""
    ranks = dict(Q=3, q=2, R=3, r=2, A=3, B=3, d=2, x0=1)
    blocks = dict(Cx=3, Cu=3, l=2, u=2)
    return KnotQP(
        **{k: _lanes(tree[k], r, device, dtype) for k, r in ranks.items()},
        **{k: tuple(_lanes(a, r, device, dtype) for a in tree[k])
           for k, r in blocks.items()},
        cones=tuple(Cone(c) for c in tree["cones"]))


def tree_to(obj, device=None, dtype=None):
    """Copy of a tree of the port's dataclasses and tuples with every tensor
    moved to ``device`` and every floating tensor cast to ``dtype``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device=device,
                      dtype=dtype if obj.is_floating_point() else None)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: tree_to(getattr(obj, f.name), device, dtype)
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple):
        return tuple(tree_to(v, device, dtype) for v in obj)
    return obj
