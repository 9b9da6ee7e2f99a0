"""The ADMM solvers' loop (``admm_qp``, ``admm_conic``, ``knot_admm``): the
port's counterpart of their ``jax.lax.while_loop`` under ``vmap``.

A solver supplies ``chunk(data, state) -> (state, prop, flags)``: CHUNK
iterations of every live lane with its residuals and termination test, a
lane that is not live (done, or at ``max_iter``) left bit for bit as it
was, and its rho proposal ``prop`` (None for a solver without adaptive
rho); ``flags`` is a bool tensor [2]: any lane still live, any lane whose
rho adapts. ``refactor(data, state, prop) -> state`` refactors every lane
at its proposed rho and keeps the new factor and rho on the lanes that
adapt and whose factor is finite, which is what ``vmap`` of the JAX
solvers' ``lax.cond`` computes. The host reads the two flags once per
chunk.

:func:`run` is the eager loop. :class:`GraphedLoop` runs the same functions
over fixed buffers: on a CUDA device the chunk is one CUDA graph (captured
once, after an eager warm-up, with ``solver.graph.Replayable``) whose flags
land in pinned host memory; the refactor, rare and a handful of library
calls, runs eagerly on the buffers. On the CPU the chunk runs eagerly over
the same buffers, which is how the CPU tests check the buffer plumbing
against the eager loop bit for bit.
"""
from __future__ import annotations

from typing import Callable

import torch

from .graph import Replayable, clone_tree, copy_into, tensors


def run(chunk: Callable, refactor: Callable, data, state):
    """The eager loop: returns (state, chunks run)."""
    chunks = 0
    while True:
        state, prop, flags = chunk(data, state)
        chunks += 1
        live, adapt = flags.tolist()
        if adapt:
            state = refactor(data, state, prop)
        if not live:
            return state, chunks


class GraphedLoop:
    """The loop over fixed buffers, built from a template (data, state) whose
    tensors are cloned into the buffers. :meth:`__call__` copies a solve's
    data and initial state into them (raising on any mismatch of structure,
    shape, dtype or device), replays the chunk until no lane is live and
    returns clones of the final state and the chunks it ran. ``capture_s``
    is the host seconds of the warm-up and capture."""

    def __init__(self, chunk: Callable, refactor: Callable, data, state):
        self.refactor_fn = refactor
        self.data = clone_tree(data)
        self.state = clone_tree(state)
        dev = tensors(self.state)[0].device
        self.cuda = dev.type == "cuda"
        self.flags = torch.zeros(2, dtype=torch.bool, pin_memory=self.cuda)
        self.event = torch.cuda.Event() if self.cuda else None

        def chunk_fn():
            s, prop, flags = chunk(self.data, self.state)
            copy_into(self.state, s, "ADMM state")
            self.flags.copy_(flags, non_blocking=True)
            return prop

        self.chunk = Replayable(chunk_fn, dev)
        self.capture_s = self.chunk.capture_s

    def __call__(self, data, state):
        with torch.no_grad():
            copy_into(self.data, data, "ADMM data")
            copy_into(self.state, state, "ADMM state")
            chunks = 0
            while True:
                self.chunk.replay()
                chunks += 1
                if self.cuda:
                    self.event.record()
                    self.event.synchronize()
                live, adapt = self.flags.tolist()
                if adapt:
                    copy_into(self.state, self.refactor_fn(
                        self.data, self.state, self.chunk.out), "ADMM state")
                if not live:
                    return clone_tree(self.state), chunks


def _spec(tree):
    return tuple((tuple(t.shape), t.dtype, t.device) for t in tensors(tree))


def solve_loop(cache: dict, static, chunk: Callable, refactor: Callable,
               data, state, graphed: bool):
    """Run the loop: eagerly, or (``graphed``) through the
    :class:`GraphedLoop` of ``cache`` for this structure (``static``: the
    solver's constants that the chunk closes over; the data's and state's
    shapes, dtypes and devices), built on first use. Returns (state,
    chunks)."""
    if not graphed:
        return run(chunk, refactor, data, state)
    key = (static, _spec(data), _spec(state))
    if key not in cache:
        cache[key] = GraphedLoop(chunk, refactor, data, state)
    return cache[key](data, state)
