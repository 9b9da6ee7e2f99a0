"""The solver loop's on-device form: a solve's start, loop and finish as
CUDA graphs, captured once and replayed (the port's counterpart of the JAX
package's jitted solve around ``jax.lax.while_loop``,
``altro_tpu/solver/altro.py:700-706``).

A :class:`LoopGraph` holds fixed buffers for everything the loop body reads:
the problem's tensors, the packed constraint stacks, the loop state and the
iteration cap (a 0-d device tensor, so one graph serves every absolute cap
of a compaction schedule). Its graph runs one body pass, copies the new
state back into the state buffers (where the pass ends in the pass-tail
kernel, ``ops/pass_tail.py``, the kernel writes them in place and counts
the live lanes itself) and two counts into pinned host memory: the lanes
live when the pass began and when it ended. :meth:`LoopGraph.run` replays
it until no lane is live at the end: one host sync per pass. Every lane
freezes on its own condition, so passes past the last lane's end, or past
the cap, change no bit of the state.

A :class:`LoopSchedule` holds the loop graphs of a compaction schedule
(``((it_cap, block), (extra_cap, sub_block), ...)``; empty: the plain
loop): level 0's loop, then per level a gather graph, the loop of its block
of stragglers and a scatter graph; it captures them and runs the schedule.
:class:`GraphedSolve` adds a start graph (the warm-start rollout and dual
init) and a finish graph (the solution's statistics) around a schedule;
``mpc.py`` builds the MPC steps from the same pieces.

On a CUDA device each piece is captured on a side stream after one eager
warm-up (which builds the kernels' library and initialises cuBLAS outside
the capture) and then replayed; a capture that fails, or a host sync inside
a captured function, raises. The graphs of one step share a memory pool, so
they are captured in the order of their first replay: a graph's result that
another consumes lives in memory that no graph captured before it uses.
On the CPU the same functions run eagerly over the same buffers, without
capture, which is how the CPU tests exercise the buffer plumbing. Results
handed back to the caller are clones: no later replay overwrites them.

Counters: the kernel wrappers' ``launch_count`` and ``solver.altro.
pass_count`` are plain Python counters that a graph bumps only while it is
captured. Each piece records at capture what one replay launches and adds
it to the counters at every replay; the warm-up and the capture add
nothing.

Spans (``utils/profiling.py``, while tracing is on): a replay of a piece is
a span named after it (``graph.start``, ``graph.gather.L0``, ...) with CUDA
events around it; :meth:`LoopGraph.run` a ``loop.*`` span with a
``replay`` and a ``sync`` span per replay, the live counts and the empty
replays; a cold solve a ``solve`` request; set-up ``build`` and ``capture``
spans.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import Callable, Optional

import torch

from ..ops import pass_tail, riccati, riccati_fused, rollout, rollout_al
from ..ops.blocks import pack_blocks
from ..problem import Problem
from ..utils import profiling
from . import altro
from .altro import (Solution, _finalize, _warmstart_state, loop_fns,
                    map_state, take_lanes)
from .options import SolverOptions

# the cap of an uncapped loop: no lane reaches it
NO_CAP = 2 ** 31 - 1
_COUNTERS = ((altro, "pass_count"), (rollout, "launch_count"),
             (riccati_fused, "launch_count"), (rollout_al, "launch_count"),
             (riccati, "launch_count"), (pass_tail, "launch_count"))


def use_graphs(graphed: Optional[bool], device) -> bool:
    """``graphed`` as given, or (None) whether ``device`` is a CUDA
    device."""
    return torch.device(device).type == "cuda" if graphed is None else graphed


def _read_counts():
    return tuple(getattr(mod, name) for mod, name in _COUNTERS)


def _write_counts(values) -> None:
    for (mod, name), v in zip(_COUNTERS, values):
        setattr(mod, name, v)


_capturing = 0


@contextlib.contextmanager
def capturing():
    """Around captures: a dead graph (an earlier solve's, kept by a
    reference cycle) that the cycle collector freed during a capture would
    free its memory pool there and invalidate the capture. So collect once
    on entry and not again until the outermost ``capturing`` exits (a step
    wraps the captures of all its graphs in one)."""
    global _capturing
    if _capturing == 0:
        gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    _capturing += 1
    try:
        yield
    finally:
        _capturing -= 1
        if enabled:
            gc.enable()


@contextlib.contextmanager
def uncounted():
    """Set-up work (a template state computed to shape the buffers) that
    adds nothing to the launch and pass counters."""
    saved = _read_counts()
    try:
        yield
    finally:
        _write_counts(saved)


# ----------------------------------------------------------------------------
# trees of tensors: tuples, dataclasses (Problem, DualState, Solution, ...)
# ----------------------------------------------------------------------------

def _spec(tree, path: str = "") -> list:
    """(path, description) of every node: a tensor's shape, dtype and
    device, any other leaf's type and value (a static leaf: an int, a
    string, a cone, a model's function, compared by its repr)."""
    if isinstance(tree, torch.Tensor):
        return [(path, f"a tensor of shape {tuple(tree.shape)} and dtype "
                       f"{tree.dtype} on {tree.device}")]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out = [(path, type(tree).__name__)]
        for f in dataclasses.fields(tree):
            out += _spec(getattr(tree, f.name), f"{path}.{f.name}")
        return out
    if isinstance(tree, (tuple, list)):
        out = [(path, f"a tuple of {len(tree)}")]
        for i, v in enumerate(tree):
            out += _spec(v, f"{path}[{i}]")
        return out
    return [(path, repr(tree))]


def tensors(tree) -> list:
    """The tensors of a tree, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in tensors(getattr(tree, f.name))]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in tensors(v)]
    return []


def copy_into(dst, src, what: str = "buffers") -> None:
    """Copy the tensors of ``src`` into those of ``dst``, which must match
    it in tree structure, every tensor's shape, dtype and device, and every
    other leaf's value; raises ValueError on the first mismatch."""
    ds, ss = _spec(dst), _spec(src)
    if ds != ss:
        for (pd, d), (ps, s) in zip(ds, ss):
            if (pd, d) != (ps, s):
                raise ValueError(f"{what}: {ps or 'root'} is {s}, the "
                                 f"buffer {pd or 'root'} is {d}")
        raise ValueError(f"{what}: {len(ss)} nodes, the buffers have "
                         f"{len(ds)}")
    for d, s in zip(tensors(dst), tensors(src)):
        if d is not s:
            d.copy_(s)


def clone_tree(tree, _memo: Optional[dict] = None):
    """A copy of a tree whose tensors are contiguous clones; a tensor that
    appears twice is cloned once."""
    memo = {} if _memo is None else _memo
    if isinstance(tree, torch.Tensor):
        if id(tree) not in memo:
            memo[id(tree)] = tree.clone(memory_format=torch.contiguous_format)
        return memo[id(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: clone_tree(getattr(tree, f.name), memo)
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, (tuple, list)):
        return type(tree)(clone_tree(v, memo) for v in tree)
    return tree


# ----------------------------------------------------------------------------
# one captured function
# ----------------------------------------------------------------------------

class Replayable:
    """``fn()``, a function of fixed buffers that writes fixed buffers or
    returns its results, made replayable: on a CUDA device captured once in
    a CUDA graph (``out`` holds the graph's own result tensors, rewritten by
    every replay); on the CPU run eagerly at every replay, its results
    copied into those of the first run.

    ``per_replay`` holds what one replay adds to the launch and pass
    counters; ``capture_s`` the host seconds of the warm-up and the
    capture. ``name``: the span of a replay while tracing is on;
    ``span_args``: more arguments of the ``capture`` span."""

    def __init__(self, fn: Callable, device, pool=None, name: str = "graph",
                 **span_args):
        self.fn = fn
        self.graph = None
        self.name = name
        saved = _read_counts()
        t0 = time.perf_counter()
        device = torch.device(device)
        with torch.no_grad(), profiling.span("capture", graph=name,
                                             **span_args):
            if device.type == "cuda":
                side = torch.cuda.Stream(device)
                side.wait_stream(torch.cuda.current_stream(device))
                with torch.cuda.stream(side):
                    fn()              # outside capture: library, cuBLAS
                torch.cuda.current_stream(device).wait_stream(side)
                _write_counts(saved)
                self.graph = torch.cuda.CUDAGraph()
                with capturing(), torch.cuda.graph(self.graph, pool=pool):
                    self.out = fn()
                after = _read_counts()
            else:
                self.out = fn()
                after = saved
        self.per_replay = tuple(a - b for a, b in zip(after, saved))
        _write_counts(saved)
        self.capture_s = time.perf_counter() - t0

    def replay(self) -> None:
        tr = profiling.tracer
        if tr is None:
            self.launch()
            return
        sp = tr.open(self.name, timed=self.graph is not None)
        self.launch()
        tr.close(sp)

    def launch(self) -> None:
        """One replay, untraced."""
        if self.graph is None:
            with torch.no_grad():
                copy_into(self.out, self.fn(), "results")
            return
        self.graph.replay()
        _write_counts(a + d for a, d in zip(_read_counts(), self.per_replay))


# ----------------------------------------------------------------------------
# the loop
# ----------------------------------------------------------------------------

class LoopGraph:
    """The flat AL + iLQR loop of one batch over fixed buffers, one body
    pass per replay.

    Built from a template problem and loop state (``solver.altro.
    _warmstart_state``'s tuple; the batch is the state's), whose tensors
    are cloned into the buffers; ``share``: a loop graph whose problem
    buffers and packed stacks this one reads too (a compaction level's
    block of lanes). ``pool``: the CUDA graph memory pool, shared by the
    graphs of one step. :meth:`load` copies a step's problem and state into
    the buffers, :meth:`set_cap` sets the absolute iteration cap and
    :meth:`run` replays until no lane is live. ``state`` holds the result
    between replays; a later replay or load overwrites it. ``live``: the
    pinned int32 pair the last replay wrote, the lanes live when its pass
    began and when it ended. ``name`` and ``level`` label its runs' spans while
    tracing is on (set where a step's graphs are built); ``b_body``, the
    body kernel B takes in its passes (``solver.altro.b_body``; None on
    the split route), labels its ``capture`` span. ``capture``: capture
    the graph now, or leave it to :meth:`capture` (a step captures its
    graphs in the order it replays them)."""

    def __init__(self, prob: Optional[Problem], opts: SolverOptions, state,
                 *, pool=None, share: Optional["LoopGraph"] = None,
                 capture: bool = True):
        X_0 = state[0]
        dev = X_0.device
        self.state = clone_tree(state)
        if share is None:
            self.prob = clone_tree(prob)
            ctx = altro.loop_context(self.prob, opts, self.state[0])
        else:
            self.prob = share.prob
            ctx = dataclasses.replace(
                share.ctx, lanes=torch.arange(X_0.shape[0], device=dev))
        self.ctx = ctx
        self.cap = torch.full((), NO_CAP, dtype=torch.int32, device=dev)
        self.it_cap = None
        self.name, self.level = "loop", 0
        self.cuda = dev.type == "cuda"
        self.live = torch.ones(2, dtype=torch.int32, pin_memory=self.cuda)
        self._live = self.live.numpy()
        # the live counts on the device, where the pass-tail kernel adds them
        self.counts = torch.zeros(2, dtype=torch.int32, device=dev)
        self.event = torch.cuda.Event() if self.cuda else None
        self.b_body = altro.b_body(self.prob, opts, dev.type)
        _, self._cond, self._body = loop_fns(self.prob, opts, self.state,
                                             self.cap, ctx)
        self.pool = pool
        self.graph = None
        if capture:
            self.capture()
            # the warm-up ran a pass over the buffers: put the template
            # back
            self.load(state=state)

    def capture(self) -> None:
        # the capture span names the body kernel B takes in the passes
        self.graph = Replayable(self._pass, self.state[0].device,
                                self.pool, "loop", b_body=self.b_body)

    @property
    def per_replay(self):
        return self.graph.per_replay

    @property
    def capture_s(self) -> float:
        return self.graph.capture_s

    def _pass(self) -> None:
        s = self.state
        if self.ctx.pass_tail:
            # the pass writes the state buffers in place and counts the
            # lanes live entering and leaving it
            self.counts.zero_()
            self._body(s, counts=self.counts)
            self.live.copy_(self.counts, non_blocking=True)
            return
        live = self._cond(s)           # the pass freezes by it
        new = self._body(s, live)
        copy_into(self.state, new, "loop state")
        self.live.copy_(torch.stack((live, self._cond(new))).sum(
            1, dtype=torch.int32), non_blocking=True)

    def load(self, prob: Optional[Problem] = None, state=None) -> None:
        """Copy ``prob`` (and its packed constraint stacks) and ``state``
        into the buffers; raises on a mismatch in tree structure, shape or
        dtype. A capturable function: a step's start graph calls it."""
        if prob is not None:
            copy_into(self.prob, prob, "problem")
            if self.ctx.packed is not None:
                p = self.prob
                copy_into(self.ctx.packed,
                          pack_blocks(p.constraints, p.N, p.n, p.m,
                                      self.state[0]), "packed blocks")
        if state is not None:
            copy_into(self.state, state, "loop state")

    def set_cap(self, it_cap: Optional[int]) -> None:
        """Lanes stop being live at the absolute iteration count ``it_cap``
        (None: no cap)."""
        self.it_cap = None if it_cap is None else int(it_cap)
        self.cap.fill_(NO_CAP if it_cap is None else self.it_cap)

    def replay(self) -> None:
        """One replay (one pass), without reading the live counts."""
        self.graph.launch()

    def run(self, rest: bool = False) -> int:
        """Replay until no lane is live at the end of a replay (a replay
        runs first, so a batch with no live lane costs one frozen pass and
        one sync); returns the number of replays. ``rest``: the run is a
        catch-all (its span's name ends in ``.rest``)."""
        tr = profiling.tracer
        if tr is not None:
            return self._run_traced(tr, rest)
        replays = 0
        while True:
            self.graph.launch()
            replays += 1
            if self.cuda:
                self.event.record()
                self.event.synchronize()
            if not self._live[1]:
                return replays

    def _run_traced(self, tr, rest: bool) -> int:
        """:meth:`run` in spans: the sync waits on the replay's
        after-event; the device times of what came before are read while
        the next replay runs."""
        replays = empty = 0
        # check_every (body passes per replay) stays in the span as the
        # constant 1: the benchmark's span reader multiplies the empty
        # replays by it
        with tr.span(self.name + (".rest" if rest else ""), level=self.level,
                     lanes=int(self.state[0].shape[0]), cap=self.it_cap,
                     check_every=1) as run:
            while True:
                rep = tr.open("replay", timed=self.cuda)
                self.graph.launch()
                tr.resolve()
                tr.close(rep)
                replays += 1
                sync = tr.open("sync")
                if rep.events is not None:
                    rep.events[2].synchronize()
                elif self.cuda:
                    self.event.record()
                    self.event.synchronize()
                live_in, live_out = int(self._live[0]), int(self._live[1])
                tr.close(sync)
                tr.synced()
                rep.args.update(live_in=live_in, live_out=live_out)
                empty += live_in == 0
                if not live_out:
                    break
            run.args.update(replays=replays, passes=replays, empty=empty)
        return replays


def gather_fn(parent: LoopGraph, child: LoopGraph, blk: int):
    """Gather the ``blk`` unconverged-first lanes of ``parent``'s state (a
    stable argsort of the done flags) into ``child``'s, with their problem
    data when ``child`` has problem buffers of its own (per-lane data:
    :func:`solver.altro.take_lanes`); returns the lane index."""
    def gather():
        take = torch.argsort(parent.state[10].to(torch.int32),
                             stable=True)[:blk]
        prob = (None if child.prob is parent.prob
                else take_lanes(parent.prob, take))
        child.load(prob, map_state(lambda a: a[take], parent.state))
        return take
    return gather


def scatter_fn(parent: LoopGraph, child: LoopGraph, gather: Replayable):
    """Scatter ``child``'s state back into the lanes of ``parent``'s that
    ``gather`` took, in place."""
    def scatter():
        for a, b in zip(tensors(parent.state), tensors(child.state)):
            a.index_copy_(0, gather.out, b)
    return scatter


class LoopSchedule:
    """The loop graphs of a compaction schedule ``sched`` (``((it_cap,
    block), (extra_cap, sub_block), ...)``; empty: the plain loop), in the
    memory pool ``pool``.

    Level 0's loop is built from a template problem and loop state, as a
    :class:`LoopGraph`. Each level adds a loop of ``min(block, parent
    batch)`` lanes, which reads its parent's problem buffers, or, where the
    problem has per-lane data (``Problem.per_lane``), buffers of its own
    that the level's gather fills with the lanes' data
    (:func:`solver.altro.take_lanes`, which refuses grouped stacks). The
    loops are ``loops[level]``, named ``loop.L<level>``; ``gathers`` and
    ``scatters`` hold the graphs between a level and the next.

    :meth:`capture` captures level 0's loop, then each level's gather and
    loop, then the scatters from the innermost out: the order of their
    first replay (see the module's docstring), so a step captures its start
    graph just before and its finish graph just after. :meth:`run` runs
    the schedule: level 0 to ``it_cap``, the gather of its ``block``
    unconverged-first lanes, the next level to ``extra_cap`` more
    iterations (the cap is absolute, so capped runs compose), and so on;
    the innermost level to completion; then, from the innermost out, each
    scatter and the catch-all of the level above (a ``.rest`` run, which
    finds no live lane unless the block was too small)."""

    def __init__(self, prob: Problem, opts: SolverOptions, state, sched=(),
                 pool=None):
        self.sched, self.pool = tuple(sched), pool
        loops = [LoopGraph(prob, opts, state, pool=pool, capture=False)]
        own = prob.per_lane or getattr(prob.dynamics, "grouped", False)
        for _, block in self.sched:
            parent = loops[-1]
            blk = min(block, parent.state[0].shape[0])
            sub = map_state(lambda a: a[:blk], parent.state)
            if own:
                head = torch.arange(blk, device=parent.state[0].device)
                loops.append(LoopGraph(take_lanes(parent.prob, head), opts,
                                       sub, pool=pool, capture=False))
            else:
                loops.append(LoopGraph(None, opts, sub, pool=pool,
                                       share=parent, capture=False))
        for lvl, loop in enumerate(loops):
            loop.name, loop.level = f"loop.L{lvl}", lvl
        self.loops = loops
        self.gathers, self.scatters = [], []

    def capture(self) -> None:
        loops, pool = self.loops, self.pool
        dev = loops[0].state[0].device
        loops[0].capture()
        for lvl, (parent, child) in enumerate(zip(loops, loops[1:])):
            self.gathers.append(Replayable(
                gather_fn(parent, child, child.state[0].shape[0]), dev, pool,
                f"graph.gather.L{lvl}"))
            child.capture()
        self.scatters = [None] * len(self.gathers)
        for lvl in reversed(range(len(self.gathers))):
            self.scatters[lvl] = Replayable(
                scatter_fn(loops[lvl], loops[lvl + 1], self.gathers[lvl]),
                dev, pool, f"graph.scatter.L{lvl}")

    @property
    def capture_s(self) -> float:
        return sum(g.capture_s for g in (self.loops + self.gathers
                                          + self.scatters))

    def _run(self, lvl: int, it_cap: Optional[int],
             rest: bool = False) -> int:
        loop = self.loops[lvl]
        loop.set_cap(it_cap)
        return loop.run(rest)

    def run(self) -> int:
        """Run the schedule from the state in level 0's buffers to
        completion; returns the loop replays."""
        replays = cum = 0
        for lvl, (cap, _) in enumerate(self.sched):
            cum += cap
            replays += self._run(lvl, cum)
            self.gathers[lvl].replay()
        replays += self._run(len(self.sched), None)
        for lvl in reversed(range(len(self.sched))):
            self.scatters[lvl].replay()
            replays += self._run(lvl, None, rest=True)
        return replays


# ----------------------------------------------------------------------------
# a cold batch solve
# ----------------------------------------------------------------------------

class GraphedSolve:
    """``solver.altro.solve(prob, opts, U0)`` of a batch with no duals to
    start from, as a start graph (the init rollout, or with ``states`` the
    given states, and the fresh duals), the loop graphs of a
    :class:`LoopSchedule` and a finish graph, captured for the problem's
    shapes. ``prob.x0`` is [batch, n] (or [n], broadcast to ``batch``).

    ``gs(x0, U0, X0)`` copies the initial states [batch, n], controls
    [batch, N-1, m] (zeros when None) and, with ``states``, the states to
    start from [batch, N, n] (``solve(..., X0=X0)``: no init rollout) into
    their buffers, replays and returns the solution (clones).

    ``sched``: the compaction schedule (:class:`LoopSchedule`; empty: the
    plain loop). With one level ``((it_cap, block),)`` it is
    ``solver.altro.solve_compacted``: every lane runs to ``it_cap``, the
    ``block`` unconverged-first lanes finish as a batch of their own, and a
    catch-all resumes the whole batch."""

    def __init__(self, prob: Problem, opts: SolverOptions,
                 batch: Optional[int] = None, *, pool=None,
                 states: bool = False, sched=()):
        x0 = prob.x0
        if x0.dim() == 1:
            if batch is None:
                raise ValueError("an unbatched x0 needs a batch size")
            x0 = x0.expand(batch, x0.shape[0])
        if batch is not None and x0.shape[0] != batch:
            raise ValueError(f"x0 has {x0.shape[0]} lanes, batch is {batch}")
        prob = dataclasses.replace(prob, x0=x0)
        dev = x0.device
        if pool is None and dev.type == "cuda":
            pool = torch.cuda.graph_pool_handle()
        self.opts = opts
        self.U0 = torch.zeros((x0.shape[0], prob.N - 1, prob.m),
                              dtype=x0.dtype, device=dev)
        self.X0 = (torch.zeros((x0.shape[0], prob.N, prob.n),
                               dtype=x0.dtype, device=dev)
                   if states else None)
        with profiling.span("build", lanes=int(x0.shape[0])):
            self._build(prob, opts, sched, pool)
        self.replays = 0

    def _build(self, prob: Problem, opts: SolverOptions, sched,
               pool) -> None:
        dev = prob.x0.device
        with torch.no_grad(), uncounted():
            s0 = _warmstart_state(prob, opts, self.U0, None, self.X0)
        self.levels = LoopSchedule(prob, opts, s0, sched, pool)
        self.loop = self.levels.loops[0]
        with capturing():
            self._start = Replayable(self._start_fn, dev, pool,
                                     "graph.start")
            self.levels.capture()
            self._finish = Replayable(
                lambda: _finalize(self.loop.prob, self.loop.state), dev,
                pool, "graph.finish")

    def _start_fn(self) -> None:
        self.loop.load(state=_warmstart_state(self.loop.prob, self.opts,
                                              self.U0, None, self.X0))

    @property
    def capture_s(self) -> float:
        return (self._start.capture_s + self.levels.capture_s
                + self._finish.capture_s)

    def __call__(self, x0: Optional[torch.Tensor] = None,
                 U0: Optional[torch.Tensor] = None,
                 X0: Optional[torch.Tensor] = None) -> Solution:
        if (X0 is None) != (self.X0 is None):
            raise ValueError("X0 is given exactly when the solve was built "
                             "with states=True")
        tr = profiling.tracer
        if tr is None:
            return self._solve(x0, U0, X0)
        with tr.request("solve"):
            return self._solve(x0, U0, X0)

    def _solve(self, x0, U0, X0) -> Solution:
        with torch.no_grad():
            if x0 is not None:
                copy_into(self.loop.prob.x0, x0, "x0")
            if U0 is None:
                self.U0.zero_()
            else:
                copy_into(self.U0, U0, "U0")
            if X0 is not None:
                copy_into(self.X0, X0, "X0")
            self._start.replay()
            self.replays += self.levels.run()
            self._finish.replay()
            return clone_tree(self._finish.out)


def solve(prob: Problem, opts: SolverOptions,
          U0: Optional[torch.Tensor] = None,
          X0: Optional[torch.Tensor] = None, *,
          graphed: Optional[bool] = None) -> Solution:
    """One cold batch solve (from states ``X0`` when given): through a
    :class:`GraphedSolve` captured for this call when ``graphed`` (None: on
    a CUDA device), else ``solver.altro.solve``."""
    if not use_graphs(graphed, prob.x0.device):
        return altro.solve(prob, opts, U0=U0, X0=X0)
    return GraphedSolve(prob, opts, states=X0 is not None)(U0=U0, X0=X0)
