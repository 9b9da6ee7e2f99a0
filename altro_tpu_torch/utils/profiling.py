"""Timing and tracing (the port's counterpart of
``altro_tpu/utils/profiling.py``):

- :func:`timed`: wall time of a block, fenced by a device synchronise on a
  CUDA device (the counterpart of ``block_until_ready``);
- :class:`Tracer` and :func:`tracing`: spans and counters inside the MPC
  step, off unless a ``tracing()`` block is open.

A span has a name, a host start and end (``time.perf_counter_ns``), its
parent span and its request: one call of a graphed MPC step (``step``) or
of a cold :class:`~altro_tpu_torch.solver.graph.GraphedSolve` (``solve``),
numbered in the order the tracer saw them. The spans of a step::

    step                  the call (mpc._GraphedStep)
      step.inputs         the window and the copy of the inputs
      graph.start         a graph replay: the host's call, and the device
                          time between a CUDA event recorded before it and
                          one after it
      loop.L0             one LoopGraph.run (level, cap, lanes, replays,
                          passes, empty replays)
        replay            one loop replay (device events; live lanes
                          entering and leaving it)
        sync              the host's wait for it and the read of the counts
      graph.gather.L0, loop.L1, ..., graph.scatter.L0, loop.L0.rest
      graph.finish
      step.out            the clone of the results

and in set-up ``build`` (a step's graphs for one batch, a cold solve's, a
resume loop's) around ``capture`` (one graph's warm-up and capture).

Spans stay in memory, the newest :data:`MAX_SPANS` of them; nothing is
written unless asked. Device times are read only once their events have
completed, while the device runs the next loop replay (those before a
loop's sync with no query, the rest as a query finds them) or in
:meth:`Tracer.records`, as milliseconds from an event recorded at the
request's first timed span. A replay's device time starts when its
before-event runs: on an idle device, as the host records it, so the graph
launch's latency counts inside. Host times come out on the clock of
``torch.profiler``'s Chrome trace, the realtime clock less the trace's
``baseTimeNanoseconds`` (pass it as ``base_ns``), so the spans lay over a
device trace.

With tracing off each boundary costs one test of :data:`tracer` against
None, and the graphs are replayed with exactly the CUDA calls of an
untraced run.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import time
from typing import Optional

import torch

# the active tracer; None while tracing is off
tracer: Optional["Tracer"] = None
MAX_SPANS = 1 << 20
_OFF = contextlib.nullcontext()


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def timed(label: str = "", results: dict = None, device=None):
    """Wall seconds of the block, with the device (``device``: a CUDA
    device, or None for host work) synchronised on entry and exit; stored
    under ``label`` in ``results`` or printed in ms."""
    _sync(device)
    t0 = time.perf_counter()
    yield
    _sync(device)
    dt = time.perf_counter() - t0
    if results is not None:
        results[label] = dt
    else:
        print(f"[{label}] {dt * 1e3:.3f} ms")


class Span:
    """One span: see :meth:`Tracer.records` for its fields."""

    __slots__ = ("id", "name", "parent", "request", "t0", "t1", "args",
                 "events", "device")

    def __init__(self, id_, name, parent, request, t0, args):
        self.id, self.name, self.parent = id_, name, parent
        self.request, self.t0, self.t1 = request, t0, None
        self.args = args
        self.events = self.device = None


class _Request:
    __slots__ = ("id", "ref", "stream")

    def __init__(self, id_):
        self.id, self.ref, self.stream = id_, None, None


class Tracer:
    """Spans of the program's MPC step and solver loop (see the
    module's docstring). :meth:`records` returns them, :meth:`export`
    writes them as Chrome-trace events."""

    def __init__(self):
        self.spans = collections.deque(maxlen=MAX_SPANS)
        self._open = []
        self._request = None
        self._requests = 0
        self._next = 0
        self._pending = collections.deque()
        self._complete = 0
        self._pool = []
        # one pair of stamps maps perf_counter_ns onto the realtime clock
        self.pc0, self.wall0 = time.perf_counter_ns(), time.time_ns()

    # -- spans ---------------------------------------------------------------

    def open(self, name: str, timed: bool = False, **args) -> Span:
        """Open the span ``name`` under the innermost open one; ``timed``:
        record a CUDA event before its work (and one after it at
        :meth:`close`), inside a request only."""
        sp = Span(self._next, name, self._open[-1].id if self._open else None,
                  None if self._request is None else self._request.id,
                  time.perf_counter_ns(), args)
        self._next += 1
        self._open.append(sp)
        self.spans.append(sp)
        if timed and self._request is not None:
            req = self._request
            if req.ref is None:
                req.stream = torch.cuda.current_stream()
                req.ref = torch.cuda.Event(enable_timing=True)
                req.ref.record(req.stream)
            sp.events = (req.ref, self._event(req.stream))
        return sp

    def close(self, sp: Span) -> None:
        """Close ``sp`` (and any span left open inside it)."""
        if sp.events is not None:
            sp.events += (self._event(self._request.stream),)
            self._pending.append(sp)
        sp.t1 = time.perf_counter_ns()
        while self._open:
            top = self._open.pop()
            if top is sp:
                break
            top.t1 = sp.t1

    @contextlib.contextmanager
    def span(self, name: str, **args):
        sp = self.open(name, **args)
        try:
            yield sp
        finally:
            self.close(sp)

    @contextlib.contextmanager
    def request(self, name: str):
        """A request's root span: device events recorded inside it are
        timed from its first one."""
        outer = self._request
        self._request = _Request(self._requests)
        self._requests += 1
        try:
            with self.span(name) as sp:
                yield sp
        finally:
            self._request = outer

    # -- device events -------------------------------------------------------

    def _event(self, stream):
        ev = (self._pool.pop() if self._pool
              else torch.cuda.Event(enable_timing=True))
        ev.record(stream)
        return ev

    def synced(self) -> None:
        """The caller has waited for the last event recorded: every timed
        span closed so far has completed."""
        self._complete = len(self._pending)

    def resolve(self, wait: bool = False) -> None:
        """Read the device times of the timed spans that have completed:
        those closed before the last :meth:`synced`, then those an event
        query finds done (all of them with ``wait``, which waits)."""
        while self._pending:
            sp = self._pending[0]
            ref, before, after = sp.events
            if self._complete:
                self._complete -= 1
            elif wait:
                after.synchronize()
            elif not after.query():
                return
            sp.device = (ref.elapsed_time(before), ref.elapsed_time(after))
            sp.events = None
            self._pool += (before, after)
            self._pending.popleft()

    # -- output --------------------------------------------------------------

    def records(self, base_ns: int = 0) -> list:
        """The spans kept, oldest first, each a dict: ``id``, ``name``,
        ``parent`` and ``request`` (ids, or None), ``ts`` and ``dur``
        (microseconds; ``ts`` on the realtime clock less ``base_ns``, a
        ``torch.profiler`` Chrome trace's ``baseTimeNanoseconds``; ``dur``
        None while open), ``device`` ([start, end] ms from the request's
        first device event, or None) and ``args`` (attributes and
        counters)."""
        self.resolve(wait=True)
        off = self.wall0 - self.pc0 - base_ns
        return [{"id": sp.id, "name": sp.name, "parent": sp.parent,
                 "request": sp.request, "ts": (sp.t0 + off) * 1e-3,
                 "dur": None if sp.t1 is None else (sp.t1 - sp.t0) * 1e-3,
                 "device": None if sp.device is None else list(sp.device),
                 "args": dict(sp.args)}
                for sp in self.spans]

    def export(self, path: str, base_ns: int = 0) -> None:
        """Write the closed spans to ``path`` as Chrome-trace events on the
        clock of :meth:`records` (``base_ns`` as there), to open beside a
        ``torch.profiler`` trace; a span's device interval and counters go
        in its ``args``."""
        events = []
        for r in self.records(base_ns):
            if r["dur"] is None:
                continue
            args = dict(r["args"], id=r["id"], parent=r["parent"],
                        request=r["request"])
            if r["device"] is not None:
                args["device_ms"] = r["device"]
            events.append({"ph": "X", "cat": "altro_tpu_torch",
                           "name": r["name"], "ts": r["ts"], "dur": r["dur"],
                           "pid": "altro_tpu_torch", "tid": "host",
                           "args": args})
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            json.dump({"traceEvents": events, "baseTimeNanoseconds": base_ns,
                       "displayTimeUnit": "ms"}, fh)


@contextlib.contextmanager
def tracing():
    """Turn tracing on for the block; yields the :class:`Tracer`, whose
    records outlive the block."""
    global tracer
    if tracer is not None:
        raise RuntimeError("tracing is already on")
    tracer = Tracer()
    try:
        yield tracer
    finally:
        tracer = None


def span(name: str, **args):
    """The span ``name`` around a block while tracing is on (set-up's
    ``build`` and ``capture``), else nothing."""
    tr = tracer
    return _OFF if tr is None else tr.span(name, **args)


def summarize(records: list) -> list:
    """Per request of ``records`` (:meth:`Tracer.records`), oldest first, a
    dict: ``request``, ``name``, ``host_ms`` (the request's span),
    ``host_part_ms`` (``step.inputs`` and ``step.out``), ``graphs_ms`` (the
    device ms of every graph replay, from its before-event to its
    after-event; None without device times), ``gaps_us`` (the device µs
    from each loop replay's after-event to the next replay's before-event
    in the same loop run), ``passes``, ``empty_passes`` (passes of replays
    that no live lane entered), ``live_in`` and ``lane_slots`` (live lanes
    entering the replays and the lanes of their batches, summed), and
    ``loops`` (per ``loop.*`` name: its lanes, replays, passes and empty
    replays, summed over the request's runs)."""
    by_id = {r["id"]: r for r in records}
    out = {}
    for r in records:
        rid = r["request"]
        if rid is None:
            continue
        if rid not in out:
            out[rid] = {"request": rid, "name": None, "host_ms": None,
                        "host_part_ms": 0.0, "graphs_ms": None,
                        "gaps_us": [], "passes": 0, "empty_passes": 0,
                        "live_in": 0, "lane_slots": 0, "loops": {},
                        "_prev": {}}
        q = out[rid]
        name, parent = r["name"], by_id.get(r["parent"])
        if r["parent"] is None or parent is None or parent["request"] != rid:
            q["name"] = name
            q["host_ms"] = None if r["dur"] is None else r["dur"] * 1e-3
        if name in ("step.inputs", "step.out") and r["dur"] is not None:
            q["host_part_ms"] += r["dur"] * 1e-3
        if r["device"] is not None:
            q["graphs_ms"] = ((q["graphs_ms"] or 0.0) + r["device"][1]
                              - r["device"][0])
        a = r["args"]
        if name.startswith("loop.") and "replays" in a:
            lp = q["loops"].setdefault(name, {"lanes": a["lanes"],
                                              "replays": 0, "passes": 0,
                                              "empty": 0})
            lp["replays"] += a["replays"]
            lp["passes"] += a["passes"]
            lp["empty"] += a["empty"]
            q["passes"] += a["passes"]
            q["empty_passes"] += a["empty"] * a["check_every"]
        if name == "replay" and parent is not None:
            q["live_in"] += a.get("live_in", 0)
            q["lane_slots"] += parent["args"]["lanes"]
            prev = q["_prev"].get(parent["id"])
            if prev is not None and r["device"] is not None:
                q["gaps_us"].append((r["device"][0] - prev[1]) * 1e3)
            q["_prev"][parent["id"]] = r["device"]
    for q in out.values():
        del q["_prev"]
    return [out[k] for k in sorted(out)]
