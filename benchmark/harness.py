"""One run of one cell on one card: set-up, the measured window, the traced
stretch and the recorded answers.

The cell's entry in BENCHMARK.json names a configuration, whose module
``configs/<config>.py`` builds the program's step and the plain reference
from ``configs/<config>.json``, and a traffic mix, ``traffic/<traffic>.json``
(the batch and the steps per episode). The window steps the receding
horizon in episodes: every episode restarts from the set-up's initial carry
and draws its process noise (a standard normal row per lane and step) on
the device when it starts, from a generator seeded by the run's seed and the
episode's index. Every step ends in a device synchronise and is timed on
the host's clock, call to synchronise.

How the check samples the window and where the trace lies are the
harness's own constants below, not traffic.

A ``--trace 1`` run also turns the program's tracer on
(``altro_tpu_torch.utils.profiling.tracing()``) from before the cell is
built to the window's end, except over the steps the profiler runs over
(its host work would move the profiler's readings), and hands its spans to
the per-layer readers (``Result.spans``): every span kept, on the
profiler's clock, with the window's steps marked.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
OUT_ROOT = os.path.join(ROOT, "build", "benchmark_out")
# bounded per-step records (the window's memory does not grow with speed)
MAX_STEPS = 1 << 20
# the check's sample: steps of the window, and lanes compared in each
CHECK_STEPS = 64
CHECK_LANES = 4
# the traced stretch of a --trace 1 run: where it starts, as a share of the
# window, and how many seconds of steps it records
TRACE_FROM = 0.3
TRACE_SECONDS = 2.0
# the profiler's activities: the device's operations and the host's calls
# into CUDA. The host's per-operator records are left out: they lengthen a
# traced step by a further tenth, and no metric reads them
TRACE_ACTIVITIES = ("CUDA",)


def load_json(*parts):
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def seed_words(seed: int, *more: int) -> list:
    """Non-negative 64-bit words of ``seed`` (any whole number) and ``more``,
    for numpy's seed sequences."""
    return [int(s) % (1 << 64) for s in (seed,) + more]


def stream_seed(seed: int, *more: int) -> int:
    """A 64-bit generator seed drawn from ``seed`` and ``more``."""
    ss = np.random.SeedSequence(seed_words(seed, *more))
    return int(ss.generate_state(1, np.uint64)[0])


def episode_noise(seed: int, episode: int, shape, device,
                  gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Episode ``episode``'s process noise, standard normal rows of
    ``shape`` (steps, lanes, n), drawn on ``device`` from a generator seeded
    by the run's seed and the episode's index."""
    gen = gen or torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, 2, episode))
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device)


@dataclass
class Workload:
    name: str
    config: str
    spec: dict                # configs/<config>.json
    traffic: dict             # traffic/<traffic>.json
    chips: int
    limits: dict              # limits/<workload>.json
    end_to_end: list
    per_layer: list


def workload(name: str, bench: Optional[dict] = None) -> Workload:
    """The cell ``name`` of BENCHMARK.json, with its files; the metrics that
    list it, or that list no cells."""
    bench = bench or load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; "
                         f"choose from {sorted(cells)}")
    w = cells[name]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])

    def applies(metric):
        return name in metric.get("workloads", [name])
    spec = load_json(ROOT, cfg["file"])
    return Workload(
        name=name, config=spec["name"], spec=spec,
        traffic=load_json(BENCH, "traffic", w["traffic"] + ".json"),
        chips=int(w["chips"]),
        limits=load_json(BENCH, "limits", name + ".json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)])


def build_cell(wl: Workload, device):
    mod = load_module(os.path.join(BENCH, "configs", wl.config + ".py"),
                      "benchmark_config_" + wl.config.replace(".", "_"))
    return mod.build(wl.spec, wl.traffic, device)


class Recorder:
    """A uniform sample of the window's steps (reservoir sampling, decided on
    the host from the seed), and in each sampled step the lane with the most
    iterations and ``lanes - 1`` lanes drawn on the device: each one's
    inputs (the previous state and first control, the noise row, the window
    index) and the program's answer (the propagated state, the controls,
    the status), copied into fixed device buffers."""

    def __init__(self, cell, steps: int, lanes: int, seed: int, device):
        self.K, self.S = steps, lanes
        self.cell, self.device = cell, device
        self.rng = np.random.default_rng(seed_words(seed, 1))
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(stream_seed(seed, 3))
        n, m, N = cell.n, cell.m, cell.N
        f32 = dict(dtype=torch.float32, device=device)
        shape = (steps, lanes)
        self.buf = {"x0_prev": torch.zeros(shape + (n,), **f32),
                    "u0_prev": torch.zeros(shape + (m,), **f32),
                    "noise": torch.zeros(shape + (n,), **f32),
                    "x0": torch.zeros(shape + (n,), **f32),
                    "U": torch.zeros(shape + (N - 1, m), **f32),
                    "status": torch.zeros(shape, dtype=torch.int32,
                                          device=device),
                    "k": torch.zeros(shape, dtype=torch.int64, device=device),
                    "lane": torch.zeros(shape, dtype=torch.int64,
                                        device=device),
                    "iters": torch.zeros(shape, dtype=torch.int32,
                                         device=device),
                    "t": torch.zeros(shape, dtype=torch.int64,
                                     device=device)}
        self.seen = 0

    def _write(self, slot, prev, noise, out, t):
        lanes = torch.cat([torch.argmax(out.iters).reshape(1).long(),
                           torch.randint(0, self.cell.B, (self.S - 1,),
                                         generator=self.gen,
                                         device=self.device)])
        b = self.buf
        b["x0_prev"][slot] = prev[0].index_select(0, lanes)
        b["u0_prev"][slot] = prev[2][:, 0].index_select(0, lanes)
        b["noise"][slot] = noise.index_select(0, lanes)
        b["x0"][slot] = out.x0.index_select(0, lanes)
        b["U"][slot] = out.U.index_select(0, lanes)
        b["status"][slot] = out.status.index_select(0, lanes).int()
        b["k"][slot] = self.cell.window_k(t, lanes)
        b["lane"][slot] = lanes
        b["iters"][slot] = out.iters.index_select(0, lanes).int()
        b["t"][slot] = t

    def warm(self, prev, noise, out) -> None:
        """The recording's kernels, once, in set-up."""
        self._write(0, prev, noise, out, 0)

    def offer(self, prev, noise, out, t: int) -> None:
        j = self.seen
        self.seen += 1
        if j < self.K:
            slot = j
        else:
            slot = int(self.rng.integers(0, j + 1))
            if slot >= self.K:
                return
        self._write(slot, prev, noise, out, t)

    def samples(self) -> dict:
        """The recorded lane-steps, on the CPU, flattened."""
        filled = min(self.seen, self.K)
        return {k: v[:filled].reshape((-1,) + tuple(v.shape[2:])).cpu()
                for k, v in self.buf.items()}


class Stretch:
    """The traced stretch of a ``--trace 1`` run: torch.profiler (the
    activities TRACE_ACTIVITIES) starts at ``at`` seconds into the window;
    its schedule discards the first WARM steps (the profiler's own set-up on
    the device), then it records every step until the recorded steps have
    lasted ``length`` seconds. ``traced`` marks the window's steps it
    recorded, ``profiled`` every step it ran over, the discarded ones
    too."""

    WARM = 3

    def __init__(self, at: float, length: float, counter):
        self.at, self.length, self.counter = at, length, counter
        self.prof = self.done = None
        self.seen = self.steps = self.passes = 0
        self.t0 = self.passes0 = None
        self.traced, self.profiled = [], []

    def recording(self) -> bool:
        return self.prof is not None and self.seen >= self.WARM

    def before(self, elapsed: float) -> None:
        if self.prof is None and self.done is None and elapsed >= self.at:
            acts = [getattr(torch.profiler.ProfilerActivity, a)
                    for a in TRACE_ACTIVITIES]
            self.prof = torch.profiler.profile(
                activities=acts, schedule=torch.profiler.schedule(
                    wait=0, warmup=self.WARM, active=1 << 30))
            self.prof.__enter__()
        if self.recording() and self.passes0 is None:
            self.passes0 = self.counter()

    def after(self, step: int, ts: float, te: float) -> None:
        if self.prof is None:
            return
        self.profiled.append(step)
        if self.recording():
            self.steps += 1
            self.traced.append(step)
            self.t0 = ts if self.t0 is None else self.t0
            if te - self.t0 >= self.length:
                self.stop()
                return
        self.seen += 1
        self.prof.step()

    def stop(self) -> None:
        if self.prof is None:
            return
        if self.passes0 is not None:
            self.passes = self.counter() - self.passes0
        self.prof.__exit__(None, None, None)
        self.done, self.prof = self.prof, None


class Tally:
    """Device-side sums over the window's steps, with no host sync: each
    lane's successes and, with ``lane_max``, the steps' largest lane
    iteration counts."""

    def __init__(self, lanes: int, lane_max: bool, device):
        i64 = dict(dtype=torch.int64, device=device)
        self.succ = torch.zeros(lanes, **i64)
        self.lane_max = torch.zeros((), **i64) if lane_max else None

    def add(self, out) -> None:
        self.succ += out.status
        if self.lane_max is not None:
            self.lane_max += out.iters.max()

    def zero(self) -> None:
        for t in (self.succ, self.lane_max):
            if t is not None:
                t.zero_()


@dataclass
class Result:
    lanes: int
    steps: int
    window_s: float
    setup_s: float
    step_s: np.ndarray                # every step's seconds
    successes: int
    memory_peak_bytes: int
    samples: dict
    start: dict
    passes_window: int
    lane_max_sum: Optional[int] = None
    step_passes: Optional[np.ndarray] = None
    traced_steps: Optional[np.ndarray] = None   # indices into step_s
    host: Optional[dict] = None
    trace: Optional[object] = None
    kernels: dict = field(default_factory=dict)
    itemsize: int = 4
    spans: Optional[dict] = None      # window_spans(), --trace 1 only


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def window_spans(records: list, steps: int, profiled) -> dict:
    """The tracer's ``records`` with the window's steps marked: ``window``
    maps the request id of each window step whose ``step`` span was kept
    to the step's index. The tracer is off over the ``profiled`` steps, so
    the window's other steps are the last step requests, in order; it keeps
    the newest spans, so the first ones may be gone."""
    roots = [r["request"] for r in records
             if r["name"] == "step" and r["parent"] is None
             and r["request"] is not None]
    profiled = set(profiled)
    spanned = [i for i in range(steps) if i not in profiled]
    n = min(len(roots), len(spanned))
    return {"records": records,
            "window": dict(zip(roots[len(roots) - n:],
                               spanned[len(spanned) - n:]))}


def _tracer_on(tracer, on: bool) -> None:
    """The program's tracer on or off between two steps."""
    from altro_tpu_torch.utils import profiling
    profiling.tracer = tracer if on else None


def run_cell(wl: Workload, seed: int, seconds: float, trace: bool, *,
             device, t_start: float, out_dir: str):
    """Set up the cell on ``device``, step it for ``seconds`` and record what
    the check and the metrics read: (Result, the cell with its program
    freed). ``trace``: the profiler's stretch and the program's tracer."""
    kw = dict(device=device, t_start=t_start, out_dir=out_dir)
    if not trace:
        return _run_cell(wl, seed, seconds, None, **kw)
    from altro_tpu_torch.utils import profiling
    with profiling.tracing() as tracer:
        return _run_cell(wl, seed, seconds, tracer, **kw)


def _run_cell(wl: Workload, seed: int, seconds: float, tracer, *, device,
              t_start: float, out_dir: str):
    from altro_tpu_torch.solver import altro

    trace = tracer is not None
    cell = build_cell(wl, device)
    T, B = cell.T, cell.B
    gen = torch.Generator(device=device)

    def noise_of(episode: int):
        return episode_noise(seed, episode, (T, B, cell.n), device, gen)

    # set-up: the initial carry (built with the cell), then one step of the
    # window's shape, which captures the step's graphs, and the harness's
    # own kernels
    carry0 = cell.carry0
    noise_ep = noise_of(0)
    _, out = cell.step(carry0, torch.zeros_like(noise_ep[0]), 0)
    recorder = Recorder(cell, CHECK_STEPS, CHECK_LANES, seed, device)
    recorder.warm(carry0, noise_ep[0], out)
    tally = Tally(B, trace, device)
    tally.add(out)                             # its kernels, once
    tally.zero()
    start = {"x0": carry0[0][:1].cpu(), "U": carry0[2][:1].cpu()}
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    del out
    _sync(device)
    step_s = np.zeros(MAX_STEPS)
    step_passes = np.zeros(MAX_STEPS, dtype=np.int64) if trace else None
    stretch = (Stretch(seconds * TRACE_FROM, TRACE_SECONDS,
                       lambda: altro.pass_count) if trace else None)

    t_win = time.perf_counter()
    cpu0 = time.process_time()
    setup_s = t_win - t_start
    passes0 = altro.pass_count
    steps, episode, done = 0, 0, False
    while not done:
        if episode:
            noise_ep = noise_of(episode)
        episode += 1
        carry = carry0
        for t in range(T):
            if stretch is not None:
                stretch.before(time.perf_counter() - t_win)
                _tracer_on(tracer, stretch.prof is None)
            p_before = altro.pass_count
            prev = carry
            ts = time.perf_counter()
            carry, out = cell.step(carry, noise_ep[t], t)
            _sync(device)
            te = time.perf_counter()
            if steps < MAX_STEPS:
                step_s[steps] = te - ts
                if step_passes is not None:
                    step_passes[steps] = altro.pass_count - p_before
            tally.add(out)
            recorder.offer(prev, noise_ep[t], out, t)
            if stretch is not None:
                stretch.after(steps, ts, te)
            steps += 1
            done = te - t_win >= seconds
            if done:
                break
    _sync(device)
    window_s = time.perf_counter() - t_win
    # the host's share of the window: this process's CPU seconds (its host
    # loop spins in the device synchronisations) and the host's load
    host = {"cpu_s": time.process_time() - cpu0,
            "loadavg_1m": os.getloadavg()[0]}
    if stretch is not None:                    # the window may end first
        stretch.stop()
    if tracer is not None:                     # every device time, now
        tracer.resolve(wait=True)
    passes_window = altro.pass_count - passes0
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if torch.device(device).type == "cuda" else 0)
    kept = min(steps, MAX_STEPS)
    result = Result(
        lanes=B, steps=steps, window_s=window_s, setup_s=setup_s,
        step_s=step_s[:kept].copy(), successes=int(tally.succ.sum()),
        memory_peak_bytes=int(memory_peak), samples=recorder.samples(),
        start=start, passes_window=passes_window,
        lane_max_sum=int(tally.lane_max) if trace else None,
        step_passes=step_passes[:kept].copy() if trace else None,
        traced_steps=(np.asarray([s for s in stretch.traced if s < kept],
                                 dtype=np.int64) if trace else None),
        host=host, kernels=cell.kernels, itemsize=cell.itemsize)
    # the program's state goes before the trace is read and the check runs
    del carry, carry0, prev, out, noise_ep, recorder
    cell.step = cell.carry0 = None
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    if stretch is not None and stretch.steps:
        from benchmark import trace as trace_mod
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "trace.json")
        stretch.done.export_chrome_trace(path)
        result.trace = trace_mod.load(path, stretch.passes, stretch.steps)
        os.remove(path)
    if tracer is not None:
        base_ns = (result.trace.extra.get("baseTimeNanoseconds", 0)
                   if result.trace is not None else 0)
        result.spans = window_spans(tracer.records(base_ns), steps,
                                    stretch.profiled)
    return result, cell
