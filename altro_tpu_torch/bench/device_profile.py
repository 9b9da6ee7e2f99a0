"""Where the device time of the main paths goes: one torch.profiler window
over warm work on one card, per path.

    python -m altro_tpu_torch.bench.device_profile [flagship] [rocket]
                                                   [grasp] [flexsat]
                                                   [quadruped]
                                                   [quadruped_grouped]
                                                   [flagship_lanes] [split]
                                                   [naive_rocket]
                                                   [srb_nonlinear]
                                                   [--forms graphed,eager]

Paths (all of them when none is named), each at B=1024 in float32 and in
both forms (``--forms``): on CUDA graphs (``solver/graph.py``, one body
pass per replay) and on the host-driven loop:

- flagship: the cold solve and two warm MPC steps, then windows of 10 warm
  steps;
- flagship_lanes: the same with a window index per lane
  (``make_mpc_step(shared_k=False)``, start windows 0-4): the split route
  (the AL expansion in PyTorch, kernel D, kernel A);
- rocket and grasp, each in the plain step and in the straggler-compacted
  step of its shipped schedule (``bench/conic.py: SCHEDULES``): the cold
  solve of the long problem, the batched initial solve
  and one warm-up step, then windows of 3 (rocket) or 5 (grasp) warm steps;
- split: the rocket's and grasp's plain steps with the fused expansion off
  (``SolverOptions.fused_expansion=False``: kernel D in place of B, as
  ``bench/fused_check.py`` runs them);
- flexsat, in the plain step and in the compacted step of its shipped
  schedule (``bench/families.py: FLEXSAT_SCHEDULE``): the cold solve and
  one warm-up step, then windows of 5 regulator steps;
- quadruped, in both friction modes: one warm-up solve, then windows of 2
  cold batch solves, each with a fresh x0 draw; quadruped_grouped, the
  same in the grouped layout (each schedule's stacks shared by its lanes:
  kernels B and C every pass, A once per solve);
- naive_rocket: the rocket's cold N=301 solve in its quadratic norm form
  (``bench/conic.py: naive_rocket_setup``, B landings), windows of one
  cold solve: the split route with shared A/B (the expansion in PyTorch,
  kernel D, kernel A at L=11, the merit in PyTorch);
- srb_nonlinear: the quadruped batch on the RK4 SRB model itself
  (``families.quadruped_setup(nonlinear=True)``, QP friction), windows of
  2 cold solves from the reference states: every pass relinearizes the
  model per lane (``torch.func.jacfwd``), runs kernel D and rolls the
  ladder out through the model in PyTorch. For these two the graphed form
  also splits one pass into its sections (``sections``: linearize,
  expansion, kernel D, ladder rollout, merit), each run alone on a
  mid-solve iterate and fenced by a device synchronise, the device time of
  each kernel attributed to the section whose host range contains its
  start (as for the closed loop);
- closed_loop, the quadruped closed loop of one robot in float64, in both
  friction forms: two warm-up periods, then windows of 10 periods, each
  fenced into its three sections (prep: the schedule and the
  relinearization; solve; ticks: adopting the solution and the 30 control
  ticks). Printed per period and section: the wall ms of the unprofiled
  window and the device ms of the profiled one, each kernel attributed to
  the section whose host range (which ends in a device synchronise)
  contains its start, with the device time and launches of the rest by
  kind per section.

Each path runs one window unprofiled and the next under the profiler (CPU
and CUDA activities). Printed per solver-loop pass (``solver.altro.
pass_count``: the loop-body passes of every batch the window ran, a
compacted step's gathered blocks included) and per step or solve: the
device time and launches of each hand-written kernel and of the rest of the
device work by kind, and the device busy share: the profiled window's
device time per pass (one stream, so kernels do not overlap) over the
unprofiled window's wall clock per pass. The profiler's own host overhead
stretches the profiled window's wall, which is printed beside it but is not
the denominator. For the graphed rocket, grasp and flexsat it also times
each level
batch's loop graph alone (``pass_ms_by_batch``: device ms per body pass at
1024, 256 and 128 lanes, CUDA events around 20 replays queued behind a
sleep), and, in a compacted step, the host ms of a gather and a scatter
between two levels as a graph replay and as the same function run eagerly
(``compaction_ms_by_level``). The last line is the result of every path as
JSON.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from altro_tpu_torch.bench.kernels import (FLAG_B, FLEX_B, GRASP_B, QUAD_B,
                                           ROCKET_B)
from altro_tpu_torch.solver import altro, graph

FLAG_STEPS, ROCKET_STEPS, GRASP_STEPS, FLEX_STEPS, QUAD_SOLVES = (10, 3, 5,
                                                                  5, 2)
NAIVE_SOLVES = 1
PASS_SECTIONS = ("linearize", "expansion", "kernel D", "ladder rollout",
                 "merit")
# the iteration at which a pass is split into its sections, and the passes
# timed
SECTION_IT, SECTION_PASSES = 5, 10
LOOP_PERIODS = 10
LOOP_SECTIONS = ("prep", "solve", "ticks")
KINDS = (("kernel B (fused_expand_backward)", ("fused_expand_backward",)),
         ("kernel C (ls_rollout_al)", ("ls_rollout_al",)),
         ("kernel A (ls_rollout)", ("ls_rollout",)),
         # every kernel D body (its translation unit names B's kernels too,
         # which match first); before index/cat/copy, whose "cat" it holds
         ("kernel D (riccati)", ("riccati",)),
         ("gemm/gemv", ("gemm", "gemv", "cublas", "xmma", "cutlass")),
         ("reduction", ("reduce",)),
         ("elementwise", ("elementwise",)),
         ("index/cat/copy", ("index", "cat", "copy", "gather", "scatter")))


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def profile(window) -> dict:
    """``window()`` runs one window of warm work and returns its solver-loop
    passes; it is called twice, unprofiled and then under the profiler."""
    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        passes = window()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, passes

    wall_ms, iters_plain = timed()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        prof_wall_ms, iters = timed()
    per_kind = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kind = kind_of(e.key)
        ms, n = per_kind.get(kind, (0.0, 0))
        per_kind[kind] = (ms + us / 1e3, n + e.count)
    device_ms = sum(ms for ms, _ in per_kind.values())
    if device_ms == 0.0:
        raise RuntimeError("the profiler recorded no device time")
    return {"loop_iterations": iters, "device_ms": device_ms,
            "profiled_wall_ms": prof_wall_ms, "unprofiled_wall_ms": wall_ms,
            "unprofiled_loop_iterations": iters_plain,
            "busy_share": (device_ms / iters) / (wall_ms / iters_plain),
            "per_iteration": {k: {"ms": ms / iters, "launches": n / iters}
                              for k, (ms, n) in sorted(per_kind.items())}}


def _step_window(step, carry, noise, first, steps):
    """A window function over ``steps`` MPC steps at a time, from step
    ``first`` on; it returns the solver-loop passes it ran."""
    state = {"carry": carry, "t": first}

    def window():
        passes = altro.pass_count
        for _ in range(steps):
            t = state["t"]
            state["carry"], _ = step(state["carry"], noise[t], t)
            state["t"] = t + 1
        return altro.pass_count - passes
    return window


def flagship_window(B: int = FLAG_B, device="cuda", graphed=None):
    from altro_tpu_torch.bench.flagship import flagship_setup
    from altro_tpu_torch.mpc import make_mpc_step

    setup = flagship_setup(B, 2 * FLAG_STEPS + 2, dtype=torch.float32,
                           device=device)
    pm = setup.prob_mpc
    step, init_carry = make_mpc_step(pm, setup.opts, setup.X_track,
                                     setup.U_track, graphed=graphed)
    carry = init_carry(B)
    for t in range(2):
        carry, _ = step(carry, setup.noise[t], t)
    return _step_window(step, carry, setup.noise, 2, FLAG_STEPS)


LANE_SPREAD = 5


def flagship_lanes_window(B: int = FLAG_B, device="cuda", graphed=None):
    """Windows of the flagship's steps with a window index per lane (start
    windows 0 .. LANE_SPREAD - 1)."""
    from altro_tpu_torch.bench.flagship import flagship_setup
    from altro_tpu_torch.mpc import make_mpc_step

    setup = flagship_setup(B, 2 * FLAG_STEPS + 2 + LANE_SPREAD,
                           dtype=torch.float32, device=device)
    lane_step, init_carry = make_mpc_step(
        setup.prob_mpc, setup.opts, setup.X_track, setup.U_track,
        shared_k=False, graphed=graphed)

    def step(carry, noise_i, k):
        return lane_step(carry, noise_i)

    carry = init_carry(B, torch.arange(B, device=device) % LANE_SPREAD)
    for t in range(2):
        carry, _ = step(carry, setup.noise[t], t)
    return _step_window(step, carry, setup.noise, 2, FLAG_STEPS)


def conic_window(family: str, compact: bool, B: int = ROCKET_B,
                 device="cuda", graphed=None, split: bool = False):
    """Windows of the rocket's or grasp's MPC steps, plain or in the
    family's shipped compaction schedule (``split``: with the fused
    expansion off); the window function carries the step as
    ``window.step``."""
    import numpy as np

    from altro_tpu_torch.bench import conic

    setup = conic.SETUPS[family](torch.float32, device=device,
                                 graphed=graphed)
    steps = {"rocket": ROCKET_STEPS, "grasp": GRASP_STEPS}[family]
    sched = conic.SCHEDULES[family] if compact else (0, 256, ())
    opts = dataclasses.replace(setup.opts, fused_expansion=not split)
    step, init_carry = conic.make_step(setup, *sched, opts=opts,
                                       graphed=graphed)
    noise = torch.as_tensor(np.random.default_rng(setup.noise_seed)
                            .standard_normal((2 * steps + 1, B, 6)),
                            dtype=torch.float32, device=device)
    carry, _ = step(init_carry(B), noise[0], 0)
    window = _step_window(step, carry, noise, 1, steps)
    window.step = step
    return window


def flexsat_window(compact: bool, B: int = FLEX_B, device="cuda",
                   graphed=None):
    """Windows of the flexsat regulator's steps, plain or in its shipped
    compaction schedule; the window function carries the step as
    ``window.step``."""
    from altro_tpu_torch.bench import families

    su = families.flexsat_setup(B, 2 * FLEX_STEPS + 1, torch.float32,
                                device)
    sched = families.FLEXSAT_SCHEDULE if compact else (0, 256, ())
    step, init_carry = families.flexsat_step(su, *sched, graphed=graphed)
    carry, _ = step(init_carry(B), su.noise[0], 0)
    window = _step_window(step, carry, su.noise, 1, FLEX_STEPS)
    window.step = step
    return window


def quadruped_window(linearized_friction: bool, B: int = QUAD_B,
                     device="cuda", graphed=None, grouped: bool = False):
    """Windows of cold batch solves of the quadruped, flat or (``grouped``)
    in the grouped layout, each from a fresh x0 draw."""
    from altro_tpu_torch.bench.families import quadruped_setup

    su = quadruped_setup(B, linearized_friction, torch.float32, device,
                         grouped=grouped)
    gs = (graph.GraphedSolve(su.prob, su.opts)
          if graph.use_graphs(graphed, device) else None)

    def window(solves=QUAD_SOLVES):
        passes = altro.pass_count
        for _ in range(solves):
            x0 = su.draw_x0().to(device=device, dtype=torch.float32)
            if gs is not None:
                gs(x0, su.U0)
            else:
                altro.solve(dataclasses.replace(su.prob, x0=x0), su.opts,
                            U0=su.U0)
        return altro.pass_count - passes

    window(1)                                              # warm-up
    return window


def naive_rocket_window(B: int = ROCKET_B, device="cuda", graphed=None):
    """Windows of cold solves of the naive rocket's B landings;
    ``window.pieces`` builds the sections of one pass
    (:func:`pass_pieces`)."""
    from altro_tpu_torch.bench.conic import naive_rocket_setup

    su = naive_rocket_setup(B, torch.float32, device)
    return _cold_window(su.prob, su.opts, su.U0, None, NAIVE_SOLVES, device,
                        graphed)


def srb_nonlinear_window(B: int = QUAD_B, device="cuda", graphed=None):
    """Windows of cold solves of the quadruped batch on the RK4 SRB model
    (QP friction), each from a fresh x0 draw and the reference states."""
    from altro_tpu_torch.bench.families import quadruped_setup

    su = quadruped_setup(B, True, torch.float32, device, nonlinear=True)
    return _cold_window(su.prob, su.opts, su.U0, su.X0, QUAD_SOLVES, device,
                        graphed,
                        lambda: su.draw_x0().to(device=device,
                                                dtype=torch.float32))


def _cold_window(prob, opts, U0, X0, solves, device, graphed, draw=None):
    """A window of ``solves`` cold batch solves of ``prob`` from U0 (and
    the states X0), each from a fresh x0 when ``draw`` gives one; one
    warm-up solve first."""
    gs = (graph.GraphedSolve(prob, opts, states=X0 is not None)
          if graph.use_graphs(graphed, device) else None)

    def window(n=solves):
        passes = altro.pass_count
        for _ in range(n):
            x0 = prob.x0 if draw is None else draw()
            if gs is not None:
                gs(x0, U0, X0)
            else:
                altro.solve(dataclasses.replace(prob, x0=x0), opts, U0=U0,
                            X0=X0)
        return altro.pass_count - passes

    window(1)                                              # warm-up
    window.pieces = lambda: pass_pieces(prob, opts, U0, X0)
    return window


def pass_pieces(prob, opts, U0, X0=None, it: int = SECTION_IT) -> dict:
    """The sections of one split-route pass (PASS_SECTIONS) at the iterate
    of a solve stopped after ``it`` iterations: each a function of no
    argument that runs its part of the pass (the solver's own functions) on
    the outputs of the sections before it, in order."""
    from altro_tpu_torch.constraints import DualState

    X, U, _, duals, reg = altro.solve_partial(prob, opts, U0=U0, X0=X0,
                                              it_cap=it)[:5]
    dyn = prob.dynamics
    alphas_t = tuple(opts.ls_decrease ** i
                     for i in range(opts.iterations_linesearch)) + (0.0,)
    alphas = torch.tensor(alphas_t, dtype=X.dtype, device=X.device)
    duals_l = tuple(DualState(lam=d.lam[:, None], rho=d.rho[:, None])
                    for d in duals)
    out = {}

    def linearize():
        out["AB"] = dyn.linearize(X, U)[:2]

    def expansion():
        out["exp"] = altro._al_expansion_cd(prob.cost, prob.constraints,
                                            duals, X, U)

    def riccati():
        out["gains"] = altro.backward_pass(*out["AB"], *out["exp"], reg)

    def ladder():
        K, d = out["gains"][:2]
        out["ladder"] = altro.rollout_closed_loop(dyn, X, U, K, d, alphas_t,
                                                  alphas)

    def merit():
        Jts, _ = altro.total_al_cost_res(prob, duals_l, *out["ladder"])
        _, _, dV1, dV2 = out["gains"]
        out["choice"] = altro._ladder_choice(Jts, alphas, dV1, dV2,
                                             opts.ls_min_ratio)

    return dict(zip(PASS_SECTIONS, (linearize, expansion, riccati, ladder,
                                    merit)))


def _attribute(prof, prefix: str, names) -> tuple:
    """({section: {kind: (device ms, launches)}}, kernels placed in no
    section) of a profile whose host ranges ``prefix:<section>`` each end
    in a device synchronise: a kernel belongs to the range that contains
    its start."""
    ranges, kernels = [], []
    for e in prof.events():
        if e.name.startswith(prefix + ":"):
            # the range on the host; its copy on the device's timeline (a
            # user annotation spanning the section's device work) is no
            # kernel
            if e.device_type == torch.autograd.DeviceType.CUDA:
                continue
            ranges.append((e.time_range.start, e.time_range.end,
                           e.name.split(":", 1)[1]))
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append(e)
    device = {s: {} for s in names}
    unplaced = 0
    for e in kernels:
        t = e.time_range.start
        name = next((n for a, b, n in ranges if a <= t <= b), None)
        if name is None:
            unplaced += 1
            continue
        kind = kind_of(e.name)
        ms, n = device[name].get(kind, (0.0, 0))
        device[name][kind] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return device, unplaced


def pass_sections(pieces: dict, passes: int = SECTION_PASSES) -> dict:
    """Wall and device ms per pass of each section of ``pieces``
    (:func:`pass_pieces`): ``passes`` passes unprofiled, then as many under
    the profiler, every section fenced by a device synchronise."""
    def run(label):
        wall = dict.fromkeys(pieces, 0.0)
        for _ in range(passes):
            for name, fn in pieces.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.profiler.record_function(f"{label}:{name}"):
                    fn()
                    torch.cuda.synchronize()
                wall[name] += (time.perf_counter() - t0) * 1e3
        return {k: v / passes for k, v in wall.items()}

    run("warm-up")
    wall = run("unprofiled")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run("section")
    device, unplaced = _attribute(prof, "section", pieces)
    return {"passes": passes, "unplaced_kernels": unplaced, "per_pass": {
        s: {"wall_ms": wall[s],
            "device_ms": sum(ms for ms, _ in device[s].values()) / passes,
            "launches": sum(n for _, n in device[s].values()) / passes,
            "by_kind": {k: {"ms": ms / passes, "launches": n / passes}
                        for k, (ms, n) in sorted(device[s].items())}}
        for s in pieces}}


def pass_ms_by_batch(step, replays: int = 20) -> dict:
    """{lanes: device ms per body pass} of each level batch's loop graph of
    a graphed step that has run: CUDA events around ``replays`` replays
    queued behind a 20 ms sleep, so the time is the device's alone (every
    lane is frozen by then, which changes no kernel's work)."""
    out = {}
    for g in step.sets.values():
        for loop in g.loops:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(20_000_000)
            start.record()
            for _ in range(replays):
                loop.replay()
            end.record()
            end.synchronize()
            out[int(loop.state[0].shape[0])] = (start.elapsed_time(end)
                                                / (replays
                                                   * loop.check_every))
    return out


def compaction_ms_by_level(step, calls: int = 20) -> list:
    """Per level of a graphed compacted step that has run: the host ms of
    one gather and one scatter between two levels, each as a replay of its
    graph and as the same function run eagerly (``calls`` calls each,
    every call synchronised)."""
    def per_call(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / calls

    out = []
    for g in step.sets.values():
        for gather, scatter in zip(g.gathers, g.scatters):
            with torch.no_grad():
                out.append({"gather_graph_ms": per_call(gather.replay),
                            "gather_eager_ms": per_call(gather.fn),
                            "scatter_graph_ms": per_call(scatter.replay),
                            "scatter_eager_ms": per_call(scatter.fn)})
    return out


def closed_loop_sections(linearized_friction: bool,
                         periods: int = LOOP_PERIODS, graphed=None) -> dict:
    """Wall and device ms per period by section of the closed loop (see
    the module docstring): periods 2 .. 2 + periods unprofiled, the next
    ``periods`` under the profiler."""
    from altro_tpu_torch.bench.drivers import QUAD_OPTS
    from altro_tpu_torch.models.quadruped import config, controller
    from altro_tpu_torch.solver.options import SolverOptions

    loop = controller.ClosedLoop(
        config.MPCConfig(linearized_friction=linearized_friction),
        SolverOptions(**QUAD_OPTS), device="cuda", graphed=graphed)
    for k in range(2):                                 # warm-up, capture
        loop.period(k)

    def window(k0, label):
        wall = dict.fromkeys(LOOP_SECTIONS, 0.0)
        passes = altro.pass_count
        for k in range(k0, k0 + periods):
            loop.set_time(k)
            held = {}

            def prep():
                held["dyn"], held["fl"] = loop.prep()

            def solve():
                held["U"], held["duals"], _ = loop.solve(held["dyn"])

            def ticks():
                loop.adopt(held["U"], held["duals"], held["fl"])
                loop.ticks()
            for name, fn in zip(LOOP_SECTIONS, (prep, solve, ticks)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.profiler.record_function(f"{label}:{name}"):
                    fn()
                    torch.cuda.synchronize()
                wall[name] += (time.perf_counter() - t0) * 1e3
        return ({k: v / periods for k, v in wall.items()},
                (altro.pass_count - passes) / periods)

    wall, passes = window(2, "unprofiled")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        prof_wall, _ = window(2 + periods, "section")
    device, unplaced = _attribute(prof, "section", LOOP_SECTIONS)
    per_section = {
        s: {"wall_ms": wall[s], "profiled_wall_ms": prof_wall[s],
            "device_ms": sum(ms for ms, _ in device[s].values()) / periods,
            "launches": sum(n for _, n in device[s].values()) / periods,
            "by_kind": {k: {"ms": ms / periods, "launches": n / periods}
                        for k, (ms, n) in sorted(device[s].items())}}
        for s in LOOP_SECTIONS}
    if sum(v["device_ms"] for v in per_section.values()) == 0.0:
        raise RuntimeError("the profiler recorded no device time")
    return {"path": "closed loop " + ("qp" if linearized_friction
                                      else "socp"),
            "form": "graphed" if loop.graphed else "eager",
            "periods": periods, "passes_per_period": passes,
            "unplaced_kernels": unplaced, "per_period": per_section}


# path: ((label, batch, window's description, steps or solves per window,
# its maker taking `graphed`), ...)
PATHS = {
    "flagship": (("flagship", FLAG_B, f"{FLAG_STEPS} warm steps",
                  FLAG_STEPS, lambda g: flagship_window(graphed=g)),),
    "rocket": tuple((label, ROCKET_B, f"{ROCKET_STEPS} warm steps",
                     ROCKET_STEPS,
                     lambda g, c=compact: conic_window("rocket", c,
                                                       graphed=g))
                    for label, compact in (("rocket", False),
                                           ("rocket compacted", True))),
    "grasp": tuple((label, GRASP_B, f"{GRASP_STEPS} warm steps", GRASP_STEPS,
                    lambda g, c=compact: conic_window("grasp", c, GRASP_B,
                                                      graphed=g))
                   for label, compact in (("grasp", False),
                                          ("grasp compacted", True))),
    "flexsat": tuple((label, FLEX_B, f"{FLEX_STEPS} warm steps", FLEX_STEPS,
                      lambda g, c=compact: flexsat_window(c, graphed=g))
                     for label, compact in (("flexsat", False),
                                            ("flexsat compacted", True))),
    "flagship_lanes": (("flagship lanes", FLAG_B,
                        f"{FLAG_STEPS} warm steps", FLAG_STEPS,
                        lambda g: flagship_lanes_window(graphed=g)),),
    "split": tuple((f"{family} split", B, f"{steps} warm steps", steps,
                    lambda g, f=family, B=B: conic_window(
                        f, False, B, graphed=g, split=True))
                   for family, B, steps in (("rocket", ROCKET_B,
                                             ROCKET_STEPS),
                                            ("grasp", GRASP_B,
                                             GRASP_STEPS))),
    "naive_rocket": (("naive rocket", ROCKET_B,
                      f"{NAIVE_SOLVES} cold N=301 solve", NAIVE_SOLVES,
                      lambda g: naive_rocket_window(graphed=g)),),
    "srb_nonlinear": (("srb nonlinear qp", QUAD_B,
                       f"{QUAD_SOLVES} cold solves", QUAD_SOLVES,
                       lambda g: srb_nonlinear_window(graphed=g)),),
    "quadruped": (("quadruped qp", QUAD_B, f"{QUAD_SOLVES} cold solves",
                   QUAD_SOLVES, lambda g: quadruped_window(True, graphed=g)),
                  ("quadruped socp", QUAD_B, f"{QUAD_SOLVES} cold solves",
                   QUAD_SOLVES,
                   lambda g: quadruped_window(False, graphed=g))),
    "quadruped_grouped": tuple(
        (f"quadruped grouped {mode}", QUAD_B, f"{QUAD_SOLVES} cold solves",
         QUAD_SOLVES,
         lambda g, lin=lin: quadruped_window(lin, graphed=g, grouped=True))
        for mode, lin in (("qp", True), ("socp", False))),
}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("paths", nargs="*", help=f"of {list(PATHS)} and "
                    "closed_loop (default: all)")
    ap.add_argument("--forms", default="graphed,eager",
                    help="comma-separated forms: graphed, eager")
    args = ap.parse_args()
    names = args.paths or list(PATHS) + ["closed_loop"]
    forms = args.forms.split(",")
    unknown = ([n for n in names if n not in PATHS and n != "closed_loop"]
               + [f for f in forms if f not in ("graphed", "eager")])
    if unknown:
        raise SystemExit(f"unknown path or form {unknown}; choose from "
                         f"{list(PATHS)} and graphed, eager")
    if not torch.cuda.is_available():
        raise SystemExit("the profile measures a CUDA device; none is "
                         "available")
    from altro_tpu_torch.bench.flagship import power_limit
    card = power_limit()
    results = []
    for name in names:
        if name == "closed_loop":
            for lin in (True, False):
                for form in forms:
                    res = closed_loop_sections(lin, graphed=form == "graphed")
                    print(f"{res['path']} [{form}] f64 [{card}], per period "
                          f"over {res['periods']} periods "
                          f"({res['passes_per_period']:.2f} solver-loop "
                          f"passes; {res['unplaced_kernels']} kernels "
                          "outside the sections):", flush=True)
                    for sec, v in res["per_period"].items():
                        print(f"  {sec}: wall {v['wall_ms']:.3f} ms "
                              f"(profiled {v['profiled_wall_ms']:.3f}), "
                              f"device {v['device_ms']:.3f} ms in "
                              f"{v['launches']:.1f} kernels; " + "; ".join(
                                  f"{k} {kv['ms']:.4f} ms "
                                  f"({kv['launches']:.1f})"
                                  for k, kv in v["by_kind"].items()))
                    results.append(res)
            continue
        for label, B, desc, units, make_window in PATHS[name]:
            for form in forms:
                window = make_window(form == "graphed")
                res = dict(profile(window), path=label, form=form, B=B,
                           window=desc)
                res["device_ms_per_unit"] = res["device_ms"] / units
                res["unprofiled_wall_ms_per_unit"] = (
                    res["unprofiled_wall_ms"] / units)
                res["passes_per_unit"] = (res["unprofiled_loop_iterations"]
                                          / units)
                if form == "graphed" and hasattr(window, "step"):
                    res["pass_ms_by_batch"] = pass_ms_by_batch(window.step)
                    res["compaction_ms_by_level"] = compaction_ms_by_level(
                        window.step)
                if form == "graphed" and hasattr(window, "pieces"):
                    res["sections"] = pass_sections(window.pieces())
                print(f"{res['path']} [{form}] B={res['B']} f32 [{card}]: "
                      f"unprofiled {res['window']} = "
                      f"{res['unprofiled_loop_iterations']} solver-loop "
                      f"passes in {res['unprofiled_wall_ms']:.3f} ms; "
                      f"profiled {res['window']} = {res['loop_iterations']} "
                      f"passes in {res['profiled_wall_ms']:.3f} ms with "
                      f"{res['device_ms']:.3f} ms of device time; busy "
                      f"{100 * res['busy_share']:.1f}% (device ms per pass "
                      f"over unprofiled wall ms per pass); per step or "
                      f"solve: {res['device_ms_per_unit']:.3f} ms device, "
                      f"{res['unprofiled_wall_ms_per_unit']:.3f} ms wall, "
                      f"{res['passes_per_unit']:.2f} passes"
                      + (f"; graphed pass device ms by batch "
                         f"{res['pass_ms_by_batch']}; gather and scatter "
                         f"host ms by level {res['compaction_ms_by_level']}"
                         if "pass_ms_by_batch" in res else ""), flush=True)
                for kind, v in res["per_iteration"].items():
                    print(f"  per pass: {kind}: {v['ms']:.4f} ms device, "
                          f"{v['launches']:.1f} launches")
                for sec, v in res.get("sections", {}).get(
                        "per_pass", {}).items():
                    print(f"  section {sec} (alone, fenced; "
                          f"{res['sections']['passes']} passes at iteration "
                          f"{SECTION_IT}): wall {v['wall_ms']:.3f} ms, "
                          f"device {v['device_ms']:.4f} ms in "
                          f"{v['launches']:.1f} kernels; " + "; ".join(
                              f"{k} {kv['ms']:.4f} ms ({kv['launches']:.1f})"
                              for k, kv in v["by_kind"].items()))
                results.append(res)
    print(json.dumps({"card": card, "paths": results}))


if __name__ == "__main__":
    main()
