"""Where the device time of the main paths goes: one torch.profiler window
over warm work on one card, per path.

    python -m altro_tpu_torch.bench.device_profile [flagship] [rocket]
                                                   [grasp] [flexsat]
                                                   [quadruped]
                                                   [--forms graphed,eager]

Paths (all of them when none is named), each at B=1024 in float32 and in
both forms (``--forms``): on CUDA graphs (``solver/graph.py``, one body
pass per replay) and on the host-driven loop:

- flagship: the cold solve and two warm MPC steps, then windows of 10 warm
  steps;
- rocket and grasp, each in the plain step and in the straggler-compacted
  step of its shipped schedule (``bench/conic.py: SCHEDULES``): the cold
  solve of the long problem, the batched initial solve
  and one warm-up step, then windows of 3 (rocket) or 5 (grasp) warm steps;
- flexsat, in the plain step and in the compacted step of its shipped
  schedule (``bench/families.py: FLEXSAT_SCHEDULE``): the cold solve and
  one warm-up step, then windows of 5 regulator steps;
- quadruped, in both friction modes: one warm-up solve, then windows of 2
  cold batch solves, each with a fresh x0 draw.

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
KINDS = (("kernel B (fused_expand_backward)", ("fused_expand_backward",)),
         ("kernel C (ls_rollout_al)", ("ls_rollout_al",)),
         ("kernel A (ls_rollout)", ("ls_rollout",)),
         ("kernel D (riccati)", ("riccati_kernel",)),
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


def conic_window(family: str, compact: bool, B: int = ROCKET_B,
                 device="cuda", graphed=None):
    """Windows of the rocket's or grasp's MPC steps, plain or in the
    family's shipped compaction schedule; the window function carries the
    step as ``window.step``."""
    import numpy as np

    from altro_tpu_torch.bench import conic

    setup = conic.SETUPS[family](torch.float32, device=device,
                                 graphed=graphed)
    steps = {"rocket": ROCKET_STEPS, "grasp": GRASP_STEPS}[family]
    sched = conic.SCHEDULES[family] if compact else (0, 256, ())
    step, init_carry = conic.make_step(setup, *sched, graphed=graphed)
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
                     device="cuda", graphed=None):
    from altro_tpu_torch.bench.families import quadruped_setup

    su = quadruped_setup(B, linearized_friction, torch.float32, device)
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
    "quadruped": (("quadruped qp", QUAD_B, f"{QUAD_SOLVES} cold solves",
                   QUAD_SOLVES, lambda g: quadruped_window(True, graphed=g)),
                  ("quadruped socp", QUAD_B, f"{QUAD_SOLVES} cold solves",
                   QUAD_SOLVES,
                   lambda g: quadruped_window(False, graphed=g))),
}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("paths", nargs="*", help=f"of {list(PATHS)} (default: "
                    "all)")
    ap.add_argument("--forms", default="graphed,eager",
                    help="comma-separated forms: graphed, eager")
    args = ap.parse_args()
    names = args.paths or list(PATHS)
    forms = args.forms.split(",")
    unknown = ([n for n in names if n not in PATHS]
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
                results.append(res)
    print(json.dumps({"card": card, "paths": results}))


if __name__ == "__main__":
    main()
