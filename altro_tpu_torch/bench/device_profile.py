"""Where the flagship's device time goes: one torch.profiler window over warm
MPC steps on one card.

    python -m altro_tpu_torch.bench.device_profile

Builds the flagship setup (B=1024, float32), runs the cold solve and two
warm steps, then STEPS warm steps unprofiled and STEPS more under the
profiler (CPU and CUDA activities). Prints, per solver-loop iteration (the
batch loop's passes: each step's lane-max iteration count), the device time
and launches of each hand-written kernel and of the rest of the device work
by kind, and the device busy share: the profiled window's device time per
iteration (one stream, so kernels do not overlap) over the unprofiled
window's wall clock per iteration. The profiler's own host overhead
stretches the profiled window's wall, which is printed beside it but is not
the denominator. The last line is the result as JSON.
"""
from __future__ import annotations

import dataclasses
import json
import time

import torch

from altro_tpu_torch.bench.kernels import FLAG_B

STEPS = 10
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


def profile_flagship() -> dict:
    from altro_tpu_torch.bench.flagship import flagship_setup
    from altro_tpu_torch.mpc import make_mpc_step
    from altro_tpu_torch.solver.altro import solve

    B = FLAG_B
    setup = flagship_setup(B, 2 * STEPS + 2, dtype=torch.float32,
                           device="cuda")
    pm = setup.prob_mpc
    step, _ = make_mpc_step(pm, setup.opts, setup.X_track, setup.U_track)
    x0 = pm.x0.expand(B, pm.n).contiguous()
    sol = solve(dataclasses.replace(pm, x0=x0), setup.opts)
    carry = (x0, sol.X, sol.U, sol.duals)
    for t in range(2):
        carry, _ = step(carry, setup.noise[t], t)
    torch.cuda.synchronize()

    def window(first):
        """STEPS warm steps from step ``first``: (wall ms, iterations)."""
        nonlocal carry
        iters = []
        t0 = time.perf_counter()
        for t in range(first, first + STEPS):
            carry, out = step(carry, setup.noise[t], t)
            iters.append(out.iters.max())
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, int(sum(iters))

    wall_ms, iters_plain = window(2)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        prof_wall_ms, iters = window(2 + STEPS)
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
    return {"B": B, "steps": STEPS, "loop_iterations": iters,
            "device_ms": device_ms, "profiled_wall_ms": prof_wall_ms,
            "unprofiled_wall_ms": wall_ms,
            "unprofiled_loop_iterations": iters_plain,
            "busy_share": (device_ms / iters) / (wall_ms / iters_plain),
            "per_iteration": {k: {"ms": ms / iters, "launches": n / iters}
                              for k, (ms, n) in sorted(per_kind.items())}}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("the profile measures a CUDA device; none is "
                         "available")
    from altro_tpu_torch.bench.flagship import power_limit
    res = profile_flagship()
    card = power_limit()
    print(f"flagship B={res['B']} f32 [{card}]: unprofiled {res['steps']} "
          f"warm steps = {res['unprofiled_loop_iterations']} solver "
          f"iterations in {res['unprofiled_wall_ms']:.3f} ms; profiled "
          f"{res['steps']} = {res['loop_iterations']} iterations in "
          f"{res['profiled_wall_ms']:.3f} ms with {res['device_ms']:.3f} ms "
          f"of device time; busy {100 * res['busy_share']:.1f}% (device ms "
          f"per iteration over unprofiled wall ms per iteration)")
    for kind, v in res["per_iteration"].items():
        print(f"  per iteration: {kind}: {v['ms']:.4f} ms device, "
              f"{v['launches']:.1f} launches")
    res["card"] = card
    print(json.dumps(res))


if __name__ == "__main__":
    main()
