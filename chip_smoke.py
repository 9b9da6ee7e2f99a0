"""Smoke run of the PyTorch/CUDA port (``altro_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its findings; any failure raises (non-zero exit):

1. device: a CUDA device is required; prints its name and nvidia-smi's
   name and power limit;
2. build: compiles the kernels from ``altro_tpu_torch/csrc`` with nvcc and
   prints the build time and ptxas resource use;
3. kernel parity at the flagship shapes (B=1024, n=12, m=6, N=30; ladders
   L=3 and L=1): each CUDA kernel against its plain PyTorch version on the
   card, in float32 (gate: max|kernel - plain| <= 1e-3 max(1, max|plain|))
   and in float64 (gate: 1e-9 max(1, max|plain|)), with both timed;
4. main path: the flagship MPC benchmark (B=1024, T=20, float32) through
   the kernels, with the launch counters reset just before and read just
   after; success, violation and counter gates;
5. agreement: the same 64 lanes for 10 steps with the float32 kernel path
   on the card and the float64 plain path on the CPU (gate: equal status,
   max|U32 - U64| <= 1e-3).

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import re
import time

import numpy as np
import torch

FLAG_B, FLAG_T = 1024, 20
AGREE_B, AGREE_T = 64, 10
F32_TOL, F64_TOL, AGREE_TOL = 1e-3, 1e-9, 1e-3


def time_ms(fn, reps: int = 20) -> float:
    """Median device time of ``fn`` over ``reps`` calls, after a warm-up,
    from CUDA events."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def errors(got, ref, names, tol: float) -> dict:
    """{output name: max|got - ref|}; raises if any exceeds
    tol * max(1, max|ref|)."""
    errs = {}
    for name, g, r in zip(names, got, ref):
        err = float((g.double() - r.double()).abs().max())
        bound = tol * max(1.0, float(r.double().abs().max()))
        if not err <= bound:
            raise AssertionError(f"{name}: max|kernel - plain| = {err:.3e} > "
                                 f"{bound:.3e}")
        errs[name] = err
    return errs


def parity(dtype, tol):
    """Kernel vs plain version at the flagship shapes; returns
    {kernel: ({output: max_abs_err}, ms, plain_ms)}."""
    from altro_tpu_torch.bench.flagship import flagship_setup
    from altro_tpu_torch.ops import riccati_fused, rollout

    dev = torch.device("cuda")
    setup = flagship_setup(FLAG_B, 1, dtype=dtype, device=dev)
    prob = setup.prob_mpc
    (con,) = prob.constraints
    dyn = prob.dynamics
    N, n, m, p = prob.N, prob.n, prob.m, con.p
    rng = np.random.default_rng(7)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    X = t(rng.standard_normal((FLAG_B, N, n)))
    # |u| > 3 on about a third of the entries: active and inactive bound rows
    U = t(3.0 * rng.standard_normal((FLAG_B, N - 1, m)))
    lam = t(np.abs(rng.standard_normal((FLAG_B, N, p))))
    rho = torch.full((FLAG_B, N), 1e3, dtype=dtype, device=dev)
    reg = t(np.where(rng.random(FLAG_B) < 0.5, 0.0, 1e-2))
    args = (prob.cost, dyn.A, dyn.B, prob.constraints, X, U, (lam,), (rho,),
            reg)
    fb = riccati_fused.fused_expand_backward
    fb_ref = riccati_fused.fused_expand_backward_reference
    out = fb(*args)
    ref = fb_ref(*args)
    torch.cuda.synchronize()
    res = {"fused_expand_backward": (
        errors(out, ref, ("K", "d", "dV1", "dV2"), tol),
        time_ms(lambda: fb(*args)), time_ms(lambda: fb_ref(*args)))}

    K, dff = ref[0].contiguous(), ref[1].contiguous()
    ladder = (1.0, 0.5, 0.0)
    ls = rollout.batched_ls_rollout
    ls_ref = rollout.batched_ls_rollout_reference
    largs = (dyn.A, dyn.B, dyn.d, X, U, K, dff, ladder)
    errs = errors(ls(*largs), ls_ref(*largs), ("Xs L=3", "Us L=3"), tol)
    # the cold-start form: L=1, alpha=1, K=d=0
    cargs = (dyn.A, dyn.B, dyn.d, X, U, torch.zeros_like(K),
             torch.zeros_like(dff), (1.0,))
    errs.update(errors(ls(*cargs), ls_ref(*cargs), ("Xs L=1", "Us L=1"), tol))
    res["batched_ls_rollout"] = (errs, time_ms(lambda: ls(*largs)),
                                 time_ms(lambda: ls_ref(*largs)))
    return res


def main() -> None:
    # ---- 1. device
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is available")
    from altro_tpu_torch.bench.flagship import (flagship_setup, power_limit,
                                                run_flagship, run_steps)
    from altro_tpu_torch.convert import tree_to
    from altro_tpu_torch.ops import _build, riccati_fused, rollout

    kind = torch.cuda.get_device_name(0)
    card = power_limit()
    print(f"device: {kind} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s))")
    print(card)

    # ---- 2. build
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s ({_build.build_dir()})")
    for line in _build.build_log().splitlines():
        if re.search(r"Compiling entry|Used \d+ registers|spill", line):
            print("  ptxas:", line.split("ptxas info    :")[-1].strip())

    # ---- 3. kernel parity at the flagship shapes
    par32 = parity(torch.float32, F32_TOL)
    par64 = parity(torch.float64, F64_TOL)
    for name in par32:
        for label, (errs, ms, plain_ms) in (("f32", par32[name]),
                                            ("f64", par64[name])):
            errs_s = " ".join(f"{k}={v:.3e}" for k, v in errs.items())
            print(f"parity {name} {label}: max|kernel - plain| {errs_s}; "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms [{card}]")

    # ---- 4. main path
    rollout.launch_count = 0
    riccati_fused.launch_count = 0
    res = run_flagship(B=FLAG_B, T=FLAG_T, device="cuda")
    launches = {"batched_ls_rollout": rollout.launch_count,
                "fused_expand_backward": riccati_fused.launch_count}
    print(f"main path [{card}]: solves/s={res['solves_per_s']:.1f} "
          f"step_ms p50={res['step_ms_p50']:.3f} p99={res['step_ms_p99']:.3f} "
          f"mean_iters={res['mean_iters']:.3f} success_rate="
          f"{res['success_rate']:.4f} max_viol={res['max_viol']:.3e} "
          f"walls_s={['%.4f' % w for w in res['wall_s']]} "
          f"loop_iterations={res['loop_iterations']} launches={launches}")
    if res["success_rate"] != 1.0 or not res["max_viol"] <= 1e-4:
        raise AssertionError(f"flagship quality: {res}")
    iters = res["loop_iterations"]
    if not (iters > 0 and launches["fused_expand_backward"] == iters
            and launches["batched_ls_rollout"] == iters + res["cold_solves"]):
        raise AssertionError(f"launch counts {launches} do not match "
                             f"{iters} solver-loop iterations")

    # ---- 5. agreement: f32 kernel path on the card vs f64 plain on the CPU
    s64 = flagship_setup(AGREE_B, AGREE_T, dtype=torch.float64, device="cpu")
    s32 = tree_to(s64, "cuda", torch.float32)
    out32 = run_steps(s32, AGREE_B, AGREE_T)
    out64 = run_steps(s64, AGREE_B, AGREE_T)
    for t, (a, b) in enumerate(zip(out32, out64)):
        if not torch.equal(a.status.cpu(), b.status):
            raise AssertionError(f"step {t}: status differs")
    dU = torch.stack([(a.U.cpu().double() - b.U).abs() for a, b in
                      zip(out32, out64)]).flatten()
    q99 = float(torch.quantile(dU[::max(1, dU.numel() // 100000)], 0.99))
    print(f"agreement {AGREE_B} lanes x {AGREE_T} steps, f32 kernels vs f64 "
          f"plain: max|dU|={float(dU.max()):.3e} mean={float(dU.mean()):.3e} "
          f"p99={q99:.3e}")
    if not float(dU.max()) <= AGREE_TOL:
        raise AssertionError(f"f32-vs-f64 control gap {float(dU.max()):.3e}")

    sources = {
        "batched_ls_rollout": ("altro_tpu_torch/csrc/ls_rollout.cu",
                               "altro_tpu/ops/rollout.py:89"),
        "fused_expand_backward": ("altro_tpu_torch/csrc/riccati_fused.cu",
                                  "altro_tpu/ops/riccati_fused.py:301"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         "max_abs_err": max(par32[name][0].values()),
         "ms": par32[name][1], "plain_ms": par32[name][2]}
        for name, (src, rep) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
