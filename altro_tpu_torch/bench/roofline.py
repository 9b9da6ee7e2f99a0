"""The card's multiply-add issue ceiling and the four solver kernels rated
against it (the counterpart of the TPU probe ``tools/exp_r5_roofline.py``).

    python -m altro_tpu_torch.bench.roofline

Four parts:

1. calibration (:func:`calibrate`): the hand-written kernel
   ``csrc/calibrate.cu`` (``ops/calibrate.py``) issues nothing but
   independent fused multiply-adds, in float32 and in float64, at the
   reference's defaults (a grid of 4096 steps of [8, 128] lanes, 16
   accumulators, 512 rounds); its rate is the ceiling the card reaches in
   the kernels' launch regime, beside the data sheet's peak
   (``bench/kernels.py: PEAK_FLOPS``). :func:`sass_fma` reads the compiled
   loop with ``cuobjdump -sass`` and counts the FMAs a thread runs;
2. static counts: the reference's per-knot multiply-add counts of the four
   kernels (:func:`macs_riccati` and the others, unchanged in meaning), and
   beside them the port's own FLOP counts (``bench/kernels.py: *_work``);
3. measurement (:func:`measure_flagship`): kernels D (shared A/B), A, C
   (the one NONPOS block) and B at the flagship shapes (B=1024, n=12, m=6,
   N=30, float32, the ladder (1, 0.5, 0)), on ``bench/kernels.py``'s inputs
   and timing, each row with its achieved rate against the calibrated
   ceiling (the reference's fields) and its bound and share of it (the
   port's);
4. the flagship's useful FLOP rate, from the port's own measured solves/s
   and mean iterations (``bench/flagship.py: run_flagship``), and the
   bytes a lane-knot of kernel B streams against the card's memory rate.

Prints the rows with the card's name and power limit and writes the result
as JSON to ``build/roofline.json`` and, as the last line, to stdout.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from . import kernels as kb

OUT = Path(__file__).resolve().parents[2] / "build" / "roofline.json"
SAMPLES = 5


# ---------------------------------------------------------------------------
# 1. calibration
# ---------------------------------------------------------------------------

def calibrate(dtype=torch.float32, grid: int = 4096, inner: int = 512,
              streams: int = 16, rows: int = 8, device="cuda") -> dict:
    """The FMA kernel's rate: ``streams`` independent accumulators of
    ``inner`` chained multiply-adds on each of the grid's [rows, 128]
    lanes (a = x = ones, read from device memory); the median of SAMPLES
    timings (``bench/kernels.py: time_ms``, the kernel's device time)."""
    from ..ops.calibrate import calibrate_fma

    a = torch.ones((rows, 128), dtype=dtype, device=device)
    ms = float(np.median([
        kb.time_ms(lambda: calibrate_fma(a, a, grid, inner, streams),
                   kernel=True) for _ in range(SAMPLES)]))
    wall_s = ms / 1e3
    macs = grid * inner * streams * a.numel()
    item = a.element_size()
    nbytes, flops = calibrate_work(grid, inner, streams, a.numel(), item)
    bnd, by = kb.bound_ms(nbytes, flops, item)
    return dict(dtype=str(dtype).split(".")[-1], grid=grid, inner=inner,
                streams=streams, rows=rows, wall_s=wall_s, ms=ms, macs=macs,
                macs_per_s=macs / wall_s, flops_per_s=2 * macs / wall_s,
                peak_flops_per_s=kb.PEAK_FLOPS[item],
                share_of_peak=2 * macs / wall_s / kb.PEAK_FLOPS[item],
                bound_ms=bnd, bound_by=by)


def calibrate_work(grid: int, inner: int, streams: int, lanes: int,
                   itemsize: int) -> tuple:
    """(bytes, FLOPs) of the calibration kernel: a and x read, out written;
    per work item (grid x lanes) the accumulators' first products, two
    FLOPs per multiply-add and the sum's additions."""
    flops = grid * lanes * (2 * inner * streams + streams + streams - 1)
    return 3 * lanes * itemsize, flops


def _cuobjdump() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("cuobjdump"),
                 os.path.join(cuda_home, "bin", "cuobjdump")):
        if cand and os.path.exists(cand):
            return cand
    return ""


def parse_sass(text: str) -> dict:
    """{function name: [(address, opcode, text), ...]} of ``cuobjdump
    -sass`` output (predicates stripped from the text)."""
    funcs, cur = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if head:
            cur = funcs.setdefault(head.group(1), [])
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.+?)\s*;", line)
        if cur is not None and ins:
            body = re.sub(r"^@!?U?P[T\d]+\s+", "", ins.group(2).strip())
            cur.append((int(ins.group(1), 16), body.split()[0].split(".")[0],
                        body))
    return funcs


def fma_loops(instructions, opcode: str) -> dict:
    """The FMAs of one function: (FMAs, instructions) of each innermost loop
    that holds any (a backward branch and its target), most FMAs first, and
    the FMAs outside them."""
    at = {addr: i for i, (addr, _, _) in enumerate(instructions)}
    loops = []
    for j, (addr, op, body) in enumerate(instructions):
        target = re.search(r"\b0x([0-9a-f]+)\b", body) if op == "BRA" else None
        if target and at.get(int(target.group(1), 16), j + 1) <= j:
            loops.append((at[int(target.group(1), 16)], j))
    inner = [(i, j) for i, j in loops
             if not any((i, j) != (k, l) and i <= k and l <= j
                        for k, l in loops)]
    counts = sorted(((sum(op == opcode for _, op, _ in instructions[i:j + 1]),
                      j - i + 1) for i, j in inner), reverse=True)
    counts = [c for c in counts if c[0]]
    total = sum(op == opcode for _, op, _ in instructions)
    return dict(loops=counts, outside=total - sum(c for c, _ in counts),
                total=total)


def sass_fma(inner: int = 512, streams: int = 16):
    """The calibration kernel's compiled loops, from ``cuobjdump -sass`` of
    the built object (:func:`sass_counts`); None where the toolkit has no
    cuobjdump."""
    from ..ops import _build

    tool = _cuobjdump()
    if not tool:
        return None
    _build.library()
    obj = _build.build_dir() / "calibrate.o"
    proc = subprocess.run([tool, "-sass", str(obj)], capture_output=True,
                          text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {proc.stderr}")
    return sass_counts(proc.stdout, inner, streams)


def sass_counts(text: str, inner: int, streams: int) -> dict:
    """Per dtype (float32: FFMA, float64: DFMA), in the SASS listing
    ``text`` of the calibration kernel with ``streams`` accumulators: the
    FMAs of the unrolled loop (the innermost loop with the most), its
    instructions and its rounds; the loops of one round each (the remainder
    loop, once in each version of the grid-stride loop the compiler makes);
    the FMAs outside these loops; and the FMAs one work item of ``inner``
    rounds runs, with ``streams`` x ``inner`` beside it. Raises where an
    FMA loop is neither."""
    funcs = parse_sass(text)
    out = {}
    for dtype, tag, opcode in (("float32", "f", "FFMA"),
                               ("float64", "d", "DFMA")):
        name = next((f for f in funcs
                     if "calibrate_fma" in f and f"I{tag}Li{streams}E" in f),
                    None)
        if name is None:
            raise RuntimeError(f"no calibrate_fma<{dtype}, {streams}> in "
                               "the listing")
        found = fma_loops(funcs[name], opcode)
        (main, main_ins), *rest = found["loops"] or [(0, 0)]
        if main % streams or any(c != streams for c, _ in rest) or not rest:
            raise RuntimeError(f"calibrate_fma<{dtype}, {streams}>: expected "
                               f"an unrolled loop and loops of one round, "
                               f"found {found['loops']}")
        unroll = main // streams
        out[dtype] = dict(
            function=name, opcode=opcode, fma_main_loop=main,
            main_loop_instructions=main_ins, unroll=unroll,
            one_round_loops=len(rest), fma_outside_loops=found["outside"],
            fma_per_item=((inner // unroll) * main
                          + (inner % unroll) * streams + found["outside"]),
            expected=streams * inner)
    return out


# ---------------------------------------------------------------------------
# 2. the reference's static per-knot multiply-add counts (one MAC = one
#    multiply(-accumulate) per lane; tools/exp_r5_roofline.py:93-151)
# ---------------------------------------------------------------------------

def macs_riccati(n, m):
    """Kernel D's body per knot per lane."""
    c = 0
    c += n * n * n          # VA = Vxx @ A
    c += n * n * m          # VB = Vxx @ B
    c += n * n * n + n * n  # Qxx = lxx + A' VA
    c += m * n * m + m * m  # Quu = luu + B' VB
    c += m * n * n + m * n  # Qux = lux + B' VA
    c += n * n + m * n      # Qx, Qu
    c += m ** 3 // 3 + 3 * m * m          # lane-wise Cholesky (+div/sqrt)
    c += (n + 1) * m * m * 2              # chol_solve for K cols + d
    c += m * m + 2 * m                    # Quud, dV accumulators
    c += n * 2 * m + n * m                # Vx update
    c += m * n * m                        # QuuK
    c += (n * (n + 1) // 2) * 3 * m       # Vxx upper triangle
    return c


def macs_rollout(n, m, L):
    """Kernel A's body per knot per lane (ladder of L rungs)."""
    per_rung = 0
    per_rung += n                    # dx
    per_rung += m * (1 + n)          # u = ub + alpha d + K dx
    per_rung += n * (n + m)          # x+ = A x + B u (+dd add)
    return L * per_rung


def macs_rollout_al(n, m, L, blocks):
    """Kernel C's body per knot per lane: rollout + stage cost + AL
    penalty. ``blocks`` = [(p, cone_str), ...]."""
    per_rung = macs_rollout(n, m, 1)
    per_rung += n * (n + 1) + 1      # 0.5 x'Qx + q'x (+c)
    per_rung += m * (m + n + 1)      # 0.5 u'Ru + r'u + u'Hx
    for p, cone in blocks:
        per_rung += p * (n + m + 2)  # residual rows + lam + rho*c
        if cone == "soc":
            per_rung += 3 * p + 12   # a2, proj cases, ssq
        else:
            per_rung += 2 * p        # ct^2 accumulate
        per_rung += 2                # mask/2rho scale + J add
    return L * per_rung


def macs_fused_expansion(n, m, blocks):
    """Kernel B's expansion per knot per lane on top of the backward
    recursion (which matches macs_riccati minus its lxx/luu/lux adds)."""
    c = 0
    c += n * (n + 1)                 # lx = q + Q x; lxx broadcast rows
    c += m * (m + n + 1)             # lu, luu, lux seeds
    for p, cone in blocks:
        c += p * (n + m + 2)         # residuals
        # add_gw: lx/lxx rows + lu/luu/lux rows per constraint row
        c += p * (n + n * (n + 1) // 2)
        c += p * (m + m * (m + 1) // 2 + m * n)
        if cone == "soc":
            c += 2 * (p * (n + m) + n * (n + 1) // 2
                      + m * (m + 1) // 2 + m * n + n + m)  # rank-2 terms
    return c


# ---------------------------------------------------------------------------
# 3. the kernels at the flagship shapes
# ---------------------------------------------------------------------------

def measure_flagship(B: int = 1024, device="cuda") -> tuple:
    """Kernels D, A, C and B through their wrappers at the flagship shapes
    (``bench/kernels.py: flagship_inputs``, float32): per kernel the
    median of SAMPLES device timings, the reference's MAC count per knot
    and knots, and the port's bytes and FLOPs. Returns (rows, config)."""
    from ..ops import riccati, riccati_fused, rollout, rollout_al

    fl = kb.flagship_inputs(torch.float32, torch.device(device), B)
    blocks = fl["fused"][3]
    X = fl["fused"][4]
    N, n, m = X.shape[1], X.shape[2], fl["fused"][5].shape[2]
    meta = [(int(c.p), str(c.cone)) for c in blocks]
    L = len(kb.FLAG_LADDER)
    cases = {
        "riccati": (lambda: riccati.batched_riccati(*fl["riccati"]),
                    macs_riccati(n, m), fl["riccati_work"]),
        "rollout": (lambda: rollout.batched_ls_rollout(*fl["ladder"]),
                    macs_rollout(n, m, L), fl["ladder_work"]),
        "rollout_al": (lambda: rollout_al.batched_ls_rollout_al(
            *fl["ladder_al"], packed=fl["packed"]),
            macs_rollout_al(n, m, L, meta), fl["ladder_al_work"]),
        "riccati_fused": (lambda: riccati_fused.fused_expand_backward(
            *fl["fused"], packed=fl["packed"]),
            macs_riccati(n, m) + macs_fused_expansion(n, m, meta),
            fl["fused_work"])}
    rows = {}
    for name, (fn, macs_knot, (nbytes, flops)) in cases.items():
        ms = float(np.median([kb.time_ms(fn, kernel=True)
                              for _ in range(SAMPLES)]))
        bnd, by = kb.bound_ms(nbytes, flops, 4)
        rows[name] = dict(wall_s=ms / 1e3, macs_per_knot=macs_knot,
                          knots=N - 1, macs_reference=macs_knot * (N - 1) * B,
                          flops_port=flops, bytes_port=nbytes, bound_ms=bnd,
                          bound_by=by, share_of_bound=bnd / ms)
    return rows, dict(B=B, n=n, m=m, N=N, L=L, blocks=meta, dtype="float32")


# ---------------------------------------------------------------------------
# 4. the whole
# ---------------------------------------------------------------------------

def run(B: int = 1024, T: int = 20, device="cuda", out=OUT) -> dict:
    """Every part, printed row by row with the card's name and power
    limit; the result as a dict, also written to ``out`` as JSON."""
    from .flagship import power_limit, run_flagship

    card = power_limit()
    res = {"card": card, "device": torch.cuda.get_device_name(0)}
    cal = {}
    for dtype in (torch.float32, torch.float64):
        c = calibrate(dtype, device=device)
        cal[c["dtype"]] = c
        print(f"calibration {c['dtype']}: {c['ms']:.4f} ms, "
              f"{c['macs_per_s'] / 1e12:.3f} T MAC/s, "
              f"{c['flops_per_s'] / 1e12:.3f} TFLOP/s, "
              f"{c['share_of_peak']:.2%} of the data sheet's "
              f"{c['peak_flops_per_s'] / 1e12:.0f} [{card}]", flush=True)
    res["calibration"] = cal
    res["sass"] = sass_fma()
    for dtype, s in (res["sass"] or {"(no cuobjdump)": None}).items():
        print(f"sass {dtype}: " + ("not measured" if s is None else
              f"{s['opcode']} {s['fma_main_loop']} of "
              f"{s['main_loop_instructions']} instructions in the loop of "
              f"{s['unroll']} rounds, {s['one_round_loops']} loops of one "
              f"round, {s['fma_outside_loops']} outside; "
              f"{s['fma_per_item']} per work item at inner=512 "
              f"(streams x inner = {s['expected']})"), flush=True)

    rows, cfg = measure_flagship(B, device)
    res["config"] = cfg
    ceiling = cal["float32"]["macs_per_s"]
    for name, r in rows.items():
        r["achieved_macs_per_s"] = r["macs_reference"] / r["wall_s"]
        r["utilization_vs_ceiling"] = round(
            r["achieved_macs_per_s"] / ceiling, 4)
        r["us_per_knot_per_block"] = round(
            r["wall_s"] / r["knots"] * 1e6 / max(B // 1024, 1), 3)
        r["achieved_flops_per_s_port"] = r["flops_port"] / r["wall_s"]
        print(f"{name}: {r['wall_s'] * 1e3:.4f} ms; reference count "
              f"{r['macs_reference'] / 1e9:.4f} G MAC, "
              f"{r['achieved_macs_per_s'] / 1e12:.3f} T MAC/s, "
              f"{r['utilization_vs_ceiling']:.2%} of the calibrated ceiling; "
              f"port count {r['flops_port'] / 1e9:.4f} GFLOP, "
              f"{r['bytes_port'] / 1e6:.2f} MB, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), {r['share_of_bound']:.2%} of it [{card}]",
              flush=True)
    res["kernels"] = rows

    # the flagship's useful work per solve, the reference's proxy: mean
    # iterations x (kernel B's + kernel C's counts) per knot (the flagship's
    # ladder is kernel A's, whose count is smaller: an upper estimate)
    flag = run_flagship(B=B, T=T, device=device)
    useful = flag["mean_iters"] * (rows["riccati_fused"]["macs_per_knot"]
                                   + rows["rollout_al"]["macs_per_knot"]) * (
        cfg["N"] - 1)
    sps = flag["solves_per_s"]
    res["flagship_mfu"] = dict(
        solves_per_s_measured=sps, mean_iters_measured=flag["mean_iters"],
        B=B, T=T, useful_macs_per_solve=useful,
        useful_flops_per_s=2 * useful * sps,
        vs_fma_ceiling=round(useful * sps / ceiling, 4),
        vs_peak=round(2 * useful * sps / kb.PEAK_FLOPS[4], 4))
    f = res["flagship_mfu"]
    print(f"flagship: {sps:.1f} solves/s, {f['mean_iters_measured']:.3f} mean "
          f"iterations, {f['useful_flops_per_s'] / 1e12:.4f} useful TFLOP/s, "
          f"{f['vs_fma_ceiling']:.2%} of the calibrated ceiling [{card}]",
          flush=True)

    # the bytes a lane-knot of kernel B streams (the reference's formula)
    n, m = cfg["n"], cfg["m"]
    ptot = sum(p for p, _ in cfg["blocks"])
    lane_bytes = 4 * (2 * n + m + 2 * ptot + 3 + m * n + m + 2)
    res["hbm"] = dict(
        fused_lane_bytes_per_knot=lane_bytes,
        hbm_bytes_per_s=kb.HBM_BYTES_PER_S,
        note="shared problem data (cost, dynamics, constraint rows) is "
             "staged in shared memory, read from device memory once per "
             "knot per block",
        hbm_bound_us_per_knot_per_1024lanes=round(
            lane_bytes * 1024 / kb.HBM_BYTES_PER_S * 1e6, 4))
    print(f"hbm: {lane_bytes} bytes a lane-knot, "
          f"{res['hbm']['hbm_bound_us_per_knot_per_1024lanes']} us a knot "
          f"of 1024 lanes at {kb.HBM_BYTES_PER_S / 1e12:.2f} TB/s [{card}]",
          flush=True)
    if out is not None:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(res, indent=1))
    return res


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("the roofline probe measures a CUDA device; none is "
                         "available")
    torch.set_float32_matmul_precision("highest")
    print(json.dumps(run()))


if __name__ == "__main__":
    main()
