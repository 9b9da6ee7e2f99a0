"""The benchmark of altro_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

Sets the cell up (its inputs, the program's kernels from the build cache
inside the checkout, the initial carry, one warm-up step that captures the
step's CUDA graphs), steps it for ``--seconds`` (``harness.run_cell``),
checks the recorded answers against the plain reference (``check.py``) and
prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` and, traced,
``breakdown``; then ``check``, every compared number beside its limit, which
the last lines of standard error repeat.

It exits with another code than 0, and prints no result, without CUDA or
with fewer cards than the cell asks for, and when JAX or the JAX package
was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton_cache")):
    os.environ.setdefault(_var, os.path.join(ROOT, "build", _sub))
os.environ.setdefault("USE_FLAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "altro_tpu")


def forbidden_modules(modules=None) -> list:
    """Top-level names of ``modules`` (default: sys.modules) that the run
    must not load, compared whole (``altro_tpu_torch`` is not
    ``altro_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def out_dir(args) -> str:
    from benchmark.harness import OUT_ROOT
    return os.path.join(OUT_ROOT, args.workload,
                        f"seed{args.seed}_trace{args.trace}")


def execute(args, device_type: str = "cuda", wl=None):
    """Run the cell and return (result dict, stderr lines of the check).
    ``device_type`` "cpu" runs it on the CPU and ``wl`` replaces the cell's
    entry (the tests' rehearsal: the kernels' plain versions, small
    traffic, planted faults)."""
    import torch
    from benchmark import harness

    wl = wl or harness.workload(args.workload)
    if wl.chips != 1:
        raise SystemExit(f"{wl.name}: the harness runs a cell on one card, "
                         f"not {wl.chips}")
    device = torch.device("cuda", 0) if device_type == "cuda" else "cpu"
    res, cell = harness.run_cell(
        wl, args.seed, args.seconds, bool(args.trace), device=device,
        t_start=T_START, out_dir=out_dir(args))
    return assemble(wl, args, res, cell, device, device_type)


def profiler_cost(step_s, traced_steps) -> dict:
    """The traced steps' median seconds beside the other steps' (ms), and
    how many were traced: what the profiler adds to a step."""
    import numpy as np

    traced = np.zeros(step_s.shape[0], dtype=bool)
    traced[traced_steps] = True
    if not traced.any() or traced.all():
        return {}
    return {"traced_steps": int(traced.sum()),
            "step_ms_median_traced": float(np.median(step_s[traced]) * 1e3),
            "step_ms_median_untraced": float(
                np.median(step_s[~traced]) * 1e3)}


def assemble(wl, args, res, cell, device, device_type):
    """The result line's object and the check's stderr lines."""
    import numpy as np
    import torch
    from benchmark import check

    per_sample, numbers = check.judge(cell, res.samples, res.start, device)
    os.makedirs(out_dir(args), exist_ok=True)
    torch.save({"samples": res.samples, "start": res.start,
                "judged": per_sample, "step_s": res.step_s},
               os.path.join(out_dir(args), "check.pt"))
    attempted = res.steps * res.lanes
    failed = attempted - res.successes
    numbers["fail_share"] = failed / max(attempted, 1)
    limits = dict(wl.limits)
    limits["fail_share"] = 1.0 - cell.success_rate_min
    correct, rows = check.verdict(numbers, limits)
    gpu = device_type == "cuda"
    dev = {"platform": "gpu" if gpu else "cpu",
           "kind": torch.cuda.get_device_name(0) if gpu else "cpu",
           "count": 1, "memory_peak_bytes": res.memory_peak_bytes}
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed)}
    diag = {k: v for k, v in numbers.items() if k not in limits}
    diag["host"] = res.host
    if args.trace:
        from benchmark import metrics
        out["metrics"] = metrics.read_all(wl, res)
        if res.trace is not None:
            from benchmark import trace as trace_mod
            dev["busy_s"] = float(res.trace.busy_s())
            dev["window_s"] = float(res.trace.window_s)
            out["breakdown"] = trace_mod.breakdown(res.trace)
        diag.update(profiler_cost(res.step_s, res.traced_steps))
        if res.spans is not None:
            from benchmark.metrics import _spans
            diag["spans_kept"] = len(res.spans["records"])
            diag["steps_with_spans"] = len(res.spans["window"])
            passes = _spans.passes_check(res)
            if passes is not None:
                # the same window steps' passes by the spans and the counter
                diag["loop_span_passes"], diag["pass_counter_passes"] = passes
    else:
        e2e = {"solves_per_s": res.successes / res.window_s,
               "step_ms_p95": np.percentile(res.step_s * 1e3, 95),
               "setup_s": res.setup_s}
        out["metrics"] = {m["name"]: {"value": float(e2e[m["name"]]),
                                      "unit": m["unit"]}
                          for m in wl.end_to_end}
    out["device"] = dev
    out["check"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    lines = [f"diagnostics {json.dumps(diag)}",
             f"metrics {json.dumps(out['metrics'])}",
             f"window steps {res.steps} in {res.window_s:.6f} s, "
             f"setup {res.setup_s:.6f} s"]
    lines += [f"check {k} {v!r} limit {lim!r}" for k, v, lim in rows]
    return out, lines


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    from benchmark import harness

    wl = harness.workload(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < wl.chips:
        print(f"{wl.name} needs {wl.chips} cards, this host has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    # the host loop drives the card: no pool of intra-op threads beside it
    torch.set_num_threads(2)
    out, lines = execute(args)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: nothing the benchmark runs may load "
              f"JAX or the JAX package", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
