"""The loop's two forms on the card, each run a process of its own, in turns:
the host-driven loop (``--eager``) and CUDA graphs at each k of
``--ks`` body passes per replay.

    python -m altro_tpu_torch.bench.forms [flagship] [rocket] [grasp]
                                          [quadruped] [--ks 1,2,4,8]

For every path (all four when none is named) it runs the path's bench
driver (``bench/flagship.py``; ``bench/conic.py`` for the rocket and grasp,
in their shipped compaction schedules; ``bench/families.py`` for the
quadruped, both friction modes) once per form in the order eager, each k,
each k in reverse, eager, so that a drift of the host shows as a spread
between a form's two runs. Each run prints its result as one JSON line
(``path``, ``form``, and the driver's whole result); the last line holds,
per path and form, the step ms p50 of both runs (the quadruped: round ms
p50), and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

# path: (driver's arguments, key of its step latency p50)
DRIVERS = {
    "flagship": (["-m", "altro_tpu_torch.bench.flagship"], "step_ms_p50"),
    "rocket": (["-m", "altro_tpu_torch.bench.conic", "rocket"],
               "step_ms_p50"),
    "grasp": (["-m", "altro_tpu_torch.bench.conic", "grasp"],
              "step_ms_p50"),
    "quadruped": (["-m", "altro_tpu_torch.bench.families"],
                  "round_ms_p50"),
}


def results_of(output: str) -> list:
    """The JSON results a driver printed: a line that is a JSON object
    with more than the four keys of the metric line, or one that starts
    with '# <card>' and ends with such an object."""
    out = []
    for line in output.splitlines():
        start = line.find("{")
        if start < 0:
            continue
        try:
            res = json.loads(line[start:])
        except json.JSONDecodeError:
            continue
        if isinstance(res, dict) and "metric" not in res:
            out.append(res)
    return out


def run(path: str, form: str, timeout: float = 900.0) -> list:
    args, _ = DRIVERS[path]
    extra = ["--eager"] if form == "eager" else ["--check-every", form[2:]]
    proc = subprocess.run([sys.executable, *args, *extra],
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{path} [{form}] failed:\n{proc.stderr[-4000:]}")
    return results_of(proc.stdout + "\n" + proc.stderr)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("paths", nargs="*", help=f"of {list(DRIVERS)}")
    ap.add_argument("--ks", default="1,2,4,8",
                    help="comma-separated body passes per replay")
    args = ap.parse_args()
    paths = args.paths or list(DRIVERS)
    unknown = [p for p in paths if p not in DRIVERS]
    if unknown:
        ap.error(f"unknown path {unknown}; choose from {list(DRIVERS)}")
    from altro_tpu_torch.bench.flagship import power_limit
    card = power_limit()
    ks = [f"k={k}" for k in args.ks.split(",")]
    order = ["eager"] + ks + ks[::-1] + ["eager"]
    summary = {}
    for path in paths:
        key = DRIVERS[path][1]
        for form in order:
            for res in run(path, form):
                label = res.get("label", path)
                print(json.dumps({"path": label, "form": form, **res}),
                      flush=True)
                summary.setdefault(label, {}).setdefault(form, []).append(
                    res[key])
    print(json.dumps({"card": card, "step_ms_p50": summary}))


if __name__ == "__main__":
    main()
