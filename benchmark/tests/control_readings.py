"""Readings that set a cell's limits: for each seed, one short window of the
cell at its own size, then the compared numbers of the program's recorded
answers and of the TF32 control's answers to the same lane-steps (the
reference put in the program's place, every product's operands rounded to
TF32). One JSON line per seed; all seeds in one process.

    python3 benchmark/tests/control_readings.py <workload> <seconds> <seed>...

Run on a machine with the card; the benchmark's own runs do not run it.
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main() -> None:
    import torch

    from benchmark import check, harness

    name, seconds = sys.argv[1], float(sys.argv[2])
    seeds = [int(s) for s in sys.argv[3:]]
    wl = harness.workload(name)
    device = torch.device("cuda", 0)
    for seed in seeds:
        res, cell = harness.run_cell(
            wl, seed, seconds, False, device=device,
            t_start=time.perf_counter(),
            out_dir=os.path.join(harness.OUT_ROOT, name, "readings"))
        _, program = check.judge(cell, res.samples, res.start, device)
        answers = check.control_answers(cell, res.samples, res.start,
                                        device)
        _, control = check.judge(cell, res.samples, res.start, device,
                                 answers=answers)
        print(json.dumps({"workload": name, "seed": seed,
                          "steps": res.steps,
                          "failed": res.steps * res.lanes - res.successes,
                          "program": program, "control": control}),
              flush=True)
        del cell, res
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
