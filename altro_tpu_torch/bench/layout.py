"""Where the time of kernel D's boundary goes (the counterpart of the TPU
probe ``tools/exp_layout.py``).

    python -m altro_tpu_torch.bench.layout

``ops/riccati.py: batched_riccati`` checks its arguments and expands the
shared Hessian stacks to the batch (``_prepare``: a copy of lxx here,
[N, n, n] to [B, N, n, n]), then launches the kernel (``_launch``). Each
piece is timed at the flagship shapes (B=1024, N=30, n=12, m=6, float32),
on the probe's inputs (:func:`inputs`), as a chain of REPEATS dependent
calls captured in one CUDA graph (:func:`chain`), so that the time per call
is the device's, with no host work between the calls. Rows, each beside
the probe's row it answers:

- the chain's own step (an add over lx and a mean), which every row below
  holds once per call: a row's net time is its time less this one;
- v0, ``batched_riccati`` whole (the probe's full boundary);
- the preparation alone, ``_prepare`` (the probe's layout transforms);
- the kernel alone on prepared inputs, ``_launch`` (the probe's
  ``raw_call``, the bare ``pallas_call``);
- the lxx copy alone (the probe's lxx pair and moveaxis).

Two rows of the probe have nothing to time in the port and print ``none``
with the reason: the outputs' moveaxis (the kernel writes K and d
batch-major, as the solver reads them) and the A/B broadcast (the kernel
reads shared A/B, once per block, with no per-lane copy). Prints the rows
with the card's name and power limit; the last line is the result as JSON.
"""
from __future__ import annotations

import json
import time

import numpy as np
import torch

B, N, n, m = 1024, 30, 12, 6
REPEATS = 200
SAMPLES = 5
NONE = {
    "v_kernel_out": "none: the kernel writes K and d batch-major, as the "
                    "solver reads them; there is no output moveaxis",
    "layout_ab": "none: the kernel reads shared A/B, once per block; there "
                 "is no per-lane broadcast of A/B",
}


def inputs(B: int = B, N: int = N, n: int = n, m: int = m,
           dtype=torch.float32, device="cuda", seed: int = 0) -> tuple:
    """``batched_riccati``'s arguments drawn as the probe draws them (its
    order and scales, ``tools/exp_layout.py:48-62``): shared A [N-1, n, n]
    and B [N-1, n, m] (0.3 N(0, 1)), lx, lu per lane, lxx the shared
    diagonal stack [N, n, n] (the wrapper copies it to the batch), luu the
    diagonal plus 0.01 N(0, 1) and lux 0.01 N(0, 1) per lane, reg zero.
    luu's draw is symmetrized: a Hessian is symmetric, and the kernels (the
    TPU's and the card's alike) read one triangle of it where the plain
    recursion reads both."""
    rng = np.random.default_rng(seed)
    A1 = rng.standard_normal((N - 1, n, n)) * 0.3
    B1 = rng.standard_normal((N - 1, n, m)) * 0.3
    lx = rng.standard_normal((B, N, n))
    lu = rng.standard_normal((B, N, m))
    lxxd = np.abs(rng.standard_normal((n,))) + 1.0
    luud = np.abs(rng.standard_normal((m,))) + 1.0
    lxx = np.broadcast_to(np.diag(lxxd), (N, n, n))
    E = rng.standard_normal((B, N, m, m)) * 0.01
    luu = np.diag(luud) + 0.5 * (E + np.swapaxes(E, -1, -2))
    lux = rng.standard_normal((B, N, m, n)) * 0.01
    reg = np.zeros(B)
    return tuple(torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                 device=device)
                 for a in (A1, B1, lx, lu, lxx, luu, lux, reg))


def chain(fn, repeats: int = REPEATS, samples: int = SAMPLES,
          graphed=None, dtype=torch.float32, device="cuda") -> tuple:
    """``repeats`` dependent calls, eps = 1e-12 fn(eps) from eps = 0 (the
    counterpart of the probe's ``lax.scan`` chain): captured in one CUDA
    graph (``graphed``, None: on a CUDA device; ``solver/graph.py:
    Replayable``, which also adds a replay's launches to the kernels'
    counters), or run as they are. Returns (the median over ``samples``
    runs of the chain's time divided by ``repeats``, in ms: CUDA events on
    a CUDA device, the host clock elsewhere; the last call's value)."""
    from ..solver import graph

    device = torch.device(device)
    eps0 = torch.zeros((), dtype=dtype, device=device)

    def body():
        eps, out = eps0, None
        for _ in range(repeats):
            out = fn(eps)
            eps = 1e-12 * out
        return out

    if graph.use_graphs(graphed, device):
        rep = graph.Replayable(body, device)

        def run():
            rep.replay()
            return rep.out
    else:
        run = torch.no_grad()(body)
    out = run()
    times = []
    for _ in range(samples):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = run()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / repeats)
        else:
            t0 = time.perf_counter()
            out = run()
            times.append((time.perf_counter() - t0) * 1e3 / repeats)
    return float(np.median(times)), float(out)


def rows(args, repeats: int = REPEATS, samples: int = SAMPLES,
         graphed=None) -> dict:
    """{row: (ms per call, the chain's last value)} on ``args``
    (:func:`inputs`), in the order of the module's docstring."""
    from ..ops import riccati

    A1, B1, lx, lu, lxx, luu, lux, reg = args
    prep = riccati._prepare(*args)
    Bt = lx.shape[0]

    def step(eps):
        return (lx + eps).mean()

    def whole(eps):
        return riccati.batched_riccati(A1, B1, lx + eps, lu, lxx, luu, lux,
                                       reg)[1].mean()

    def prepare(eps):
        return riccati._prepare(A1, B1, lx + eps, lu, lxx, luu, lux,
                                reg)[2].mean()

    def kernel(eps):
        return riccati._launch(prep[0], prep[1], lx + eps,
                               *prep[3:])[1].mean()

    def lxx_copy(eps):
        lxx.expand((Bt,) + tuple(lxx.shape)).contiguous()
        return step(eps)

    kw = dict(repeats=repeats, samples=samples, graphed=graphed,
              dtype=lx.dtype, device=lx.device)
    return {name: chain(fn, **kw) for name, fn in (
        ("step", step), ("v0", whole), ("prepare", prepare),
        ("kernel", kernel), ("lxx_copy", lxx_copy))}


LABELS = {
    "step": ("the chain's step alone (add over lx, mean)", "-"),
    "v0": ("v0 batched_riccati whole", "v0 full boundary"),
    "prepare": ("_prepare alone (checks, lxx copy)",
                "v_layout transforms alone"),
    "kernel": ("_launch alone on prepared inputs",
               "v_kernel pallas_call alone"),
    "lxx_copy": ("lxx copy alone", "layout: lxx pair+moveaxis only"),
}


def run(device="cuda") -> dict:
    """The rows at the flagship shapes, printed with the card's name and
    power limit; float32 products at full precision."""
    from .flagship import power_limit

    card = power_limit()
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        res = rows(inputs(device=device))
    finally:
        torch.set_float32_matmul_precision(saved)
    step_ms = res["step"][0]
    for name, (ms, _) in res.items():
        label, ref = LABELS[name]
        print(f"layout {label:44s} {ms:8.4f} ms"
              + ("" if name == "step" else f" (net {ms - step_ms:.4f})")
              + f"  [probe: {ref}] [{card}]", flush=True)
    for name, why in NONE.items():
        print(f"layout {name:44s} {why}", flush=True)
    return {"card": card, "device": torch.cuda.get_device_name(0),
            "shape": dict(B=B, N=N, n=n, m=m, dtype="float32",
                          repeats=REPEATS, samples=SAMPLES),
            "ms": {name: ms for name, (ms, _) in res.items()},
            "none": NONE}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("the layout probe measures a CUDA device; none is "
                         "available")
    print(json.dumps(run()))


if __name__ == "__main__":
    main()
