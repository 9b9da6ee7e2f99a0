"""FMA-issue calibration: the CUDA kernel ``csrc/calibrate.cu`` and its
plain PyTorch version.

The counterpart of the TPU probe ``tools/exp_r5_roofline.py:
calibrate_macs``: for every grid step and every lane of ``a`` and ``x``,
``streams`` independent accumulators acc_i = a (1 + i) run ``inner``
rounds of acc_i = acc_i * 0.999999 + x (one fused multiply-add each in the
kernel), and their sum, taken in order, is written out. It measures the
rate at which the card issues the multiply-adds that the solver's kernels
are made of (``bench/roofline.py``).

Dispatch: the kernel measures a card, so a tensor anywhere but on a CUDA
device raises; the plain version, :func:`calibrate_fma_reference`, is
called by name (the tests, ``chip_smoke.py``).
"""
from __future__ import annotations

import torch

from . import _build

# Kernel launches since the last reset (see ops/rollout.py).
launch_count = 0

# the accumulator counts the kernel is compiled for (csrc/calibrate.cu)
STREAMS = (1, 2, 4, 8, 16, 32)
COEF = 0.999999


def calibrate_fma_reference(a, x, grid: int, inner: int, streams: int):
    """Plain PyTorch version of :func:`calibrate_fma`: the same recurrence
    with each multiply-add as a multiply and an add (rounded twice); the
    streams stacked on a leading axis. Every grid step computes the same
    value, so ``grid`` is checked and not repeated."""
    _check(a, x, grid, inner, streams)
    c = torch.tensor(COEF, dtype=a.dtype, device=a.device)
    scale = torch.arange(1, streams + 1, dtype=a.dtype, device=a.device)
    acc = a[None] * scale.view((streams,) + (1,) * a.dim())
    for _ in range(inner):
        acc = acc * c + x
    out = acc[0]
    for i in range(1, streams):
        out = out + acc[i]
    return out


def calibrate_fma(a, x, grid: int = 4096, inner: int = 512,
                  streams: int = 16):
    """The kernel: out (like ``a``) from ``grid`` x ``a.numel()`` work items
    of ``streams`` accumulators and ``inner`` rounds each; a and x
    contiguous, float32 or float64, of one shape, on one CUDA device."""
    global launch_count
    _check(a, x, grid, inner, streams)
    if a.device.type != "cuda":
        raise ValueError(f"calibrate_fma measures a CUDA device; got a "
                         f"tensor on {a.device} (its plain version is "
                         "calibrate_fma_reference)")
    if not (a.is_contiguous() and x.is_contiguous()):
        raise ValueError("calibrate_fma takes contiguous a and x")
    out = torch.empty_like(a)
    lib = _build.library()
    fn = (lib.altro_calibrate_fma_f32 if a.dtype == torch.float32
          else lib.altro_calibrate_fma_f64)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(a.data_ptr(), x.data_ptr(), out.data_ptr(), grid, a.numel(),
             inner, streams, stream)
    _build.check(err, "altro_calibrate_fma")
    launch_count += 1
    return out


def _check(a, x, grid: int, inner: int, streams: int) -> None:
    if a.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"calibrate_fma takes float32 or float64; got "
                         f"{a.dtype}")
    if x.dtype != a.dtype or x.shape != a.shape or x.device != a.device:
        raise ValueError(f"x must match a: {tuple(x.shape)} {x.dtype} on "
                         f"{x.device} against {tuple(a.shape)} {a.dtype} on "
                         f"{a.device}")
    if a.numel() < 1 or a.numel() >= 2 ** 31:
        raise ValueError(f"calibrate_fma takes 1 to 2**31 - 1 lanes; got "
                         f"{a.numel()}")
    if not 1 <= grid < 2 ** 31 or not 0 <= inner < 2 ** 31:
        raise ValueError(f"grid must be >= 1 and inner >= 0; got grid="
                         f"{grid}, inner={inner}")
    if streams not in STREAMS:
        raise ValueError(f"streams must be one of {STREAMS}; got {streams}")
