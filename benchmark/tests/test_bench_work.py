"""The yardstick frozen in benchmark/metrics: the kernels' bytes and FLOPs at
the flagship's and the rocket's shapes pinned to hand counts, the kernel
classes of the trace's names, and the roofline share read from a synthetic
trace (a launch that takes exactly its bound reads 100%; a compaction
level's smaller grid counts its share of the lanes)."""
from __future__ import annotations

import pytest

from benchmark.metrics import _kinds, _roofline, _work
from benchmark.trace import DeviceOp, Trace


def test_kernel_a_flagship_by_hand():
    # L=3 rungs, N=30, n=12, m=6, shared A/B/d, float32, 1024 lanes
    B, N, n, m, L = 1024, 30, 12, 6, 3
    dyn = (N - 1) * (n * n + n * m + n)                 # 6,612
    xbar = B * N * n                                    # 368,640
    ubar_K_d = B * (N - 1) * (2 * m + m * n)            # 2,494,464
    outs = B * L * (N * n + (N - 1) * m)                # 1,640,448
    nbytes = 4 * (dyn + xbar + ubar_K_d + outs)
    flops = B * L * (N - 1) * (n + 2 * m * n + 2 * m + 2 * n * n
                               + 2 * n * m + n)
    assert (nbytes, flops) == (18_040_656, 54_521_856)
    assert _work.rollout_work(B, N, n, m, L, False, 4) == (nbytes, flops)


@pytest.mark.parametrize("fn,args,want", [
    # flagship: one NONPOS block of 12 rows
    (_work.fused_work, (1024, 30, 12, 6, 12, (), 4),
     (13_148_520, 688_988_160)),
    (_work.riccati_work, (1024, 30, 12, 6, False, 4),
     (42_480_096, 440_451_072)),
    # rocket: SOC blocks of 4, 4 and 7 rows, the L=6 ladder, the L=1 init
    (_work.fused_work, (1024, 21, 6, 3, 15, (4, 4, 7), 4),
     (3_895_032, 125_475_840)),
    (_work.rollout_al_work, (1024, 21, 6, 3, 15, 6, 4),
     (8_478_936, 88_805_376)),
    (_work.rollout_work, (1024, 21, 6, 3, 1, False, 4),
     (3_248_832, 3_317_760)),
])
def test_work_counts_pinned(fn, args, want):
    assert fn(*args) == want


def test_bound_picks_the_slower_side():
    ms, by = _work.bound_ms(13_148_520, 688_988_160, 4)
    assert by == "operations"
    assert ms == pytest.approx(688_988_160 / 67e12 * 1e3)
    ms, by = _work.bound_ms(42_480_096, 440_451_072, 4)
    assert by == "bytes"
    assert ms == pytest.approx(42_480_096 / 3.35e12 * 1e3)


@pytest.mark.parametrize("name,kind", [
    ("void fused_expand_backward_kernel<float, 64, 6>(float const*)",
     "kernel_b"),
    ("void ls_rollout_al_kernel<float, 6>(...)", "kernel_c"),
    ("void ls_rollout_kernel<float, 1>(...)", "kernel_a"),
    ("void riccati_kernel<float, 64, 6>(...)", "kernel_d"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "elementwise"),
    ("void at::native::reduce_kernel<512, 1, ...>", "reduction"),
    ("Memcpy DtoD (Device -> Device)", "other"),
    ("void at::native::index_elementwise_kernel<...>", "elementwise"),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_nn_n", "gemm/gemv"),
    ("void something_else()", "other"),
])
def test_kinds(name, kind):
    assert _kinds.kind_of(name) == kind


class _Run:
    def __init__(self, ops, lanes=1024):
        self.trace = Trace(t0=0.0, t1=1e6, ops=ops, host=[], passes=1,
                           steps=1)
        self.kernels = {"kernel_b": (21, 6, 3, 15, (4, 4, 7))}
        self.lanes, self.itemsize = lanes, 4


def _op(grid, dur_us):
    return DeviceOp("fused_expand_backward_kernel<float>", "kernel", 0.0,
                    dur_us, grid)


def test_roofline_share_is_the_bound_over_the_time():
    bound = _work.bound_ms(*_work.fused_work(1024, 21, 6, 3, 15, (4, 4, 7),
                                             4), 4)[0]
    full = _Run([_op((512, 1, 1), bound * 1e3)])
    assert _roofline.share(full, "kernel_b") == pytest.approx(100.0)
    # a level at a quarter of the grid runs 256 lanes: its bound is that
    # of 256 lanes
    b256 = _work.bound_ms(*_work.fused_work(256, 21, 6, 3, 15, (4, 4, 7),
                                            4), 4)[0]
    two = _Run([_op((512, 1, 1), bound * 1e3), _op((128, 1, 1), 2e3)])
    want = 100.0 * (bound + b256) / (bound + 2.0)
    assert _roofline.share(two, "kernel_b") == pytest.approx(want)


def test_roofline_reads_nothing_without_launches_or_grids():
    assert _roofline.share(_Run([]), "kernel_b") is None
    assert _roofline.share(_Run([_op(None, 5.0)]), "kernel_b") is None
