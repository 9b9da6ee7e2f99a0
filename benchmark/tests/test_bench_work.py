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


# the grouped quadruped trot: G=8 gait groups, n = m = 12, N=15, four SOC
# blocks of 3 rows and 8 NONPOS rows, the L=11 ladder, the L=1 init
GROUPED = {"kernel_a": (15, 12, 12, 1, False),
           "kernel_b": (15, 12, 12, 20, (3, 3, 3, 3)),
           "kernel_c": (15, 12, 12, 20, 11)}


@pytest.mark.parametrize("kind,stack", [
    ("kernel_a", 14 * (144 + 144 + 12)),       # A, B and dd of 14 knots
    ("kernel_b", 14 * (144 + 144)),            # A and B
    ("kernel_c", 14 * (144 + 144 + 12)),
])
def test_groups_count_each_groups_stack(kind, stack):
    """With groups=8 a launch reads the dynamics stack of each of the 8
    groups: 7 stacks more than a shared one, and no more FLOPs."""
    work = _work.WORK[kind]
    one = work(1024, *GROUPED[kind], 4)
    eight = work(1024, *GROUPED[kind], 4, groups=8)
    assert eight[0] - one[0] == 7 * stack * 4
    assert eight[1] == one[1]


def test_keyword_work_arguments_reach_the_work_function():
    args, kwargs = _roofline.work_arguments(GROUPED["kernel_b"] + (
        {"groups": 8},))
    assert (args, kwargs) == (GROUPED["kernel_b"], {"groups": 8})
    assert _roofline.work_arguments((21, 6, 3, 1, False)) == (
        (21, 6, 3, 1, False), {})
    # kernel C at the trot's shapes is bound by its bytes, so the groups'
    # stacks move its bound
    bound, by = _work.bound_ms(*_work.rollout_al_work(
        1024, *GROUPED["kernel_c"], 4, groups=8), 4)
    assert by == "bytes"
    run = _Run([DeviceOp("ls_rollout_al_kernel<float, 11>", "kernel", 0.0,
                         bound * 1e3, (128, 11, 8))])
    run.kernels = {"kernel_c": GROUPED["kernel_c"] + ({"groups": 8},)}
    assert _roofline.share(run, "kernel_c") == pytest.approx(100.0)
    run.kernels = {"kernel_c": GROUPED["kernel_c"]}
    assert _roofline.share(run, "kernel_c") < 99.9


def test_rocket_shares_read_as_before():
    """The rocket's entries (positional arguments only) read what the call
    ``work(lanes, *entry, itemsize)`` gave, on a trace with every level's
    launches of kernels A, B and C."""
    kernels = {"kernel_b": (21, 6, 3, 15, (4, 4, 7)),
               "kernel_c": (21, 6, 3, 15, 6),
               "kernel_a": (21, 6, 3, 1, False)}
    names = {"kernel_a": "ls_rollout_kernel<float, 1>",
             "kernel_b": "fused_expand_backward_kernel<float>",
             "kernel_c": "ls_rollout_al_kernel<float, 6>"}
    ops = [DeviceOp(names[kind], "kernel", 0.0, dur, grid)
           for kind, grid, dur in (
               ("kernel_b", (512, 1, 1), 152.0), ("kernel_b", (128, 1, 1),
                                                  61.0),
               ("kernel_b", (64, 1, 1), 47.0), ("kernel_c", (64, 6, 1), 66.0),
               ("kernel_c", (16, 6, 1), 21.0), ("kernel_a", (8, 1, 1), 9.0))]
    run = _Run(ops)
    run.kernels = kernels
    for kind, entry in kernels.items():
        launches = [o for o in ops if _kinds.kind_of(o.name) == kind]
        full = max(o.grid[0] * o.grid[1] for o in launches)
        bound = sum(_work.bound_ms(*_work.WORK[kind](
            max(1, round(1024 * o.grid[0] * o.grid[1] / full)), *entry, 4),
            4)[0] for o in launches)
        want = 100.0 * bound / sum(o.dur * 1e-3 for o in launches)
        assert _roofline.share(run, kind) == want
