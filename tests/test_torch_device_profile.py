"""The device profile's windows (``altro_tpu_torch/bench/device_profile.py``)
on the CPU at a small batch: each path's window runs warm work through the
solver and counts its solver-loop passes, and device kernels are sorted
into the kinds the profile reports. The profile itself needs a CUDA device."""
import pytest

torch = pytest.importorskip("torch")

from altro_tpu_torch.bench import device_profile as dp  # noqa: E402

torch.set_num_threads(1)


def test_flagship_window_counts_iterations():
    window = dp.flagship_window(B=4, device="cpu")
    first, second = window(), window()
    assert first >= dp.FLAG_STEPS and second >= dp.FLAG_STEPS


def test_flagship_lanes_window_counts_iterations():
    """The flagship with a window index per lane: every step runs at least
    one solver-loop pass; kernel B's wrapper is never called (the split
    route)."""
    from altro_tpu_torch.ops import riccati_fused
    b0 = riccati_fused.launch_count
    window = dp.flagship_lanes_window(B=5, device="cpu")
    assert window() >= dp.FLAG_STEPS
    assert riccati_fused.launch_count == b0


@pytest.mark.parametrize("linearized", [True, False], ids=["qp", "socp"])
def test_quadruped_window_counts_iterations(linearized):
    window = dp.quadruped_window(linearized, B=8, device="cpu")
    assert window() >= dp.QUAD_SOLVES


def test_quadruped_grouped_window_counts_iterations():
    """The grouped layout's window (the profile's quadruped_grouped path)
    at B=8 on the CPU: every solve runs at least one pass."""
    window = dp.quadruped_window(False, B=8, device="cpu", grouped=True)
    assert window() >= dp.QUAD_SOLVES
    assert [p[0] for p in dp.PATHS["quadruped_grouped"]] == [
        "quadruped grouped qp", "quadruped grouped socp"]


@pytest.mark.parametrize("compact", [False, True], ids=["plain", "compacted"])
def test_grasp_window_counts_passes(compact):
    """Grasp's window on the CPU at B=8, plain and in its shipped schedule
    (the blocks of 256 and 128 clamp to the batch): every step runs at
    least one solver-loop pass."""
    window = dp.conic_window("grasp", compact, B=8, device="cpu")
    assert window() >= dp.GRASP_STEPS


def test_grasp_split_window_counts_passes():
    """Grasp's plain window with the fused expansion off (the split
    route's profile path) at B=8 on the CPU."""
    window = dp.conic_window("grasp", False, B=8, device="cpu", split=True)
    assert window() >= dp.GRASP_STEPS


@pytest.mark.parametrize("name,kind", [
    ("void (anonymous namespace)::riccati_kernel<float, 64, 12>(float "
     "const*)", "kernel D (riccati)"),
    ("void (anonymous namespace)::ls_rollout_al_kernel<float, 16, 1>(float "
     "const*)", "kernel C (ls_rollout_al)"),
    ("void (anonymous namespace)::ls_rollout_kernel<float, 16>(float const*)",
     "kernel A (ls_rollout)"),
    ("void (anonymous namespace)::fused_expand_backward_kernel<float, 64, 6>",
     "kernel B (fused_expand_backward)"),
    # the wide bodies; "riccati" holds "cat", and the name of every kernel
    # of riccati_fused.cu holds "riccati"
    ("void (anonymous namespace)::riccati_wide<float, 128>(float const*, "
     "float const*, int)", "kernel D (riccati)"),
    ("void (anonymous namespace)::ls_rollout_al_wide<double>(double const*)",
     "kernel C (ls_rollout_al)"),
    ("void (anonymous namespace)::ls_rollout_wide<float>(float const*)",
     "kernel A (ls_rollout)"),
    ("_ZN49_GLOBAL__N__834bcba2_16_riccati_fused_cu_91d4de6126fused_expand_"
     "backward_wideIdLi512EEEvPKT_", "kernel B (fused_expand_backward)"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "AddFunctor<float>>", "elementwise"),
    ("Memset (Device)", "other"),
])
def test_kernel_names_sort_into_kinds(name, kind):
    assert dp.kind_of(name) == kind


def test_graphed_grasp_window_counts_passes():
    """Grasp's compacted window on the fixed-buffer route (the graphed form
    on the CPU, B=8): the step keeps its loop graphs per level batch, and
    every step runs at least one pass per loop entry."""
    window = dp.conic_window("grasp", True, B=8, device="cpu", graphed=True)
    assert window() >= 5 * dp.GRASP_STEPS
    (g,) = window.step.sets.values()
    assert [loop.state[0].shape[0] for loop in g.levels.loops] == [8, 8, 8]


@pytest.mark.parametrize("compact", [False, True], ids=["plain", "compacted"])
def test_flexsat_window_counts_passes(compact):
    """Flexsat's window on the CPU at B=8, plain and in its shipped
    schedule (the blocks clamp to the batch): every regulator step runs at
    least one solver-loop pass."""
    window = dp.flexsat_window(compact, B=8, device="cpu")
    assert window() >= dp.FLEX_STEPS


def test_naive_rocket_cold_window_and_pieces():
    """A window of cold solves of the naive rocket (two landings at a
    21-knot horizon on the CPU, as the naive rocket's window makes them at
    N=301) counts its passes; the sections of one pass run in order on a
    mid-solve iterate and take the split route's pieces: no fused
    kernel."""
    import dataclasses

    from altro_tpu_torch.bench.conic import COLD_OPTS
    from altro_tpu_torch.models import rocket
    from altro_tpu_torch.ops import riccati_fused, rollout_al
    from altro_tpu_torch.solver.options import SolverOptions
    counts = riccati_fused.launch_count, rollout_al.launch_count
    prob = rocket.rocket_problem(N=21, tf=1.0, conic=False,
                                 dtype=torch.float32)
    prob = dataclasses.replace(prob, x0=prob.x0.expand(2, 6).contiguous())
    U0 = rocket.hover_controls(prob).expand(2, -1, -1).contiguous()
    window = dp._cold_window(prob, SolverOptions(**COLD_OPTS), U0, None,
                             dp.NAIVE_SOLVES, "cpu", None)
    assert window() >= 1
    pieces = window.pieces()
    assert tuple(pieces) == dp.PASS_SECTIONS
    for fn in pieces.values():
        fn()
    assert (riccati_fused.launch_count, rollout_al.launch_count) == counts


def test_srb_nonlinear_window_counts_passes():
    window = dp.srb_nonlinear_window(B=8, device="cpu")
    assert window(1) >= 1
    for fn in window.pieces().values():
        fn()
